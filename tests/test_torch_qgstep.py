"""The fused vorticity step of qgcm_torch against qgcm_tpu in float64.

On CPU tensors ops.qgstep runs its plain PyTorch version
(qgstep_reference); it is held here to the JAX package's op chain
(_qgostep with allow_pallas=False) and to the Pallas kernel in interpret
mode, at the bar the Pallas kernel meets (tests/test_pallas_qg.py):
max|dq| <= 1e-12 max|q|, with qom bit-exact. The CUDA kernel itself is
checked on the card (chip_smoke.py); here its launch geometry and its
parameter block are checked against the kernel source, and the window
modes' autograd rule (_Window) against autograd through their plain
version."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from qgcm_tpu.models.ocean import _qgostep as jax_qgostep
from qgcm_torch.grids import build_grids
from qgcm_torch.model import _sponge_ramp, build_model
from qgcm_torch.models.ocean import _qgostep, qgstep_consts
from qgcm_torch.ops import qgstep as qgstep_mod
from qgcm_torch.ops.qgstep import (HALO, MAX_STRIP_H, MIN_STRIP_H,
                                   STRIP_W, TILE_H, TILE_W, launch_geometry,
                                   qgstep, qgstep_reference, window_geometry,
                                   window_reference)

from test_torch_cases import cfg_pair, jax_case, rel_err, to_port

TOL = 1e-12

# box, cyclic, cyclic+sponge (nlo=2 makes layer 1 the bottom layer
# too), and the multi-tile 145^2 box
CASES = [("pallas", dict(nlo=3)), ("pallas", dict(nlo=3, cyclic=True)),
         ("pallas", dict(nlo=3, cyclic=True, sponge=True)),
         ("pallas", dict(nlo=2, cyclic=True, sponge=True)),
         ("tall", dict())]


def _port_args(cfg_t, st_t, f_t, entoc):
    r_spl = (torch.from_numpy(_sponge_ramp(cfg_t))
             if cfg_t.sponge.enabled else None)
    return (st_t.pom, st_t.po, st_t.qo, st_t.qom, f_t.wekpo,
            torch.tensor(np.asarray(entoc)), r_spl,
            qgstep_consts(cfg_t, build_grids(cfg_t)), cfg_t.ocean.ah2oc,
            cfg_t.ocean.ah4oc)


@pytest.mark.parametrize("kind,kw", CASES,
                         ids=[f"{k}-{v}" for k, v in CASES])
def test_qgstep_matches_jax_chain(kind, kw):
    cfg_j, cfg_t = cfg_pair(kind, **kw)
    jm, st, f, entoc = jax_case(cfg_j)
    q_ref, qm_ref, _ = jax.jit(lambda s, e: jax_qgostep(
        jm, s, f, e, allow_pallas=False))(st, entoc)
    st_t, f_t = to_port(st, f)
    args = _port_args(cfg_t, st_t, f_t, entoc)

    n0 = qgstep.launches
    got = qgstep(*args, cyclic=cfg_t.cyclic_ocean,
                 sponge=cfg_t.sponge.enabled)
    assert qgstep.launches == n0, "CPU tensors must not launch the kernel"
    assert rel_err(got, q_ref) <= TOL
    assert torch.equal(got, qgstep_reference(
        *args, cyclic=cfg_t.cyclic_ocean, sponge=cfg_t.sponge.enabled))
    if not cfg_t.cyclic_ocean:
        # through the port's step: qom_new is the old qo, bit for bit
        q_new, qm_new = _qgostep(build_model(cfg_t, "cpu"), st_t, f_t,
                                 args[5])
        assert torch.equal(q_new, got)
        assert np.array_equal(qm_new.numpy(), np.asarray(qm_ref))


def test_qgstep_matches_pallas_interpret():
    cfg_j, cfg_t = cfg_pair("pallas", nlo=3)
    jm, st, f, entoc = jax_case(cfg_j)
    jm_p = jm.__class__(**{**jm.__dict__,
                           "cfg": jm.cfg.replace(use_pallas=True)})
    q_pl, qm_pl, _ = jax_qgostep(jm_p, st, f, entoc)
    st_t, f_t = to_port(st, f)
    q_new, qm_new = _qgostep(build_model(cfg_t, "cpu"), st_t, f_t,
                             torch.tensor(np.asarray(entoc)))
    assert rel_err(q_new, q_pl) <= TOL
    assert np.array_equal(qm_new.numpy(), np.asarray(qm_pl))


def _small_args(dtype=torch.float64):
    nl, ny, nx = 2, 9, 11
    g = torch.Generator().manual_seed(0)
    fields = [torch.randn(nl, ny, nx, generator=g, dtype=dtype)
              for _ in range(4)]
    planes = [torch.randn(ny, nx, generator=g, dtype=dtype)
              for _ in range(3)]
    return [*fields, *planes, tuple(float(i + 1) for i in range(11)),
            (1.0, 2.0), (3.0, 4.0)]


@pytest.mark.parametrize("breakage", [
    "pom_2d", "po_shape", "int_dtype", "mixed_dtype", "noncontig",
    "no_rspl", "ah_len", "consts_len"])
def test_qgstep_refuses_bad_arguments(breakage):
    args = _small_args()
    sponge = False
    if breakage == "pom_2d":
        args[0] = args[0][0]
    elif breakage == "po_shape":
        args[1] = args[1][:, :-1]
    elif breakage == "int_dtype":
        args = [a.to(torch.int64) if torch.is_tensor(a) else a
                for a in args]
    elif breakage == "mixed_dtype":
        args[3] = args[3].float()
    elif breakage == "noncontig":
        args[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    elif breakage == "no_rspl":
        args[6], sponge = None, True
    elif breakage == "ah_len":
        args[8] = (1.0,)
    elif breakage == "consts_len":
        args[7] = args[7][:-1]
    with pytest.raises((ValueError, TypeError)):
        qgstep(*args, cyclic=False, sponge=sponge)


def test_qgstep_refuses_other_devices():
    args = [a.to("meta") if torch.is_tensor(a) else a
            for a in _small_args()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        qgstep(*args, cyclic=False, sponge=False)


KERNEL_SRC = (Path(qgstep_mod.__file__).resolve().parents[1] / "csrc"
              / "qgstep.cu").read_text()

# tiny grids; heights at and beside the bounds of the strip height;
# widths at and beside one strip; the port's test grids; the main path
# (961^2) and NAtl 1 km (4801^2)
GEOMETRY_CASES = (
    [(2, 3, 3), (2, 5, 7), (3, 9, 9), (8, 4, 6), (2, 9, 3)]
    + [(3, ny, nx) for ny in (MIN_STRIP_H - 1, MIN_STRIP_H, MIN_STRIP_H + 1)
       for nx in (STRIP_W - 1, STRIP_W, STRIP_W + 1)]
    + [(2, ny, 4801) for ny in (MAX_STRIP_H - 1, MAX_STRIP_H,
                                MAX_STRIP_H + 1)]
    + [(3, 73, 145), (3, 145, 145), (3, 961, 961), (3, 4801, 4801),
       (2, 4801, STRIP_W + 1), (8, 1023, 2 * STRIP_W - 1)])
# blocks an H100 SXM holds at once: 132 SMs times 4 (float64) or 8
# (float32) blocks of the kernel
RESIDENT = (528, 1056)


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("nl,ny,nx", GEOMETRY_CASES,
                         ids=[f"{a}x{b}x{c}" for a, b, c in GEOMETRY_CASES])
def test_launch_geometry_tiles_every_point_once(nl, ny, nx, resident):
    """Block (bx, by, k) owns layer k, rows [by*h, min(by*h + h, ny)) and
    columns [bx*w, min(bx*w + w, nx)) (csrc/qgstep.cu): every (k, row,
    col) belongs to exactly one block, no block starts past the grid, the
    strip counts are the ones the kernel's launch accepts, and the launch
    stays within one wave of resident blocks unless the height is at its
    upper bound."""
    g = launch_geometry(nl, ny, nx, resident)
    assert not g.tiled
    if g.strip_h > MIN_STRIP_H:
        assert (nl * g.strips_x * g.strips_y <= resident
                or g.strip_h == MAX_STRIP_H)
    _assert_tiles_once(g, nl, ny, nx)


def _assert_tiles_once(g, nl, ny, nx):
    """The counts are those the kernel's launch accepts for the design
    (csrc/qgstep.cu::launch), no block starts past the output, and every
    (k, row, col) of it belongs to exactly one block (bx, by, k): a
    strip of the march, or a tile of the window design."""
    if g.tiled:
        assert (g.strip_w, g.strip_h) == (TILE_W, TILE_H)
    else:
        assert g.strip_w == STRIP_W
        assert MIN_STRIP_H <= g.strip_h <= MAX_STRIP_H
    assert g.strips_x == -(-nx // g.strip_w)
    assert g.strips_y == -(-ny // g.strip_h) <= 65535
    owned = np.zeros((nl, ny, nx), np.uint8)
    for k in range(nl):
        for by in range(g.strips_y):
            r0 = by * g.strip_h
            assert r0 < ny
            for bx in range(g.strips_x):
                c0 = bx * g.strip_w
                assert c0 < nx
                owned[k, r0:min(r0 + g.strip_h, ny),
                      c0:min(c0 + g.strip_w, nx)] += 1
    assert (owned == 1).all()


# Window outputs (nl, rows, cols): phase 12's rank window of the 961^2 box
# on 4 ranks, its 3-row bands, NAtl 1 km's rank window and a 2x2 split's
# x_ext block; the test grids' windows (tests/_torch_ranks.small_cfg:
# 25x49 on 2 and 4 ranks, a 2x2 split) and 1-row cores; a whole grid as
# one rank's window.
WINDOW_CASES = [(3, 241, 961), (3, 3, 961), (3, 1201, 4801), (3, 481, 481),
                (2, 13, 49), (2, 7, 49), (2, 3, 49), (2, 13, 25),
                (2, 1, 49), (3, 1, 1), (2, 1, TILE_W + 1),
                (2, TILE_H + 1, TILE_W), (2, 145, 4609), (3, 961, 961)]
# (march, tile) blocks an H100 SXM holds at once, float64 and float32:
# 132 SMs times 4 or 8 blocks of the march and 4 or 8 of the window
# tile (qgstep_resident_blocks, read in chip_smoke.py phase 12: the
# tile's 126 and 64 registers a thread of 128 set them)
RESIDENT_PAIRS = ((528, 528), (1056, 1056))


@pytest.mark.parametrize("resident,resident_tile", RESIDENT_PAIRS)
@pytest.mark.parametrize("nl,rows,cols", WINDOW_CASES,
                         ids=[f"{a}x{b}x{c}" for a, b, c in WINDOW_CASES])
def test_window_geometry_tiles_every_point_once(nl, rows, cols, resident,
                                                resident_tile):
    """The window launch's geometry (ops.qgstep.window_geometry): the
    march where it fills a wave of resident blocks, else tiles; every
    point of the core in exactly one block, no block past the core, the
    counts the launch accepts; a rank's 241x961x3 window is tiled and
    fills at least one wave of the tile's resident blocks."""
    g = window_geometry(nl, rows, cols, resident, resident_tile)
    march = launch_geometry(nl, rows, cols, resident)
    blocks = nl * g.strips_x * g.strips_y
    assert g.tiled == (nl * march.strips_x * march.strips_y < resident)
    if not g.tiled:
        assert g == march and blocks >= resident
    if (nl, rows, cols) == (3, 241, 961):
        assert g.tiled and blocks >= resident_tile
    _assert_tiles_once(g, nl, ny=rows, nx=cols)


def test_wrapper_constants_match_the_kernel_source():
    """STRIP_W, TILE_W, TILE_H, HALO, MAX_LAYERS and the _QgParams layout
    mirror csrc/qgstep.cu; a mismatch would launch the kernel on a wrong
    geometry or a garbled parameter block."""
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             KERNEL_SRC).group(1))
    assert STRIP_W == const("kWindow") - 2 * const("kHalo")
    assert TILE_W == const("kLanes") - 2 * const("kHalo")
    assert TILE_H == const("kTileH")
    assert qgstep_mod.HALO == const("kHalo")
    assert qgstep_mod.MAX_LAYERS == const("kMaxLayers")
    body = re.search(r"struct QgParams \{(.*?)\};", KERNEL_SRC,
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.replace("int ", "").replace("double ", "").strip()
        fields += [re.sub(r"\[.*\]", "", f).strip()
                   for f in decl.split(",") if f.strip()]
    assert fields == [f[0] for f in qgstep_mod._QgParams._fields_]


# The window's plain version against the TPU kernel itself, in float64:
# (cyclic, sponge, x_ext) of the row windows (box, channel, channel with
# the sponge) and the box's x_ext window
WINDOW_PALLAS_CASES = [(False, False, False), (True, False, False),
                       (True, True, False), (False, True, True)]


@pytest.mark.parametrize("cyclic,sponge,x_ext", WINDOW_PALLAS_CASES,
                         ids=["box", "cyclic", "sponge", "x_ext"])
def test_window_reference_matches_pallas_interpret(cyclic, sponge, x_ext):
    """ops.qgstep.window_reference (what the window kernel is held to on
    the card) against qgcm_tpu's qgstep_pallas in interpret mode with
    row0/ny_total (and col0/nx_total), on the same numpy-seeded float64
    windows: within 1e-12 max|q|. The windows have 137 rows, more than
    the Pallas kernel's TILE_Y = 128, so its grid ends in a ragged tile;
    they sit at the south wall, at the north wall and over it (padding
    rows, and in x_ext mode padding columns, where the port writes zeros
    and the Pallas kernel's output is dropped by its callers)."""
    from qgcm_tpu.ops.pallas_qg import TILE_Y, qgstep_pallas
    nl, ny, nx, rows = 3, 150, 20, 131
    assert rows + 6 > TILE_Y
    rng = np.random.default_rng(8)
    fields = rng.standard_normal((4, nl, ny, nx))
    planes = rng.standard_normal((3, ny, nx))
    if cyclic:
        fields[..., -1] = fields[..., 0]
        planes[..., -1] = planes[..., 0]
    consts = tuple(float(c) for c in 0.2 + 0.8 * rng.random(11))
    ah2, ah4 = (tuple(float(a) for a in 0.2 + 0.8 * rng.random(nl))
                for _ in range(2))
    cols, c0s = (13, (0, nx - 13, 11)) if x_ext else (nx, (0, 0, 0))
    gh = 3 if x_ext else 0
    for r0, c0 in zip((0, ny - rows, ny - rows + 6), c0s):
        # global (r, c) at [r + 3, c + gh] of the zero-padded fields
        big = np.pad(fields, ((0, 0), (0, 0), (3, 3 + rows), (gh, gh + cols)))
        bigp = np.pad(planes, ((0, 0), (0, rows), (0, cols)))
        win = big[:3, :, r0:r0 + rows + 6, c0:c0 + cols + 2 * gh]
        qom = big[3, :, r0 + 3:r0 + 3 + rows, c0 + gh:c0 + gh + cols]
        wek, ent, rspl = bigp[:, r0:r0 + rows, c0:c0 + cols]
        kw = dict(row0=r0 - 3, ny_total=ny)
        if x_ext:
            kw.update(col0=c0, nx_total=nx, x_ext=True)
        got = window_reference(
            *(torch.from_numpy(np.ascontiguousarray(f))
              for f in (*win, qom, wek, ent)),
            torch.from_numpy(np.ascontiguousarray(rspl)) if sponge else None,
            consts, ah2, ah4, cyclic=cyclic, sponge=sponge, **kw)

        def gpad(f):         # the core's rows into the window's rows
            return np.pad(f, [(0, 0)] * (f.ndim - 2) + [(3, 3), (0, 0)])

        want = qgstep_pallas(*win, gpad(qom), gpad(wek), gpad(ent),
                             gpad(rspl), consts, ah2, ah4, cyclic=cyclic,
                             sponge=sponge, interpret=True, **kw)
        want = np.asarray(want)[:, 3:-3]
        assert got.shape == want.shape == (nl, rows, cols)
        # the Pallas kernel leaves garbage on padding rows and columns,
        # which its callers drop (qgcm_tpu/parallel/halo.py:647 keeps
        # [:ny, :nx]); the port writes zeros there
        tr, tc = min(rows, ny - r0), min(cols, nx - c0)
        assert rel_err(got[:, :tr, :tc], want[:, :tr, :tc]) <= TOL, (r0, c0)
        assert not got[:, tr:].count_nonzero()
        assert not got[..., tc:].count_nonzero()


def test_window_rule_matches_window_reference():
    """The window modes' autograd rule (ops/qgstep.py::_Window: on the CPU
    window_reference forward, its VJP recomputed in the backward) against
    autograd through window_reference, on a ragged last block (two
    padding rows, and in x_ext two padding columns), for a box row
    window, a channel row window with the sponge and a box x_ext window
    with the sponge: every input's gradient within 1e-12 of its maximum,
    and zero on the padding."""
    gen = torch.Generator().manual_seed(5)
    nl, ny, nx = 2, 13, 11
    for x_ext, cyclic, sponge in [(False, False, False), (False, True, True),
                                  (True, False, True)]:
        _check_window_rule(gen, nl, ny, nx, x_ext, cyclic, sponge)


def _check_window_rule(gen, nl, ny, nx, x_ext, cyclic, sponge):
    rows, cols = 6, (5 if x_ext else nx)
    row0 = ny - rows + 2 - HALO           # core rows ny-4 .. ny+1
    col0 = nx - cols + 2 if x_ext else 0  # core columns nx-3 .. nx+1
    width = cols + (2 * HALO if x_ext else 0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)

    inputs = [rnd(nl, rows + 2 * HALO, width) for _ in range(3)] + [
        rnd(nl, rows, cols), rnd(rows, cols), rnd(rows, cols)] + (
        [rnd(rows, cols)] if sponge else [])
    consts = tuple((0.2 + torch.rand(11, generator=gen,
                                     dtype=torch.float64)).tolist())
    kw = dict(cyclic=cyclic, sponge=sponge, row0=row0, ny_total=ny,
              col0=col0, nx_total=nx, x_ext=x_ext)
    args = (*inputs, *([None] if not sponge else []), consts, (1.0, 2.0),
            (0.5, 0.7))
    out = qgstep(*args, **kw)
    assert type(out.grad_fn).__name__ == "_WindowBackward"
    w = torch.randn(out.shape, generator=gen, dtype=torch.float64)
    got = torch.autograd.grad(out, inputs, w)
    want = torch.autograd.grad(window_reference(*args, **kw), inputs, w)
    core_pad = ny - (row0 + HALO)
    case = (x_ext, cyclic, sponge)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-12 * float(
            b.abs().max()), case
    for i, a in enumerate(got):
        lo = core_pad + (HALO if i < 3 else 0)
        assert not a[..., lo:, :].any(), (case, i)
        if x_ext:
            clo = nx - col0 + (HALO if i < 3 else 0)
            assert not a[..., clo:].any(), (case, i)

