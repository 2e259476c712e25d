"""dst_roofline: the FFT DST kernels' share of their bytes bound
(percent): the bytes their launches in the traced stretch have to move
at the memory rate (portbench/roofline.py::HBM_BYTES_PER_S), over their
device seconds there. The kernels are found by their names (csrc/dst.cu
of the port): `extend_rows`, `extend_tile`, `extract_rows`, `extract_pad`.

A launch's bytes are one read of its input and one write of its output
at the cell's type, a spectrum counted as cuFFT's interleaved output
(its real parts share the imaginary parts' sectors). The box solve's
2-D transform of the interior (ny, nx) of every layer and member is
three launches: an extension of the field along x, the turn (the
x-spectrum's bins read, the y-extension written) and an extract of the
y-spectrum, plain (the forward transform) or scaled inside a ring of
zeros (the inverse). The extensions of the forward and of the inverse
move the same bytes, whichever of extend_rows and extend_tile takes
them, so the count needs only how many transforms ended in each
extract. A stretch whose extensions are not two a transform (a 1-D DST)
reads None."""

from portbench.roofline import HBM_BYTES_PER_S, ITEM_BYTES

EXTENDS = ("extend_rows", "extend_tile")
EXTRACTS = ("extract_rows", "extract_pad")


def launch_bytes(nl: int, nyp: int, nxp: int, dtype: str,
                 members: int = 1) -> dict:
    """Bytes of each launch of one 2-D transform of the p-grid's interior
    for `members` members of `nl` layers: 'extend' (the field along x),
    'turn', 'extract' and 'extract_pad' (the inverse's last launch)."""
    ny, nx = nyp - 2, nxp - 2
    b = members * nl * ITEM_BYTES[dtype]
    field = b * ny * nx
    return dict(
        extend=field + b * ny * (2 * nx + 2),
        turn=b * ny * (nx + 2) * 2 + b * nx * (2 * ny + 2),
        extract=b * nx * (ny + 2) * 2 + field,
        extract_pad=b * nx * (ny + 2) * 2 + b * (ny + 2) * (nx + 2))


def _by_name(d: dict, name: str):
    return sum(v for k, v in d.items() if name in k)


def read(record):
    if not record.get("on_card"):
        return None
    tr = record.get("trace")
    if not tr:
        return None
    n = {k: _by_name(tr["counts"], k) for k in EXTENDS + EXTRACTS}
    seconds = sum(_by_name(tr["seconds"], k) for k in EXTENDS + EXTRACTS)
    transforms = n["extract_rows"] + n["extract_pad"]
    if not transforms or not seconds or (
            n["extend_rows"] + n["extend_tile"] != 2 * transforms):
        return None
    nl, nyp, nxp, _, _ = record["grid"]
    b = launch_bytes(nl, nyp, nxp, record["dtype"], record["members"])
    nbytes = (transforms * (b["extend"] + b["turn"])
              + n["extract_rows"] * b["extract"]
              + n["extract_pad"] * b["extract_pad"])
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
