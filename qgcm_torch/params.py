"""input.params-compatible runtime parameter handling.

Replaces src/in_param.f (ordered comment-skipping reader via ipbget:
lines whose first column is '!' are ignored, each value/vector sits on
one significant line, Fortran D-exponents allowed) and src/out_param.f
(machine-readable input_parameters.m dump consumed by the analysis
layer, qgcm_k247.rb:514-563).

Grid DIMENSIONS are not in input.params (they were compile-time
PARAMETERs, src/parameters_data.F); supply them via a preset name or
explicit keywords when converting to a ModelConfig.

Copied from qgcm_tpu/params.py, which is NumPy-only but cannot be
imported without JAX; only the imports differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from .config import (ModelConfig, OceanConfig, AtmosConfig,
                     MixedLayerConfig, RadiationConfig)

SECDAY = 86400.0
DAYSYR = 365.0
SECSYR = SECDAY * DAYSYR


@dataclass
class RunParams:
    """The ~50 ordered runtime parameters of input.params."""
    trun: float = 1.0
    dta: float = 180.0
    nstr: int = 3
    dxo: float = 5.0e3
    delek: float = 2.0
    cdat: float = 1.3e-3
    rhoat: float = 1.0
    rhooc: float = 1.0e3
    cpat: float = 1.0e3
    cpoc: float = 4.0e3
    bccoat: float = 1.0
    bccooc: float = 0.2
    xcexp: float = 1.0
    ycexp: float = 1.0
    valday: float = 0.25
    odiday: float = 10.0
    adiday: float = 5.0
    dgnday: float = 1.0
    prtday: float = 10.0
    resday: float = 0.0
    nsko: int = 1
    nska: int = 1
    dtavat: float = 0.25
    dtavoc: float = 1.0
    dtcovat: float = 0.0
    dtcovoc: float = 0.0
    xlamda: float = 35.0
    hmoc: float = 100.0
    st2d: float = 100.0
    st4d: float = 2.0e9
    hmat: float = 1000.0
    hmamin: float = 100.0
    ahmd: float = 2.0e5
    at2d: float = 2.5e4
    at4d: float = 2.0e14
    hmadmp: float = 0.15
    fsbar: float = -210.0
    fspamp: float = 80.0
    zm: float = 200.0
    zopt: Tuple[float, ...] = (2.0e4, 2.0e4, 3.0e4)
    gamma: float = 1.0e-2
    ah2oc: Tuple[float, ...] = (0.0, 0.0, 0.0)
    ah4oc: Tuple[float, ...] = (2.0e9, 2.0e9, 2.0e9)
    tabsoc: Tuple[float, ...] = (287.0, 282.0, 276.0)
    hoc: Tuple[float, ...] = (350.0, 750.0, 2900.0)
    gpoc: Tuple[float, ...] = (0.015, 0.0075)
    ah4at: Tuple[float, ...] = (1.5e14, 1.5e14, 1.5e14)
    tabsat: Tuple[float, ...] = (330.0, 340.0, 350.0)
    hat: Tuple[float, ...] = (2000.0, 3000.0, 4000.0)
    gpat: Tuple[float, ...] = (1.2, 0.4)
    name: str = "zero"          # initial state: zero | rbal | <file>
    topocname: str = "flat"
    topatname: str = "flat"
    outfloc: Tuple[int, ...] = (1, 1, 1, 1, 1, 1, 0)
    outflat: Tuple[int, ...] = (1, 1, 1, 1, 1, 1, 1)


_ORDER = [
    ("trun", float), ("dta", float), ("nstr", int), ("dxo", float),
    ("delek", float), ("cdat", float), ("rhoat", float),
    ("rhooc", float), ("cpat", float), ("cpoc", float),
    ("bccoat", float), ("bccooc", float), ("xcexp", float),
    ("ycexp", float), ("valday", float), ("odiday", float),
    ("adiday", float), ("dgnday", float), ("prtday", float),
    ("resday", float), ("nsko", int), ("nska", int), ("dtavat", float),
    ("dtavoc", float), ("dtcovat", float), ("dtcovoc", float),
    ("xlamda", float), ("hmoc", float), ("st2d", float),
    ("st4d", float), ("hmat", float), ("hmamin", float),
    ("ahmd", float), ("at2d", float), ("at4d", float),
    ("hmadmp", float), ("fsbar", float), ("fspamp", float),
    ("zm", float), ("zopt", "vecf"), ("gamma", float),
    ("ah2oc", "vecf"), ("ah4oc", "vecf"), ("tabsoc", "vecf"),
    ("hoc", "vecf"), ("gpoc", "vecf"), ("ah4at", "vecf"),
    ("tabsat", "vecf"), ("hat", "vecf"), ("gpat", "vecf"),
    ("name", str), ("topocname", str), ("topatname", str),
    ("outfloc", "veci"), ("outflat", "veci"),
]


def _fnum(tok: str) -> float:
    return float(tok.replace("D", "e").replace("d", "e"))


def parse_input_params(path: str) -> RunParams:
    """Read an input.params file in the reference's exact grammar."""
    with open(path) as f:
        lines = [ln[:80].rstrip() for ln in f
                 if ln.strip() and not ln.startswith("!")]
    out = {}
    i = 0
    for field_name, kind in _ORDER:
        if i >= len(lines):
            raise ValueError(f"input.params ended before '{field_name}'")
        # strip trailing inline comments
        body = lines[i].split("!")[0].strip()
        i += 1
        if kind is str:
            out[field_name] = body
        elif kind is float:
            out[field_name] = _fnum(body.split()[0])
        elif kind is int:
            out[field_name] = int(float(_fnum(body.split()[0])))
        elif kind == "vecf":
            out[field_name] = tuple(_fnum(t) for t in body.split())
        elif kind == "veci":
            out[field_name] = tuple(int(t) for t in body.split())
    return RunParams(**out)


def params_to_config(p: RunParams, base: ModelConfig) -> ModelConfig:
    """Merge runtime parameters into a (dimension-carrying) base
    ModelConfig. Layer vectors are truncated/validated to the base
    layer counts exactly as the reference ties them to the
    compile-time nlo/nla."""
    nlo = len(p.hoc)
    nla = len(p.hat)

    def fit(vec, n):
        """Fortran list-directed read into a length-n array: take the
        first n values; pad by repeating the last if short."""
        v = tuple(vec)[:n]
        return v + (v[-1],) * (n - len(v))

    ocean = OceanConfig(
        nlo=nlo, dxo=p.dxo, delek=p.delek, bccooc=p.bccooc,
        hoc=tuple(p.hoc), gpoc=fit(p.gpoc, nlo - 1),
        tabsoc=fit(p.tabsoc, nlo),
        ah2oc=fit(p.ah2oc, nlo), ah4oc=fit(p.ah4oc, nlo))
    atmos = AtmosConfig(
        nla=nla, bccoat=p.bccoat, hat=tuple(p.hat),
        gpat=fit(p.gpat, nla - 1), tabsat=fit(p.tabsat, nla),
        ah4at=fit(p.ah4at, nla))
    mixed = MixedLayerConfig(
        xlamda=p.xlamda, hmoc=p.hmoc, st2d=p.st2d, st4d=p.st4d,
        hmat=p.hmat, hmamin=p.hmamin, ahmd=p.ahmd, at2d=p.at2d,
        at4d=p.at4d, hmadmp=p.hmadmp)
    rad = RadiationConfig(fsbar=p.fsbar, fspamp=p.fspamp, zm=p.zm,
                          zopt=tuple(p.zopt[:nla]), gamma=p.gamma)
    return base.replace(
        dta=p.dta, nstr=p.nstr, cdat=p.cdat, rhoat=p.rhoat,
        rhooc=p.rhooc, cpat=p.cpat, cpoc=p.cpoc, xcexp=p.xcexp,
        ycexp=p.ycexp, ocean=ocean, atmos=atmos, mixed=mixed,
        radiation=rad).validate()


def write_matlab_params(path: str, p: RunParams, cfg: ModelConfig,
                        model=None, tini: float = 0.0,
                        nscvoc: int = 4, nscvat: int = 2):
    """Write input_parameters.m: one 'name = value;' assignment per
    line covering every quantity of the reference dump (out_param.f:
    configuration flags, dimensions, covariance dims, all runtime
    parameters, and the derived eigenmode/radiation/sponge values)."""
    lines = []

    def put(n, v):
        import numpy as _np
        if isinstance(v, _np.ndarray) and v.ndim > 0:
            v = tuple(v.tolist())
        if isinstance(v, str):
            lines.append(f"{n} = '{v}';")
        elif isinstance(v, (tuple, list)):
            body = " ".join(f"{float(x):.10g}" for x in v)
            lines.append(f"{n} = [ {body} ];")
        else:
            lines.append(f"{n} = {float(v):.10g};")

    # configuration flags (out_param.f:33-64)
    put("oceanonly", int(cfg.ocean_only))
    put("atmosonly", int(cfg.atmos_only))
    put("getcovar", int(bool(p.dtcovoc or p.dtcovat)))
    put("cyclicoc", int(cfg.cyclic_ocean))
    put("hflxsb", int(cfg.sb_hflux))
    put("hflxnb", int(cfg.nb_hflux))
    put("tauudiff", int(cfg.tau_udiff))
    # covariance subsampling dims (out_param.f:83-95)
    nvcvoc = ((cfg.nypo - 1) // nscvoc) * ((cfg.nxpo - 1) // nscvoc)
    nvcvat = ((cfg.nypa - 1) // nscvat) * ((cfg.nxpa - 1) // nscvat)
    put("nscvoc", nscvoc); put("nvcvoc", nvcvoc)
    put("nmcvoc", nvcvoc * (nvcvoc + 1) // 2)
    put("nscvat", nscvat); put("nvcvat", nvcvat)
    put("nmcvat", nvcvat * (nvcvat + 1) // 2)
    # time bookkeeping (out_param.f:69-75)
    put("tini", tini); put("tend", tini + p.trun)
    put("trun", p.trun); put("dta", p.dta); put("nstr", p.nstr)
    put("dxo", p.dxo); put("delek", p.delek); put("cdat", p.cdat)
    put("rhoat", p.rhoat); put("rhooc", p.rhooc)
    put("cpat", p.cpat); put("cpoc", p.cpoc)
    put("bccoat", p.bccoat); put("bccooc", p.bccooc)
    put("xcexp", p.xcexp); put("ycexp", p.ycexp)
    put("valday", p.valday); put("odiday", p.odiday)
    put("adiday", p.adiday); put("dgnday", p.dgnday)
    # output intervals in steps (out_param.f:108-109): noutoc counts
    # OCEAN steps (dto = nstr*dta), noutat atmospheric steps
    dto = p.dta * p.nstr
    put("noutoc", round(p.odiday * 86400.0 / dto) if p.odiday > 0 else 0)
    put("noutat", round(p.adiday * 86400.0 / p.dta) if p.adiday > 0
        else 0)
    put("prtday", p.prtday); put("resday", p.resday)
    put("nsko", p.nsko); put("nska", p.nska)
    put("dtavat", p.dtavat); put("dtavoc", p.dtavoc)
    put("xlamda", p.xlamda); put("hmoc", p.hmoc)
    put("st2d", p.st2d); put("st4d", p.st4d)
    put("hmat", p.hmat); put("hmamin", p.hmamin); put("ahmd", p.ahmd)
    put("at2d", p.at2d); put("at4d", p.at4d); put("hmadmp", p.hmadmp)
    put("fsbar", p.fsbar); put("fspamp", p.fspamp); put("zm", p.zm)
    put("zopt", p.zopt); put("gamma", p.gamma)
    put("ah2oc", p.ah2oc); put("ah4oc", p.ah4oc)
    put("tabsoc", p.tabsoc); put("hoc", p.hoc); put("gpoc", p.gpoc)
    put("ah4at", p.ah4at); put("tabsat", p.tabsat); put("hat", p.hat)
    put("gpat", p.gpat)
    put("nxta", cfg.nxta); put("nyta", cfg.nyta)
    put("nxaooc", cfg.nxaooc); put("nyaooc", cfg.nyaooc)
    put("ndxr", cfg.ndxr); put("nxto", cfg.nxto); put("nyto", cfg.nyto)
    put("nxpo", cfg.nxpo); put("nypo", cfg.nypo)
    put("nxpa", cfg.nxpa); put("nypa", cfg.nypa)
    put("nx1", cfg.nx1); put("ny1", cfg.ny1)
    put("fnot", cfg.fnot); put("beta", cfg.beta)
    put("dxa", cfg.dxa); put("dto", cfg.dto)
    put("nlo", cfg.nlo); put("nla", cfg.nla)
    # initial-state / output selectors (out_param.f:280-300)
    put("name", p.name)
    put("outfloc", [float(x) for x in p.outfloc])
    put("outflat", [float(x) for x in p.outflat])
    if model is not None:
        # derived eigenmode, radiation and sponge quantities
        # (out_param.f:305-420)
        put("rdefoc", model.modes_oc.rdef)
        put("rdefat", model.modes_at.rdef)
        put("cphsoc", model.modes_oc.cphs)
        put("cphsat", model.modes_at.cphs)
        put("tmbara", model.rad.tmbara)
        put("tmbaro", model.rad.tmbaro)
        put("tocc", model.rad.toc)
        put("tat", model.rad.tat)
        put("tsbdy", model.rad.tsbdy)
        put("tnbdy", model.rad.tnbdy)
        put("aface", model.rad.aface)
        put("bface", model.rad.bface)
        put("cface", model.rad.cface)
        put("dface", model.rad.dface)
        put("l_spl", cfg.sponge.l_spl if cfg.sponge.enabled else 0.0)
        put("c1_spl", cfg.sponge.c1_spl if cfg.sponge.enabled else 0.0)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
