"""Build and load the port's CUDA kernels.

Each kernel source `qgcm_torch/csrc/<name>.cu` has a plain C interface.
On first use it is compiled with nvcc for Hopper (sm_90a) into
`build/qgcm_torch/<name>-<hash>.so` at the root of the checkout and
loaded with ctypes. The hash covers the source and the compiler flags,
so an edited source is rebuilt. Nothing is compiled when this module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "qgcm_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class Library:
    """A built kernel library: the ctypes handle, the path it was loaded
    from, the seconds the build took (0.0 when it was already built)
    and what nvcc printed (register and shared-memory use)."""

    def __init__(self, cdll, path, build_s, log):
        self.cdll = cdll
        self.path = path
        self.build_s = build_s
        self.log = log


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, or CUDA_HOME/bin)")


def build(name: str) -> Library:
    """Compile csrc/<name>.cu if its hashed library is absent; load it."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{key}.so"
    log_path = so.with_suffix(".log")
    build_s = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed on {src} (exit {res.returncode}):\n"
                    f"{res.stdout}{res.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_s = time.perf_counter() - t0
        log_path.write_text(res.stdout + res.stderr)
    log = log_path.read_text() if log_path.exists() else ""
    return Library(ctypes.CDLL(str(so)), so, build_s, log)
