"""Build and load the port's CUDA kernels.

Each library is compiled by ``nvcc`` for ``sm_90a`` from the sources in
``repro_torch/csrc`` into a shared library with a plain C interface, and
loaded with ``ctypes``.  The build happens at first use, into
``build/repro_torch/`` at the root of the checkout, under a name keyed by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing is built when a module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The ``nvcc`` on PATH, else the one of the CUDA toolkit PyTorch finds."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def library_path(name: str, sources: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.encode())
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile ``sources`` into the library's path unless it is there;
    returns the path.  Prints the compiler's resource usage when it builds."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           *[str(CSRC / s) for s in sources]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:"
                           f"\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    print(f"[build] {out.name}: {proc.stderr.strip()}")
    return out


def load(name: str, sources: Sequence[str],
         signatures: Dict[str, Tuple[list, object]]) -> ctypes.CDLL:
    """Build (at first use) and load a library; declares each function's
    ``argtypes`` and ``restype`` from ``signatures``."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, sources)))
        for fn, (argtypes, restype) in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        _loaded[name] = lib
    return lib
