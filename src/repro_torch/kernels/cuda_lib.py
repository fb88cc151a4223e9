"""Build and load the port's CUDA C++ kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``. Libraries go into
``_build/`` beside the package (listed in ``.gitignore``), named by a
hash of the source and flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing is built when a module is imported:
``load`` builds on first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names (without ``.cu``) of every CUDA source of the package."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def _paths(name: str):
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    return src, lib, BUILD_DIR / f"{name}.log"


def build_log(name: str) -> str:
    """What nvcc printed for the last build of ``name`` (ptxas usage)."""
    log = _paths(name)[2]
    return log.read_text() if log.exists() else ""


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built: (process,
    temporary output) or None."""
    src, lib, log = _paths(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, started) -> ctypes.CDLL:
    src, lib, log = _paths(name)
    if started is not None:
        proc, tmp = started
        out, _ = proc.communicate()
        log.write_text(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, lib)
    _libs[name] = ctypes.CDLL(str(lib))
    return _libs[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed
    (into a temporary file renamed into place, so a concurrent process
    never loads a half-written library)."""
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
        return _libs[name]


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build every CUDA source of the package at once, one ``nvcc``
    process each, and load them."""
    with _lock:
        names = [n for n in sources() if n not in _libs]
        started = {n: _start(n) for n in names}
        try:
            for n in names:
                _finish(n, started.pop(n))
        finally:
            for proc_tmp in started.values():
                if proc_tmp is not None:
                    proc_tmp[0].kill()
                    proc_tmp[0].wait()
        return {n: _libs[n] for n in sources()}
