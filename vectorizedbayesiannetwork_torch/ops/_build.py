"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so it
compiles in seconds. It is built at first use into ``build/kernels/`` at
the root of the checkout, under a name keyed by a hash of the source, the
shared ``csrc/*.cuh`` headers and the flags, so a changed source builds
anew and an unchanged one is reused.
``build_all`` starts one nvcc per source, all at once. Nothing here runs
at import time: the CPU tests import this module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("sweep", "sweep_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library's path, keyed by the source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    text = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(
        text + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; None if built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish(name: str, started) -> None:
    proc, tmp, out, log = started
    try:
        rc = proc.wait()
    finally:
        log.close()
    if rc != 0:
        text = out.with_suffix(".log").read_text()
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {rc}):\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing


def build_all(names: List[str] = SOURCES) -> float:
    """Build every source in parallel; returns the seconds it took."""
    t0 = time.perf_counter()
    with _LOCK:
        started = {n: _start(n) for n in names}
        for n, st in started.items():
            if st is not None:
                _finish(n, st)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers/shared memory) of the last build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return _LIBS[name]
