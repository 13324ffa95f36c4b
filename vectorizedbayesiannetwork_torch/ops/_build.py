"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so it
compiles in seconds. It is built at first use into the directory that
``core/cache.py`` resolves (``build/kernels/`` at the root of the checkout
unless ``VBN_COMPILATION_CACHE`` says otherwise), under a name keyed by a
hash of the source, the shared ``csrc/*.cuh`` headers and the flags, so a
changed source builds anew and an unchanged one is reused.
``build_all`` starts one nvcc per source, all at once. Nothing here runs
at import time: the CPU tests import this module on machines without nvcc.

``ENTRIES`` is the one table of every C entry point of every library, by
source: its ``restype`` and ``argtypes``, as ``extern "C"`` declares it in
``csrc/<name>.cu`` (``tests/test_torch_launch.py`` holds each against its
declaration). ``load`` types them all when it first loads a library; a
kernel launch goes through ``ops/_launch.py``.
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

from ..core.cache import DEFAULT_DIR as BUILD_DIR  # the default location
from ..core.cache import kernel_build_dir

CSRC = Path(__file__).resolve().parent.parent / "csrc"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_Z, _U32, _U64 = ctypes.c_size_t, ctypes.c_uint32, ctypes.c_uint64
_RD = [_P, _L, _I]  # a KDE read flag: pointer, stride, launch rows a row
_COND = [_P] * 5 + [_I] * 4 + [_F] * 4  # the KDE conditionals' shared head

# source -> entry point -> (restype, argtypes); a launch's last argument is
# its stream
ENTRIES = {
    "sweep": {
        "vbn_cat_sweep_smem_bytes": (_Z, [_I] * 3),
        "vbn_cat_sweep": (_I, [_P, _P, _I, _I, _I, _P, _P, _P, _U32, _P, _P,
                               _U64] + [_I] * 11 + [_P] * 5),
        "vbn_lg_sweep": (_I, [_P, _P, _P, _I, _I, _I, _P, _U64, _P, _P, _U64]
                         + [_I] * 10 + [_P] * 5),
    },
    "sweep_scan": {
        "vbn_smem_optin": (_I, [_I]),
        "vbn_cat_scan_smem_bytes": (_Z, [_I] * 5),
        "vbn_lg_scan_smem_bytes": (_Z, [_I] * 4),
        "vbn_cat_scan_occupancy": (_I, [_I, _I, _I, _Z, _I]),
        "vbn_lg_scan_occupancy": (_I, [_I, _I, _Z, _I]),
        "vbn_cat_scan": (_I, [_P, _P, _I, _I, _P, _P, _P, _P, _P, _U64]
                         + [_I] * 14 + [_P] * 5),
        "vbn_lg_scan": (_I, [_P, _P, _P, _I, _I, _P, _P, _P, _P, _U64]
                        + [_I] * 12 + [_P] * 5),
    },
    "resample": {
        "vbn_cumsum_scratch": (_L, [_L]),
        "vbn_cumsum": (_I, [_P, _P, _I, _L, _I, _P, _P]),
        "vbn_cum_index": (_I, [_P, _I, _L, _P, _L, _L, _I, _P, _P, _P]),
        "vbn_srg": (_I, [_P, _I, _L, _P, _F, _P, _I, _P, _P]),
        "vbn_spg": (_I, [_P, _I, _L, _P, _L, _P, _I, _P, _P]),
        "vbn_merge_grid": (_I, [_I, _L, _I, _I, _P]),
    },
    "kde": {
        "vbn_kde_root": (_I, [_P] * 3 + [_I] * 3 + [_F] * 2 + _RD + [_P, _P]),
        "vbn_kde_cond": (_I, _COND + _RD + [_P, _P]),
        "vbn_kde_cond_wide_scratch": (_L, [_I] * 3),
        "vbn_kde_cond_wide": (_I, _COND + [_P] * 3),
        "vbn_kde_pick": (_I, [_P] * 6 + [_I] * 4 + [_F, _L, _I, _L] + _RD
                         + [_P, _P]),
        "vbn_kde_mma_probe": (_I, [_P] * 4 + [_I, _P]),  # a test hook
    },
    "rng": {
        "vbn_uniforms": (_I, [ctypes.c_ulonglong, _L, _I, _P] + [_I] * 6
                         + [_P, _P]),
    },
    "mlp": {
        "vbn_gauss_mlp": (_I, [_P, _L, _I, _I, _I, _I, _P, _F, _P, _P, _P]),
    },
}
SOURCES = tuple(ENTRIES)
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
    return kernel_build_dir() / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; None if built."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
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
    """The built library for ``csrc/<name>.cu`` with its ``ENTRIES`` typed,
    building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(library_path(name)))
            for entry, (restype, argtypes) in ENTRIES[name].items():
                fn = getattr(lib, entry)
                fn.restype, fn.argtypes = restype, argtypes
            _LIBS[name] = lib
        return _LIBS[name]
