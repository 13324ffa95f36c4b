"""Where the CUDA kernels are built and reused (the compile cache).

Counterpart of ``vectorizedbayesiannetwork_tpu/core/cache.py``, which
points JAX's persistent compilation cache at a durable directory so that a
second process skips every XLA compile. The port compiles its kernels with
nvcc (``ops/_build.py``) into libraries named by a hash of the source, the
shared headers and the flags, so a second process that finds a library
loads it instead of building it again. This module says where:

- ``VBN_COMPILATION_CACHE=<dir>`` overrides the location;
- ``VBN_COMPILATION_CACHE=0`` (or ``off``, ``none``, ``false``, empty)
  disables reuse: the process builds into a fresh directory of its own
  under ``build/``, removed when it exits;
- by default, ``build/kernels/`` at the root of the checkout (which
  ``.gitignore`` lists).

The variable is read when the first kernel is built, never at import.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Optional

_DISABLE = ("", "0", "off", "none", "false")
DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_LOCK = threading.Lock()
_DIR: Optional[Path] = None  # this process's choice, made at first build


def enable_compilation_cache() -> Optional[str]:
    """The directory the kernel libraries are kept in and reused from, or
    None when ``VBN_COMPILATION_CACHE`` disables reuse."""
    override = os.environ.get("VBN_COMPILATION_CACHE")
    if override is not None and override.strip().lower() in _DISABLE:
        return None
    return str(Path(override).expanduser() if override else DEFAULT_DIR)


def kernel_build_dir() -> Path:
    """Where this process builds and loads its kernels: the cache
    directory, or with reuse disabled a fresh one of its own. Resolved
    once, at the first call."""
    global _DIR
    with _LOCK:
        if _DIR is None:
            cache = enable_compilation_cache()
            if cache is None:
                DEFAULT_DIR.parent.mkdir(parents=True, exist_ok=True)
                fresh = tempfile.mkdtemp(prefix=f"kernels-{os.getpid()}-",
                                         dir=DEFAULT_DIR.parent)
                atexit.register(shutil.rmtree, fresh, True)
                _DIR = Path(fresh)
            else:
                _DIR = Path(cache)
        return _DIR
