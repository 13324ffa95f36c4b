"""The port's one kernel-launch seam, on the CPU.

``ops/_build.py::ENTRIES`` types every C entry point of every library; here
each entry is held against its ``extern "C"`` declaration in
``csrc/<lib>.cu`` (a wrong ctypes type would show only on the card, as a
wrong value or a crash). ``ops/_launch.py::launch`` is run on a stand-in
library to hold its rule: the current stream last, and a launch counted
only after a zero return code. The counters register themselves
(``utils/profiling.py::counter``); the eight the package registers keep
their names and keys.
"""

import ast
import contextlib
import ctypes
import re
import types
from pathlib import Path

import pytest
import torch

from vectorizedbayesiannetwork_torch.ops import _build, _launch
from vectorizedbayesiannetwork_torch.utils import profiling

# the C types of the extern "C" blocks -> the ctypes class that passes them
C_TYPES = {
    "int": ctypes.c_int,
    "long long": ctypes.c_longlong,
    "unsigned long long": ctypes.c_ulonglong,
    "unsigned int": ctypes.c_uint,
    "float": ctypes.c_float,
    "size_t": ctypes.c_size_t,
    "int32_t": ctypes.c_int32,
    "uint32_t": ctypes.c_uint32,
    "int64_t": ctypes.c_int64,
    "uint64_t": ctypes.c_uint64,
}
_DECL = re.compile(r"^(?P<ret>[A-Za-z_][\w ]*?)\s+(?P<name>vbn_\w+)\("
                   r"(?P<params>[^)]*)\)\s*\{", re.M)


def _ctype(decl: str):
    """The ctypes class for one C parameter (or return) type."""
    if "*" in decl:
        return ctypes.c_void_p
    return C_TYPES[" ".join(decl.replace("const ", "").split())]


def c_entries(lib: str):
    """{entry: (restype, [argtypes])} as ``csrc/<lib>.cu``'s extern "C"
    block declares them."""
    text = (_build.CSRC / f"{lib}.cu").read_text()
    block = text[text.index('extern "C" {'):text.index('}  // extern "C"')]
    out = {}
    for m in _DECL.finditer(block):
        params = [p.strip() for p in m["params"].split(",") if p.strip()]
        out[m["name"]] = (_ctype(m["ret"]),
                          [_ctype(re.sub(r"\w+$", "", p)) for p in params])
    return out


@pytest.mark.parametrize("lib", _build.SOURCES)
def test_entry_table_matches_the_c_declarations(lib):
    assert tuple(_build.ENTRIES) == _build.SOURCES
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)
    table, declared = _build.ENTRIES[lib], c_entries(lib)
    assert table, f"{lib}: no entry in the table"
    assert set(table) == set(declared)
    for name, (restype, argtypes) in table.items():
        c_ret, c_args = declared[name]
        assert len(argtypes) == len(c_args), name
        assert restype is c_ret, name
        for i, (got, want) in enumerate(zip(argtypes, c_args)):
            assert got is want, f"{name} argument {i}: {got} != {want}"


class _Lib:
    """A stand-in library whose ``vbn_probe`` returns ``rc``."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def vbn_probe(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.mark.parametrize("rc,flagged", [(0, False), (0, True), (2, False),
                                        (2, True)])
def test_launch_counts_only_after_a_zero_return_code(monkeypatch, rc,
                                                     flagged):
    lib = _Lib(rc)
    monkeypatch.setattr(_launch, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=77))
    before = dict(_launch.LAUNCHES)
    if rc:
        with pytest.raises(RuntimeError,
                           match="vbn_probe launch failed: CUDA error 2"):
            _launch.launch("kde", "vbn_probe", 1, 2, device="cuda",
                           key="kde_root", flagged=flagged)
    else:
        _launch.launch("kde", "vbn_probe", 1, 2, device="cuda",
                       key="kde_root", flagged=flagged)
    assert lib.calls == [(1, 2, 77)]  # the stream last
    grew = {k: v - before[k] for k, v in _launch.LAUNCHES.items()
            if v != before[k]}
    want = {} if rc else {"kde_root": 1}
    if flagged and not rc:
        want["kde_root.flagged"] = 1
    assert grew == want


FIXED_KEYS = {
    "LAUNCHES": {"categorical", "lg", "categorical_scan", "lg_scan",
                 "cumsum", "cum_index", "srg", "spg", "kde_root", "kde_cond",
                 "kde_cond_wide", "kde_pick", "uniforms", "gauss_mlp",
                 "kde_root.flagged", "kde_cond.flagged", "kde_pick.flagged"},
    "TRACES": {"sharded", "whole"},
    "CHAINS": {"sharded", "whole"},
    "BUILDS": {"fn", "tables", "plans"},
    "MLP": {"forwards", "rows", "fused", "fused_rows"},
    "SWEEPS": {"target_planes", "packed"},
}


def test_counters_register_themselves():
    """Importing the package registers the eight counters with their
    keys (``ROUTES`` and ``GROUPS`` are ``Counter``s: keys as they come),
    and ``utils/profiling.py`` imports no layer above it."""
    got = profiling.counters()
    assert set(got) == set(FIXED_KEYS) | {"ROUTES", "GROUPS"}
    for name, keys in FIXED_KEYS.items():
        assert set(got[name]) == keys, name
    assert got["LAUNCHES"] == _launch.LAUNCHES
    tree = ast.parse(Path(profiling.__file__).read_text())
    imported = [n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) and n.level]
    assert not [m for m in imported
                if m.split(".")[0] in ("ops", "inference", "sampling")]
