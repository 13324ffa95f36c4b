"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix and each per-layer metric. Each piece is a
file of its own, found by that name:

- ``configs/<config>.json`` (through the configuration's ``file``);
- ``networks/<kind>.py``, a ``build(spec)`` per network kind, named by
  the configuration's ``network.kind``;
- ``traffic/<mix>.json``, read by the one generator in ``traffic/``;
- ``limits/<cell>.json``, the limits of the check that decides
  ``correct`` and the number of rows it samples;
- ``reference/<cpd family>.py``, a ``judge(cell, sampled, observed,
  device, control)`` per CPD family, and optionally ``observe(cell,
  vbn)``: what of the program's fitted state the check reads to judge;
- ``work/<cpd family>.py``, a ``count(net, call, s)`` per CPD family,
  and optionally ``network(cell)``: what the count reads;
- ``metrics/<metric>.py``, a ``read(ctx)`` per per-layer metric.

Modules are loaded from their files, so a file dropped into its folder
is found with no edit to any other. A module that needs a shared helper
imports it by its full name (``vbnbench.reference.fit``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def load_benchmark(path: Optional[Path] = None) -> Dict:
    return json.loads(Path(path or CHECKOUT / "BENCHMARK.json").read_text())


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str, checkout: Path = CHECKOUT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((checkout / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix(name: str, root: Path = HERE) -> Dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str, root: Path = HERE) -> Dict:
    return json.loads((root / "limits" / f"{cell_name}.json").read_text())


def module(folder: str, name: str, root: Path = HERE) -> ModuleType:
    """``<root>/<folder>/<name>.py``, loaded from its file."""
    path = root / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"vbnbench_{folder}_{name}".replace("-", "_").replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def network_kind(kind: str, root: Path = HERE) -> ModuleType:
    return module("networks", kind, root)


def reference(family: str, root: Path = HERE) -> ModuleType:
    return module("reference", family, root)


def work_counter(family: str, root: Path = HERE) -> ModuleType:
    return module("work", family, root)


def metric_reader(name: str, root: Path = HERE) -> ModuleType:
    return module("metrics", name, root)
