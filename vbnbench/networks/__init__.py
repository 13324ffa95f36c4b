"""Networks the benchmark serves, made from data files and seeds.

A configuration's ``network`` entry names its kind, and
``networks/<kind>.py`` builds it with ``build(spec)``: ``discrete`` (a
structure file ``networks/<name>.json``, node -> [states, parents], with
CPTs drawn from a seed) and ``gaussian`` (a seeded linear-Gaussian
generator). A network has ``nodes`` (topological order) and ``parents``,
and answers what the harness asks of it:

- ``sample(n, seed)``: n ancestral rows, node -> array;
- ``stage2_queries(manifold, n, seed, modes, max_evidence)``: the Stage
  II query mix (``traffic/stage2.py``) over it;
- ``served_values(values)``: evidence values as a call sends them;
- ``call_kwargs(target)``: keyword arguments a call over it needs (a
  target's, or with ``None`` a mixed call's);
- ``cpd_params(node)``: CPD parameters that come from the network (taken
  where the configuration's ``cpd.cards_from_network`` is set).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

from .. import registry


def build(spec: Dict, root: Path = registry.HERE):
    """The network a configuration's ``network`` entry names."""
    return registry.network_kind(spec["kind"], root).build(spec)
