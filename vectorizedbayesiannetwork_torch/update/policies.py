"""The four online update policies.

Port of ``vectorizedbayesiannetwork_tpu/update/policies.py``:

- ``streaming_stats`` and ``online_sgd`` run each CPD's update: the
  closed-form CPDs refit, the gradient CPDs take ``n_steps`` epochs of
  Adam from their stored optimizer state;
- ``ema`` is the gradient update with a shadow average ``p <- (1 - a) old
  + a new`` after each step, and refuses a CPD with no trainable
  parameters;
- ``replay_buffer`` keeps a FIFO buffer of each node's rows (``max_size``)
  and mixes ``replay_ratio`` x batch replayed rows into each update; the
  buffer goes into checkpoints. Its replay indices come from
  ``np.random.default_rng(0)``, as in the JAX package, so both packages
  replay the same rows.

Each policy updates the nodes in topological order, node i from its own
generator ``fold(vbn.next_key(), i)``. When every node has an
``update_program`` the programs run, after every
``update_host_precheck``; otherwise every node runs its eager ``update``.
The JAX package compiles the programs into one dispatch; here both routes
run eagerly, but the route still decides the function (KDE's fixed-shape
Gumbel top-k against its eager concatenation, the declared-support
recounts of the categorical families against their refits).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core.registry import register_update
from ..core.rng import fold
from .base_update import BaseUpdatePolicy, node_update_inputs, resolve_node_update


def _update_all_nodes(vbn, data, *, extra: Optional[Dict] = None,
                      require_nll: bool = False):
    topo = list(vbn.dag.topological_order())
    confs, progs, inputs = [], [], []
    for node in topo:
        conf = resolve_node_update(vbn, node)
        if extra:
            conf = {**conf, **extra}
        cpd = vbn.cpd_spec(node)
        if require_nll and not hasattr(cpd, "_nll"):
            raise NotImplementedError(
                "CPD has no trainable parameters for EMA update"
            )
        confs.append(conf)
        progs.append(cpd.update_program(conf))
        inputs.append(node_update_inputs(vbn, data, node))
    programs = bool(topo) and all(p is not None for p in progs)
    if programs:
        for node, (parents, x) in zip(topo, inputs):
            vbn.cpd_spec(node).update_host_precheck(vbn.params[node], parents,
                                                    x)
    vbn._last_update_route = "program" if programs else "eager"
    for i, (node, conf, prog, (parents, x)) in enumerate(
            zip(topo, confs, progs, inputs)):
        gen = fold(vbn.next_key(), i).generator
        if programs:
            vbn.params[node] = prog(vbn.params[node], gen, parents, x,
                                    device=vbn.device)
        else:
            vbn.params[node] = vbn.cpd_spec(node).update(
                vbn.params[node], parents, x, device=vbn.device, gen=gen,
                **conf)
    vbn._plan_cache.clear()  # an update may refine a CPD's static fields
    return vbn.nodes


@register_update("streaming_stats")
class StreamingStatsUpdate(BaseUpdatePolicy):
    def update(self, vbn, data, **kwargs):
        return _update_all_nodes(vbn, data)


@register_update("online_sgd")
class OnlineSGDUpdate(BaseUpdatePolicy):
    def update(self, vbn, data, **kwargs):
        return _update_all_nodes(vbn, data)


@register_update("ema")
class EMAUpdate(BaseUpdatePolicy):
    def __init__(self, alpha: float = 0.1, **_kwargs) -> None:
        self.alpha = float(alpha)

    def update(self, vbn, data, alpha=None, **kwargs):
        a = float(alpha if alpha is not None else self.alpha)
        return _update_all_nodes(vbn, data, extra={"ema_alpha": a},
                                 require_nll=True)


@register_update("replay_buffer")
class ReplayBufferUpdate(BaseUpdatePolicy):
    def __init__(self, max_size: int = 2000, replay_ratio: float = 0.5) -> None:
        self.max_size = int(max_size)
        self.replay_ratio = float(replay_ratio)
        self._buffer: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._rng = np.random.default_rng(0)

    def update(self, vbn, data, **kwargs):
        for node_idx, node in enumerate(vbn.dag.topological_order()):
            conf = resolve_node_update(vbn, node)
            parents, x = node_update_inputs(vbn, data, node)
            self._update_buffer(node, parents, x)
            parents_mix, x_mix = self._mix_with_replay(node, parents, x)
            gen = fold(vbn.next_key(), node_idx).generator
            vbn.params[node] = vbn.cpd_spec(node).update(
                vbn.params[node], parents_mix, x_mix, device=vbn.device,
                gen=gen, **conf)
        vbn._last_update_route = "eager"
        vbn._plan_cache.clear()
        return vbn.nodes

    @staticmethod
    def _as_rows(parents, x):
        x = np.asarray(x, np.float32)
        parents = (np.zeros((x.shape[0], 0), np.float32) if parents is None
                   else np.asarray(parents, np.float32))
        return parents, x

    def _update_buffer(self, node, parents, x) -> None:
        parents, x = self._as_rows(parents, x)
        if node not in self._buffer:
            self._buffer[node] = (parents.copy(), x.copy())
            return
        p_buf, x_buf = self._buffer[node]
        p_buf = np.concatenate([p_buf, parents], axis=0)[-self.max_size:]
        x_buf = np.concatenate([x_buf, x], axis=0)[-self.max_size:]
        self._buffer[node] = (p_buf, x_buf)

    def _mix_with_replay(self, node, parents, x):
        parents, x = self._as_rows(parents, x)
        p_buf, x_buf = self._buffer.get(node, (parents[:0], x[:0]))
        if p_buf.shape[0] == 0:
            return (parents if parents.shape[1] else None), x
        n_replay = int(max(1, self.replay_ratio * x.shape[0]))
        idx = self._rng.integers(0, p_buf.shape[0], size=n_replay)
        p_mix = np.concatenate([parents, p_buf[idx]], axis=0)
        x_mix = np.concatenate([x, x_buf[idx]], axis=0)
        return (p_mix if p_mix.shape[1] else None), x_mix

    def get_state(self):
        meta = {"nodes": sorted(self._buffer)}
        arrays = {}
        for node, (p_buf, x_buf) in self._buffer.items():
            arrays[f"buffer_p/{node}"] = p_buf
            arrays[f"buffer_x/{node}"] = x_buf
        return meta, arrays

    def set_state(self, meta, arrays) -> None:
        self._buffer = {}
        for node in meta.get("nodes", []):
            p = arrays.get(f"buffer_p/{node}")
            x = arrays.get(f"buffer_x/{node}")
            if p is not None and x is not None:
                self._buffer[node] = (np.asarray(p, np.float32),
                                      np.asarray(x, np.float32))
