"""Shared infrastructure for inference methods.

Counterpart of ``vectorizedbayesiannetwork_tpu/inference/_base.py``. A
``Program`` is one query's inference function plus its inputs. PyTorch
runs eagerly, so there is no compiled-program cache: ``infer_posterior_many``
here runs the programs one after the other, and the mask-dynamic methods
(``_dynamic_base.py``) fuse a query list into one sweep instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.base import Query
from ..core.plan import InferencePlan, get_plan
from ..core.utils import infer_batch_size
from ..parallel.mesh import mesh_signature
from ..utils.profiling import annotate, wait


@dataclass
class Program:
    """``fn(params_tuple, draw, fixed) -> outs`` and ``post(outs) ->
    (pdf, samples)``; ``fixed`` is the packed [B, total_dim] numpy rows,
    or for a mask-dynamic program the tuple (rows, ev, do, tgt) of
    ``pack_dynamic_inputs``."""

    plan: InferencePlan
    fn: Callable
    params: Tuple
    fixed: Union[np.ndarray, Tuple[np.ndarray, ...]]
    post: Callable


class Method:
    def _built(self, vbn, plan: InferencePlan, tag: Tuple,
               build: Callable[[], Callable]) -> Callable:
        """``build()``'s function, made once per (plan, CPD signatures,
        mesh, tag): a function built before ``set_mesh`` is not reused
        after it."""
        cache: Dict[Tuple, Callable] = self.__dict__.setdefault("_fn_cache", {})
        key = (plan, tuple(vbn.cpd_spec(n).static_signature()
                           for n in plan.topo_order),
               mesh_signature(vbn._mesh)) + tuple(tag)
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def make_program(self, vbn, query: Query, **kwargs) -> Optional[Program]:
        return None

    def infer_posterior_many(
        self, vbn, queries: Sequence[Query], **kwargs
    ) -> Optional[List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Answer queries one after the other, or None when a query has no
        program (the caller then calls ``infer_posterior`` per query)."""
        progs = [self.make_program(vbn, q, **kwargs) for q in queries]
        if not progs or any(p is None for p in progs):
            return None
        return [self._run_program(vbn, p) for p in progs]

    def _run_program(self, vbn, prog: Program):
        with annotate("vbn.upload"):
            wait(vbn.device)
            if isinstance(prog.fixed, tuple):
                fixed = tuple(torch.as_tensor(a, device=vbn.device)
                              for a in prog.fixed)
            else:
                fixed = torch.as_tensor(prog.fixed, device=vbn.device)
        return prog.post(prog.fn(prog.params, vbn.next_key(), fixed))

    def _plan_and_batch(self, vbn, query: Query):
        return get_plan(vbn, query), infer_batch_size(query.evidence, query.do)

    @staticmethod
    def _params_tuple(vbn, plan: InferencePlan) -> Tuple:
        return tuple(vbn.params[n] for n in plan.topo_order)

    @staticmethod
    def _cpds(vbn, plan: InferencePlan) -> Tuple:
        return tuple(vbn.cpd_spec(n) for n in plan.topo_order)
