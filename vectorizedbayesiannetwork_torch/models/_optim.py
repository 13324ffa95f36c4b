"""Adam as functions on a parameter tree, with the JAX package's state.

Port of ``vectorizedbayesiannetwork_tpu/models/_optim.py``: the state is
``{"m": tree, "v": tree, "step": 0-d float32}`` (saved as ``opt/...`` in
checkpoints, as the JAX package saves it), weight decay is L2 folded into
the gradient (coupled, not decoupled), the gradient is clipped by its
global norm with the factor ``min(1, max_grad_norm / max(norm, 1e-12))``,
and the moments are bias-corrected. ``torch.optim.Adam`` and
``clip_grad_norm_`` keep another state layout and clip by another formula,
so the update is written here over ``torch._foreach_*`` ops.

Trees are nested dicts and lists of tensors; ``tree_leaves`` lists a tree's
tensors in the key order of a template tree, so two trees that a
checkpoint stored in different key orders still line up leaf for leaf.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_EPS = 1e-8
_B1 = 0.9
_B2 = 0.999


def tree_leaves(tree, like=None) -> List[torch.Tensor]:
    """The tensors of ``tree``, depth first in ``like``'s key order
    (default: the tree's own); ``None`` entries hold no tensor."""
    like = tree if like is None else like
    if isinstance(like, dict):
        # a subtree with no tensor (a root's empty ``emb``) is not saved
        # in a checkpoint, so ``tree`` may lack it
        return [t for k in like for t in tree_leaves(
            tree[k] if k in tree or tree_leaves(like[k]) else like[k],
            like[k])]
    if isinstance(like, (list, tuple)):
        return [t for a, b in zip(tree, like) for t in tree_leaves(a, b)]
    return [] if like is None else [tree]


def tree_unflatten(template, leaves):
    """A tree shaped as ``template`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return None if node is None else next(it)

    return build(template)


def tree_map(fn: Callable, tree):
    return tree_unflatten(tree, [fn(t) for t in tree_leaves(tree)])


def adam_init(params) -> Dict:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.float32, device=device),
    }


def bias_corrections(step: int) -> Tuple[float, float]:
    """(1 / (1 - b1^t), 1 / (1 - b2^t)) in float32, as the JAX package
    computes them from its float32 step."""
    t = np.float32(step)
    one = np.float32(1.0)
    return (float(one / (one - np.float32(_B1) ** t)),
            float(one / (one - np.float32(_B2) ** t)))


@torch.no_grad()
def adam_update_(
    p: List[torch.Tensor],
    g: List[torch.Tensor],
    m: List[torch.Tensor],
    v: List[torch.Tensor],
    step: int,
    lr: float,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = None,
    stacked: bool = False,
) -> None:
    """One Adam update in place on the leaf lists; ``step`` counts this
    update (the first is 1). ``g`` is read, not written.

    ``stacked=True``: every leaf carries a leading node axis G (the grouped
    fit), and the gradient is clipped by each node's own global norm over
    its slice, as the JAX package's vmapped ``adam_step`` clips it."""
    if weight_decay:
        g = torch._foreach_add(g, p, alpha=weight_decay)
    if max_grad_norm is not None and max_grad_norm > 0:
        if stacked:
            sq = [t.reshape(t.shape[0], -1).square().sum(dim=1) for t in g]
            gnorm = torch.sqrt(torch.stack(sq).sum(dim=0))  # [G]
        else:
            gnorm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(g)))
        clip = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
        if stacked:
            g = [t * clip.view(-1, *([1] * (t.dim() - 1))) for t in g]
        else:
            g = torch._foreach_mul(g, clip)
    torch._foreach_mul_(m, _B1)
    torch._foreach_add_(m, g, alpha=1.0 - _B1)
    torch._foreach_mul_(v, _B2)
    torch._foreach_addcmul_(v, g, g, value=1.0 - _B2)
    mhat, vhat = bias_corrections(step)
    den = torch._foreach_sqrt(torch._foreach_mul(v, vhat))
    torch._foreach_add_(den, _EPS)
    torch._foreach_addcdiv_(p, torch._foreach_mul(m, mhat), den, value=-lr)


def adam_step(
    params,
    grads,
    state: Dict,
    lr: float,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = None,
) -> Tuple[Dict, Dict]:
    """One Adam update. Returns (new_params, new_state); the inputs are
    left as they were."""
    p = [t.detach().clone() for t in tree_leaves(params)]
    m = [t.clone() for t in tree_leaves(state["m"], params)]
    v = [t.clone() for t in tree_leaves(state["v"], params)]
    g = [t.detach() for t in tree_leaves(grads, params)]
    step = int(round(float(state["step"]))) + 1
    adam_update_(p, g, m, v, step, lr, weight_decay, max_grad_norm)
    return tree_unflatten(params, p), {
        "m": tree_unflatten(params, m),
        "v": tree_unflatten(params, v),
        "step": state["step"] + 1.0,
    }
