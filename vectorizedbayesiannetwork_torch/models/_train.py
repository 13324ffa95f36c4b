"""The minibatch NLL training loop of the neural CPDs.

Port of ``vectorizedbayesiannetwork_tpu/models/_train.py``'s
``fit_minibatch_nll``, with the JAX schedule: ``bs = min(batch_size, n)``,
``n_batches = ceil(n / bs)``, and each epoch a random permutation of
``arange(n_pad) % n`` (``n_pad = n_batches * bs``), so every batch holds
``bs`` rows and the last repeats some; after each Adam step (``_optim.py``)
an optional EMA shadow ``(1 - a) * old + a * new``. The JAX package runs
the whole loop as one compiled scan; here it is an eager loop of
``torch.autograd.grad`` and ``torch._foreach_*`` updates that reads the
device once (the optimizer's step count) and otherwise only enqueues work.
The permutation is ``torch.randperm`` on the caller's generator: the same
distribution as ``jax.random.permutation``, not the same order.

The trained params come back detached (no autograd graph reaches serving,
as the JAX package's ``_detach``).

``fit_minibatch_nll_many`` is the JAX package's grouped fit: G nodes of
one signature trained together on params stacked on a leading node axis,
one eager loop for the group. The per-node NLL is ``torch.func.vmap``-ed
over the stack, as the JAX package vmaps its scan, which turns each MLP
layer's ``addmm`` into one ``bmm`` over the group; the Adam update runs
``_foreach`` ops on the stacked leaves, with the gradient clipped by each
node's own norm. Node g draws each epoch's permutation from its own
generator, in the order its sequential fit draws it, so the two fits see
the same rows and differ only by float rounding. Training products are
float32 whatever a CPD's ``compute_dtype`` (the NLLs pass no dtype, as in
the JAX package), so the group needs no bf16 product.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._optim import (
    adam_init,
    adam_update_,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def as_rows(a, dim: int, device) -> torch.Tensor:
    """Host or device data as float32 [n, dim] on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a, np.float32)
    return torch.as_tensor(a, device=device).to(torch.float32).reshape(-1, dim)


def batch_schedule(n: int, batch_size: int) -> Tuple[int, int, int]:
    """(bs, n_batches, n_pad) of the JAX schedule."""
    bs = min(int(batch_size), int(n))
    n_batches = -(-int(n) // bs)
    return bs, n_batches, n_batches * bs


def epoch_indices(gen: torch.Generator, n: int, n_pad: int, device):
    """One epoch's row order: a random permutation of arange(n_pad) % n."""
    return torch.randperm(n_pad, generator=gen, device=device) % n


def fit_minibatch_nll(
    nll_fn: Callable,
    net,
    opt: Optional[Dict],
    gen: torch.Generator,
    parents: Optional[torch.Tensor],
    x: torch.Tensor,
    *,
    epochs: int,
    batch_size: int,
    lr: float,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = None,
    aux=None,
    ema_alpha: Optional[float] = None,
) -> Tuple[Dict, Dict]:
    """Train ``net`` by Adam on minibatches; returns (net, opt_state).

    ``nll_fn(net, parents2d, x2d[, aux]) -> scalar mean NLL``; ``x`` [n, Dx]
    and ``parents`` [n, Din] (or None: zero columns) live on the device the
    params live on. The inputs are not modified.
    """
    n, dev = int(x.shape[0]), x.device
    if parents is None:
        parents = torch.zeros((n, 0), dtype=torch.float32, device=dev)
    if opt is None:
        opt = adam_init(net)
    p = [t.detach().clone().requires_grad_(True) for t in tree_leaves(net)]
    m = [t.detach().clone() for t in tree_leaves(opt["m"], net)]
    v = [t.detach().clone() for t in tree_leaves(opt["v"], net)]
    step0 = int(round(float(opt["step"])))
    bs, n_batches, n_pad = batch_schedule(n, batch_size)
    epochs = max(1, int(epochs))
    step = step0
    for _ in range(epochs):
        perm = epoch_indices(gen, n, n_pad, dev)
        for b in range(n_batches):
            idx = perm[b * bs : (b + 1) * bs]
            tree = tree_unflatten(net, p)
            loss = (nll_fn(tree, parents[idx], x[idx]) if aux is None
                    else nll_fn(tree, parents[idx], x[idx], aux))
            grads = torch.autograd.grad(loss, p, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(p, grads)]
            step += 1
            old = None
            if ema_alpha is not None:
                old = [t.detach().clone() for t in p]
            adam_update_(p, grads, m, v, step, lr, weight_decay, max_grad_norm)
            if old is not None:
                with torch.no_grad():
                    torch._foreach_mul_(p, float(ema_alpha))
                    torch._foreach_add_(p, old, alpha=1.0 - float(ema_alpha))
    out = tree_unflatten(net, [t.detach() for t in p])
    state = {
        "m": tree_unflatten(net, m),
        "v": tree_unflatten(net, v),
        "step": opt["step"].detach() + float(step - step0),
    }
    return out, state


def fit_minibatch_nll_many(
    nll_fn: Callable,
    nets,
    gens: Sequence[torch.Generator],
    parents: torch.Tensor,
    x: torch.Tensor,
    *,
    epochs: int,
    batch_size: int,
    lr: float,
    weight_decay: float = 0.0,
    max_grad_norm: Optional[float] = None,
) -> Tuple[Dict, Dict]:
    """Train G same-signature nets at once; returns (nets, opts) stacked on
    axis 0 (``opts["step"]`` is [G]).

    ``nets`` is one tree whose leaves are stacked [G, ...]; ``gens`` the G
    nodes' generators; ``parents`` [G, n, Din] and ``x`` [G, n, Dx]. The
    optimizer state starts fresh (the grouped fit is an initial fit)."""
    g_count, n, dev = int(x.shape[0]), int(x.shape[1]), x.device
    p = [t.detach().clone().requires_grad_(True) for t in tree_leaves(nets)]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    bs, n_batches, n_pad = batch_schedule(n, batch_size)
    epochs = max(1, int(epochs))
    nll_many = torch.func.vmap(nll_fn)
    rows = torch.arange(g_count, device=dev)[:, None]
    step = 0
    for _ in range(epochs):
        perm = torch.stack([epoch_indices(gen, n, n_pad, dev) for gen in gens])
        for b in range(n_batches):
            idx = perm[:, b * bs : (b + 1) * bs]  # [G, bs]
            loss = nll_many(tree_unflatten(nets, p), parents[rows, idx],
                            x[rows, idx]).sum()
            grads = torch.autograd.grad(loss, p, allow_unused=True)
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(p, grads)]
            step += 1
            adam_update_(p, grads, m, v, step, lr, weight_decay,
                         max_grad_norm, stacked=True)
    out = tree_unflatten(nets, [t.detach() for t in p])
    state = {
        "m": tree_unflatten(nets, m),
        "v": tree_unflatten(nets, v),
        "step": torch.full((g_count,), float(step), dtype=torch.float32,
                           device=dev),
    }
    return out, state


def stack_trees(trees: List):
    """G trees of one layout -> one tree of [G, ...] leaves."""
    return tree_unflatten(trees[0], [
        torch.stack(ls) for ls in zip(*[tree_leaves(t, trees[0])
                                        for t in trees])])


def unstack_fit(nets, opts, i: int) -> Tuple[Dict, Dict]:
    """Node i's (net, opt) of a grouped fit's stacked outputs."""
    pick = lambda tree: tree_map(lambda t: t[i], tree)  # noqa: E731
    return pick(nets), {"m": pick(opts["m"]), "v": pick(opts["v"]),
                        "step": opts["step"][i]}
