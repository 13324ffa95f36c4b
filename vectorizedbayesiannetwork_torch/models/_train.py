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
as the JAX package's ``_detach``). The JAX package's grouped fit
(``fit_minibatch_nll_many``, off by default there) is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ._optim import adam_init, adam_update_, tree_leaves, tree_unflatten


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
