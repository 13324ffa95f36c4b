"""Diagnostic figures for CPD fits, posteriors and sampling runs.

Counterpart of ``vectorizedbayesiannetwork_tpu/display/figures.py``:
``plot_cpd_fit`` (a histogram of conditional samples per conditioning
row), ``plot_inference_posterior`` (the weighted histogram of a posterior's
particles) and ``plot_sampling_outcome`` (trace and marginal). Tensors go
through ``.detach().cpu().numpy()``. Each returns None when plots are
disabled or matplotlib is missing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .plots import finish, get_pyplot, to_numpy


def plot_cpd_fit(
    handle,
    conditioning_rows=None,
    n_samples: int = 512,
    save_path: Optional[str] = None,
    show: bool = False,
):
    """Histogram of conditional samples for each conditioning row."""
    plt = get_pyplot()
    if plt is None:
        return None
    if conditioning_rows is None:
        rows = [None]
    else:
        rows = list(np.atleast_2d(to_numpy(conditioning_rows).astype(np.float32)))
    fig, axes = plt.subplots(
        1, len(rows), figsize=(4 * len(rows), 3), squeeze=False
    )
    for ax, row in zip(axes[0], rows):
        parents = None if row is None else row.reshape(1, -1)
        samples = to_numpy(handle.sample(parents, n_samples)).ravel()
        ax.hist(samples, bins=40, density=True, alpha=0.75)
        title = "root" if row is None else f"parents={np.round(row, 3)}"
        ax.set_title(f"{handle.node} | {title}", fontsize=9)
    fig.tight_layout()
    finish(plt, fig, save_path, show)
    return fig


def plot_inference_posterior(
    pdf,
    samples,
    target: str = "",
    save_path: Optional[str] = None,
    show: bool = False,
):
    """Weighted histogram of posterior particles (first batch row)."""
    plt = get_pyplot()
    if plt is None:
        return None
    w = to_numpy(pdf)[0]
    x = to_numpy(samples)[0, :, 0]
    w = np.maximum(np.nan_to_num(w), 0.0)
    if w.sum() <= 0:
        w = np.ones_like(w)
    fig, ax = plt.subplots(figsize=(5, 3))
    ax.hist(x, bins=50, weights=w / w.sum(), density=True, alpha=0.8)
    mean = float((w / w.sum() * x).sum())
    ax.axvline(mean, color="k", linestyle="--", linewidth=1)
    ax.set_title(f"posterior p({target} | evidence), mean={mean:.3f}")
    fig.tight_layout()
    finish(plt, fig, save_path, show)
    return fig


def plot_sampling_outcome(
    samples,
    target: str = "",
    save_path: Optional[str] = None,
    show: bool = False,
):
    """Trace (sample index vs value) + marginal histogram."""
    plt = get_pyplot()
    if plt is None:
        return None
    x = to_numpy(samples)[0, :, 0]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(8, 3))
    ax1.plot(x, linewidth=0.7)
    ax1.set_title(f"{target} trace")
    ax2.hist(x, bins=40, density=True, alpha=0.8)
    ax2.set_title(f"{target} marginal")
    fig.tight_layout()
    finish(plt, fig, save_path, show)
    return fig
