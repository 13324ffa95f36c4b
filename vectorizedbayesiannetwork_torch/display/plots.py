"""Plot guards and shared helpers.

Counterpart of ``vectorizedbayesiannetwork_tpu/display/plots.py``:
plotting is optional, gated by the ``VBN_SKIP_PLOTS`` environment variable
and a lazy matplotlib import (Agg backend), so headless runs and machines
without matplotlib never touch a display stack.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

_DPI = 300


def plots_enabled() -> bool:
    return os.environ.get("VBN_SKIP_PLOTS", "0") not in {"1", "true", "yes"}


def get_pyplot():
    """Lazy matplotlib import; None when unavailable or disabled."""
    if not plots_enabled():
        return None
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        return None


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def finish(plt, fig, save_path: Optional[str], show: bool) -> None:
    if save_path:
        fig.savefig(save_path, dpi=_DPI, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
