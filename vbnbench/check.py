"""What decides ``correct``: the served rows against the plain reference.

After the window a sample of the rows it served, drawn from the seed, is
judged by three numbers, each against the cell's limit in
``limits/<cell>.json``:

- ``z_rms`` and ``z_max``: the gap between each served number (a pmf
  class; a mean or a std) and the reference's, in units of the
  Monte-Carlo standard error that the configuration's particle count
  gives; the root mean square and the widest gap over the sample. Sound
  runs read about 1 and about 4; an estimate from fewer particles, or
  an altered answer, reads far above;
- ``rows_bad``: sampled rows that never came back, are not finite, or
  put mass outside the target's states (limit 0).

Discrete rows are judged against exact variable elimination of the
refitted CPTs (``reference/ve.py``: the answer and the delta-method
variance of likelihood weighting); KDE rows against plain likelihood
weighting of the fitted KDE network at more particles
(``reference/kde_lw.py``), the served estimate's standard error taken as
the reference's scaled by the ratio of particle counts. A KDE row whose
reference holds fewer than ``min_reference_ess`` effective particles has
no standard error to judge by (with one particle left, the delta-method
error is nought): it is left out of ``z_rms`` and ``z_max``, by that
rule on the reference alone, and counted in ``rows_unjudged``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Row = Tuple[Optional[np.ndarray], str, Dict[str, float]]


def _summary(zs: List[float], bad: int) -> Dict[str, float]:
    z = np.asarray(zs, np.float64)
    if z.size == 0:
        return {"z_rms": float("inf"), "z_max": float("inf"), "rows_bad": bad}
    return {"z_rms": float(np.sqrt(np.mean(z ** 2))), "z_max": float(z.max()),
            "rows_bad": bad}


def judge_pmf(exact, cards: Dict[str, int], rows: Sequence[Row], s: int
              ) -> Dict[str, float]:
    zs: List[float] = []
    bad = 0
    for got, target, evidence in rows:
        k = cards[target]
        if got is None or not np.isfinite(got).all() or got.sum() <= 0 \
                or (got < 0).any() or (got[k:] != 0).any():
            bad += 1
            continue
        pr = got[:k] / got.sum()
        p, var = exact.answer(target, evidence)
        se = np.sqrt(np.maximum(var, 1e-300) / s)
        zs.extend(np.abs(pr - p) / se)
    return _summary(zs, bad)


def judge_moments(ref: np.ndarray, s_ref: int, rows: Sequence[Row], s: int,
                  min_ess: float) -> Dict[str, float]:
    """``ref`` [R, 5]: the reference's mean, std, se(mean), se(std), ESS
    per sampled row, from ``s_ref`` particles."""
    zs: List[float] = []
    bad = unjudged = 0
    scale = np.sqrt(1.0 + s_ref / s)
    for (got, _t, _e), (m, sd, se_m, se_s, ess) in zip(rows, ref):
        if got is None or not np.isfinite(got).all() or got[1] < 0:
            bad += 1
            continue
        if ess < min_ess:
            unjudged += 1
            continue
        zs.append(abs(got[0] - m) / max(se_m * scale, 1e-300))
        zs.append(abs(got[1] - sd) / max(se_s * scale, 1e-300))
    return dict(_summary(zs, bad), rows_unjudged=unjudged)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in limits)


def sample_rows(n_rows: int, k: int, seed: int) -> np.ndarray:
    """Indices of the rows to judge, drawn from the seed."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n_rows, size=min(k, n_rows), replace=False))
