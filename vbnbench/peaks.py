"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at the full
700 W power limit; a card set lower runs slower, so every run prints the
card's ``power.limit`` beside the shares it reports).

``least_ms(work)`` is the least time the chip could take for a count of
work: the largest of float32 and integer operations outside the tensor
cores, special-function results (exp, log, sqrt, cos), multiply-add
flops the TF32 tensor cores could take, and bytes of HBM traffic, each
over its peak. These units run side by side, so the bound is the largest
of the four, not their sum.
"""

from __future__ import annotations

from typing import Dict

PEAK_OPS = 67e12  # float32 operations outside the tensor cores, /s
PEAK_SFU = 132 * 16 * 1.98e9  # special-function results: 132 SMs x 16 a clock
PEAK_TF32 = 495e12  # dense TF32 on the tensor cores, flop/s
PEAK_BYTES = 3.35e12  # HBM3, byte/s


def least_ms(work: Dict[str, float]) -> float:
    return 1e3 * max(work.get("ops", 0.0) / PEAK_OPS,
                     work.get("sfu", 0.0) / PEAK_SFU,
                     work.get("tc", 0.0) / PEAK_TF32,
                     work.get("bytes", 0.0) / PEAK_BYTES)
