"""Inclusive row cumsum on a hand-written CUDA kernel.

Port of ``vectorizedbayesiannetwork_tpu/ops/scan_pallas.py``. The CUDA
kernel ``vbn_cumsum`` (``csrc/resample.cu``) replaces
``scan_pallas.py:33 _cumsum_kernel``: a deterministic reduce-then-scan over
tiles of 8192 entries, a block a tile (the TPU kernel carried the running
total in SMEM across a sequential grid); the wrapper allocates the [B,
tiles] scratch of the tiles' totals. With ``monotone=True`` an exact
running max makes each row nondecreasing, which the merge kernels
(``ops/resample_merge.py``) need of a CDF. The kernel is bound by bytes
(one read and one write of the array); the source note says what its
design does about that.

``cumsum_rows`` launches the kernel for a CUDA tensor and raises on what it
does not take; for a CPU tensor it runs the plain version
``cumsum_rows_plain`` (``torch.cumsum``, then ``torch.cummax`` when
monotone). On weights that are multiples of 2^-23 summing to at most 2
every grouping of the sums is exact, so there the kernel equals the plain
version bit for bit; elsewhere they differ in the last bits of a sum. The
kernel's grouping does not depend on timing, so a launch repeated on the
same input gives the same bits.
``LAUNCHES["cumsum"]`` (``ops/_launch.py``) counts the launches.

Not ported: ``cumsum_available`` and its ``VBN_CUMSUM_PALLAS`` flag, which
chose the kernel by backend; here the tensor's device chooses.
"""

from __future__ import annotations

import torch

from ..utils.profiling import spanned
from ._build import load
from ._launch import check, launch


def cumsum_rows_plain(x: torch.Tensor, monotone: bool = False) -> torch.Tensor:
    """Inclusive cumsum along axis 1 of a [B, S] array, in float32; with
    ``monotone``, its running max (nondecreasing rows)."""
    c = torch.cumsum(x.float(), dim=1)
    return torch.cummax(c, dim=1).values if monotone else c


@spanned("vbn.kernel.cumsum")
def _launch_cumsum(x: torch.Tensor, monotone: bool) -> torch.Tensor:
    if x.dim() != 2:
        raise ValueError(f"cumsum_rows: expected a [B, S] tensor, got "
                         f"{tuple(x.shape)}")
    b, s = x.shape
    check(x, "cumsum_rows x", torch.float32, (b, s), x.device)
    if b < 1 or s < 1:
        raise ValueError(f"cumsum_rows: empty array {tuple(x.shape)}")
    out = torch.empty_like(x)
    part = torch.empty((b, load("resample").vbn_cumsum_scratch(s)),
                       dtype=torch.float32,
                       device=x.device)  # the tiles' totals and maxima
    launch("resample", "vbn_cumsum", x.data_ptr(), out.data_ptr(), b, s,
           int(monotone), part.data_ptr(), device=x.device, key="cumsum")
    return out


def cumsum_rows(x: torch.Tensor, monotone: bool = False) -> torch.Tensor:
    """Inclusive cumsum along axis 1 (float32). CUDA tensors launch
    ``vbn_cumsum``; CPU tensors run ``cumsum_rows_plain``."""
    if x.is_cuda:
        return _launch_cumsum(x, monotone)
    return cumsum_rows_plain(x, monotone)
