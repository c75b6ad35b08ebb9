"""What a ring all-reduce must move over the links of four H100s of one
host, and the least time it can take there.

In a ring all-reduce of S bytes over n ranks each rank sends, and receives,
2 (n - 1) / n * S bytes: n - 1 chunks of S / n in the reduce-scatter, as
many in the all-gather. Each card's NVLink 4 moves 450 GB/s in each
direction (H100 SXM data sheet: 900 GB/s in all, 18 links), so the bound
is that traffic at 450 GB/s.
"""

from __future__ import annotations

import bisect

NVLINK_BYTES_PER_S = 450e9  # one H100 SXM card's NVLink 4, one direction


def ring_bytes(nbytes: float, n: int) -> float:
    """Bytes each rank sends in a ring all-reduce of ``nbytes`` over ``n``
    ranks."""
    return 2.0 * (n - 1) / n * nbytes


def bound_s(nbytes: float, n: int) -> float:
    """The least time of a ring all-reduce of ``nbytes`` over ``n`` ranks."""
    return ring_bytes(nbytes, n) / NVLINK_BYTES_PER_S


def kernel_s_in(run, spans, needle: str = "AllReduce") -> float:
    """Device seconds of the traced kernels whose name holds ``needle`` and
    that start inside one of ``spans`` ((start, end) in the trace's
    microseconds, sorted and apart)."""
    starts = [s for s, _ in spans]
    total = 0.0
    for s, e, name in run.device_trace["kernels"]:
        i = bisect.bisect_right(starts, s) - 1
        if needle in name and i >= 0 and s < spans[i][1]:
            total += e - s
    return total * 1e-6
