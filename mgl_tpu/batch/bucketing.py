"""Length bucketing for padded batch execution.

The reference processes one pair per JNI call (SW) or one read x all-haps
per TBB task (PairHMM).  Here we instead run padded, length-bucketed
batches (BASELINE.json config 2); this module picks bucket shapes that
bound padding waste while keeping the number of distinct compiled shapes
small (every new (T, Q) pad shape costs an XLA compile).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Sequence


def bucket_dims(n: int, grid: Sequence[int] = (64, 128, 192, 256, 384, 512, 768, 1024)) -> int:
    """Smallest grid size >= n (last grid entry caps; longer inputs get
    exact-size buckets so they still run, just without shape reuse)."""
    for g in grid:
        if n <= g:
            return g
    return n


def bucket_pairs(
    lengths_a: Sequence[int],
    lengths_b: Sequence[int],
    grid: Sequence[int] = (64, 128, 192, 256, 384, 512, 768, 1024),
    max_batch: int | None = None,
) -> list[tuple[tuple[int, int], list[int]]]:
    """Group pair indices by padded (A, B) bucket shape.

    Returns [((pad_a, pad_b), [indices...]), ...] with each group no larger
    than ``max_batch`` (None = unbounded).
    """
    groups: dict[tuple[int, int], list[int]] = defaultdict(list)
    for i, (la, lb) in enumerate(zip(lengths_a, lengths_b)):
        groups[(bucket_dims(la, grid), bucket_dims(lb, grid))].append(i)
    out = []
    for shape, idxs in sorted(groups.items()):
        if max_batch is None:
            out.append((shape, idxs))
        else:
            for k in range(0, len(idxs), max_batch):
                out.append((shape, idxs[k: k + max_batch]))
    return out
