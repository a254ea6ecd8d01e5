"""Deterministic bucket partitioner for the bucketed FSDP engine.

Counterpart of ``chainermn_tpu/parallel/buckets.py``, copied function for
function: given the same list of leaf sizes, the partition is the JAX
package's, exactly.  The leaves are a module's parameters in
registration order (``model.named_parameters()``), which is close to the
order the forward uses them in -- the order the prefetch window of
:mod:`.fsdp` wants; JAX flattens its dict tree with the keys sorted.

Design constraints:

* **deterministic across ranks by construction** -- the partition is a
  pure function of the leaf sizes in order, plus the two knobs.  Every
  rank holding the same module computes the same buckets with no
  communication.
* **layer-granular** -- buckets are contiguous runs of leaves; a leaf (one
  layer's weight or bias) is never split across buckets, so each bucket's
  all-gather completes a whole set of layers the forward can start using.
* **size-balanced** -- an adaptive-target greedy walk keeps every bucket
  within ~2x of the ideal ``total/num_buckets`` size whenever no single
  leaf exceeds the target (a bigger-than-target leaf gets its own
  oversized bucket -- it cannot be split).

Knobs: ``num_buckets`` fixes the count, ``bucket_bytes`` fixes a size
target from which the count is derived.  Both are clamped to ``[1,
n_leaves]``.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class BucketAssignment(NamedTuple):
    """One bucket of the partition: a contiguous ``[start, stop)`` slice
    of the leaf order plus its total payload bytes."""
    index: int
    start: int            # first leaf index (inclusive)
    stop: int             # last leaf index (exclusive)
    nbytes: int

    @property
    def n_leaves(self) -> int:
        return self.stop - self.start


def leaf_nbytes(leaf) -> int:
    """Payload bytes of one leaf: ``numel() * element_size()`` for a
    tensor, shape x itemsize for anything else with a shape and dtype
    (a numpy array)."""
    if torch.is_tensor(leaf):
        return leaf.numel() * leaf.element_size()
    shape = getattr(leaf, "shape", ())
    dtype = getattr(leaf, "dtype", None)
    n = 1
    for d in shape or ():
        n *= int(d)
    item = np.dtype(dtype).itemsize if dtype is not None else 4
    return n * item


def resolve_num_buckets(total_bytes: int, n_leaves: int,
                        num_buckets: Optional[int] = None,
                        bucket_bytes: Optional[int] = None) -> int:
    """Turn the (count, size-target) knob pair into a concrete count.

    ``num_buckets`` wins when both are given.  ``bucket_bytes`` derives
    ``ceil(total/bucket_bytes)``.  The result is clamped to
    ``[1, n_leaves]`` -- a leaf is never split, so there can be no more
    buckets than leaves.
    """
    if num_buckets is not None and num_buckets < 1:
        raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
    if bucket_bytes is not None and bucket_bytes < 1:
        raise ValueError(f"bucket_bytes must be >= 1, got {bucket_bytes}")
    if n_leaves == 0:
        return 1
    if num_buckets is None:
        if bucket_bytes is None:
            num_buckets = 1
        else:
            num_buckets = -(-total_bytes // bucket_bytes) if total_bytes else 1
    return max(1, min(int(num_buckets), n_leaves))


def partition_sizes(sizes: Sequence[int], num_buckets: int
                    ) -> List[Tuple[int, int]]:
    """Cut ``sizes`` into exactly ``num_buckets`` contiguous, non-empty
    ``(start, stop)`` runs with adaptive-target greedy balancing.

    The target for each bucket is recomputed from the bytes still
    unplaced (``remaining/buckets_left``), and a bucket closes once
    adding half of the next leaf would overshoot it -- the half-item rule
    that bounds every bucket by ~2x the ideal target when no single item
    exceeds it.  A bucket is also force-closed when the leaves left are
    only just enough to keep every remaining bucket non-empty.
    """
    n = len(sizes)
    num_buckets = max(1, min(num_buckets, n))
    total = sum(sizes)
    bounds: List[Tuple[int, int]] = []
    start = 0
    placed = 0
    cur = 0
    for i, s in enumerate(sizes):
        k_left = num_buckets - len(bounds)        # incl. the one being filled
        if cur and k_left > 1:
            leaves_left = n - i                   # incl. leaf i
            target = (total - placed) / k_left
            if leaves_left <= k_left - 1 or cur + 0.5 * s >= target:
                bounds.append((start, i))
                placed += cur
                start, cur = i, 0
        cur += s
    bounds.append((start, n))
    return bounds


def partition_buckets(leaves: Sequence[Any],
                      num_buckets: Optional[int] = None,
                      bucket_bytes: Optional[int] = None
                      ) -> Tuple[BucketAssignment, ...]:
    """Partition a leaf sequence into size-balanced contiguous buckets.
    Returns one :class:`BucketAssignment` per bucket, covering every leaf
    exactly once, in order."""
    sizes = [leaf_nbytes(l) for l in leaves]
    k = resolve_num_buckets(sum(sizes), len(sizes), num_buckets,
                            bucket_bytes)
    if not sizes:
        return (BucketAssignment(0, 0, 0, 0),)
    bounds = partition_sizes(sizes, k)
    return tuple(
        BucketAssignment(j, a, b, sum(sizes[a:b]))
        for j, (a, b) in enumerate(bounds))


def describe_buckets(assignments: Sequence[BucketAssignment]) -> dict:
    """Host-side summary (bench/report material): count, byte balance."""
    nbytes = [a.nbytes for a in assignments]
    total = sum(nbytes)
    return {
        "num_buckets": len(assignments),
        "total_bytes": total,
        "bucket_bytes": nbytes,
        "bucket_leaves": [a.n_leaves for a in assignments],
        "max_over_mean": (max(nbytes) * len(nbytes) / total) if total else 1.0,
    }


__all__ = [
    "BucketAssignment",
    "describe_buckets",
    "leaf_nbytes",
    "partition_buckets",
    "partition_sizes",
    "resolve_num_buckets",
]
