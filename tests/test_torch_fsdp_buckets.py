"""The port's bucket partitioner (``chainermn_tpu_torch/parallel/
buckets.py``) against the JAX package's, exactly: the same cut of the same
list of leaf sizes, the same resolved bucket count, the same summary.
No process is spawned."""

import numpy as np
import pytest
import torch

from chainermn_tpu.parallel import buckets as jb
from chainermn_tpu_torch.parallel import buckets as tb


def _sizes(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 40))
    # a mix of small biases and large kernels, as a model's leaves are
    return [int(v) for v in np.where(rng.rand(n) < 0.4,
                                     rng.randint(1, 64, n) * 4,
                                     rng.randint(1, 4096, n) * 4)]


@pytest.mark.parametrize("seed", range(12))
def test_partition_equals_jax(seed):
    sizes = _sizes(seed)
    for k in (1, 2, 3, 4, 7, 8, 64):
        assert tb.partition_sizes(sizes, k) == jb.partition_sizes(sizes, k)
    leaves = [np.zeros(s // 4, np.float32) for s in sizes]
    for kw in ({"num_buckets": 4}, {"bucket_bytes": sum(sizes) // 3 + 1},
               {"num_buckets": 2, "bucket_bytes": 7}, {}):
        got = tb.partition_buckets(leaves, **kw)
        want = jb.partition_buckets(leaves, **kw)
        assert [tuple(a) for a in got] == [tuple(a) for a in want]
        assert tb.describe_buckets(got) == jb.describe_buckets(want)


@pytest.mark.parametrize("seed", range(6))
def test_resolve_num_buckets_equals_jax(seed):
    rng = np.random.RandomState(100 + seed)
    total, n = int(rng.randint(0, 10 ** 6)), int(rng.randint(0, 50))
    for nb in (None, 1, 3, 1000):
        for bb in (None, 1, int(rng.randint(1, 10 ** 5))):
            assert tb.resolve_num_buckets(total, n, nb, bb) == \
                jb.resolve_num_buckets(total, n, nb, bb)


def test_tensor_leaves_count_their_bytes():
    """``leaf_nbytes`` reads ``numel() * element_size()`` of a tensor: a
    module's parameters cut as their numpy twins."""
    ts = [torch.zeros(3, 5), torch.zeros(7, dtype=torch.bfloat16),
          torch.zeros(2, 2, dtype=torch.float16), torch.zeros(11)]
    assert [tb.leaf_nbytes(t) for t in ts] == [60, 14, 8, 44]
    want = jb.partition_buckets(
        [np.zeros(t.numel(), np.float32 if t.element_size() == 4
                  else np.float16) for t in ts], num_buckets=2)
    assert [tuple(a) for a in tb.partition_buckets(ts, num_buckets=2)] \
        == [tuple(a) for a in want]


def test_knob_refusals_match_jax():
    for kw in ({"num_buckets": 0}, {"bucket_bytes": 0}):
        with pytest.raises(ValueError, match="must be >= 1"):
            tb.resolve_num_buckets(10, 3, **kw)
    assert tb.partition_buckets([]) == jb.partition_buckets([])
