"""The port's dataset scattering and iterator order against the JAX package's.

Both are numpy-only, so shards and batch orders must be bit-identical for
the same seed and world (a JAX world is one controller per host; a port
world is one process per GPU): world sizes 1, 2 and 3.
"""

import numpy as np
import pytest

from chainermn_tpu.datasets import scatter_dataset as jsd
from chainermn_tpu.iterators import SerialIterator as JIter
from chainermn_tpu_torch.datasets import scatter_dataset as tsd
from chainermn_tpu_torch.iterators import SerialIterator as TIter


class _World:
    """The part of a communicator that scatter_dataset reads."""

    def __init__(self, rank, size):
        self.rank, self.size, self.host_size = rank, size, size

    def bcast_obj(self, obj, root=0):
        return obj


def _dataset(n=23):
    from chainermn_tpu_torch.datasets import TupleDataset
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    return TupleDataset(x, np.arange(n, dtype=np.int32))


@pytest.mark.parametrize("size", [1, 2, 3])
@pytest.mark.parametrize("shuffle,force_equal",
                         [(True, True), (False, True), (True, False)])
def test_scatter_dataset_shards_are_identical(size, shuffle, force_equal):
    ds = _dataset()
    for rank in range(size):
        w = _World(rank, size)
        got = tsd(ds, w, shuffle=shuffle, seed=7,
                  force_equal_length=force_equal)
        want = jsd(ds, w, shuffle=shuffle, seed=7,
                   force_equal_length=force_equal)
        np.testing.assert_array_equal(got.indices, want.indices)
        assert [got[i][1] for i in range(len(got))] == \
            [want[i][1] for i in range(len(want))]


@pytest.mark.parametrize("size", [1, 2, 3])
def test_serial_iterator_order_is_identical(size):
    ds = tsd(_dataset(), _World(size - 1, size), shuffle=True, seed=3)
    t, j = TIter(ds, 4, seed=11), JIter(ds, 4, seed=11)
    for _ in range(15):  # several epochs, with wrapped batches
        tb, jb = t.next(), j.next()
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b)
        assert (t.epoch, t.is_new_epoch, t.epoch_detail) == \
            (j.epoch, j.is_new_epoch, j.epoch_detail)


def test_serial_iterator_without_repeat_stops_like_jax():
    ds = _dataset(10)
    t = TIter(ds, 4, repeat=False, shuffle=False)
    j = JIter(ds, 4, repeat=False, shuffle=False)
    got = [b[1].tolist() for b in t]
    want = [b[1].tolist() for b in j]
    assert got == want == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
