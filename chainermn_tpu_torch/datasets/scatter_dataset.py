"""Dataset scattering across ranks.

Counterpart of ``chainermn_tpu/datasets/scatter_dataset.py`` (the
reference's ``scatter_dataset``): rank ``root`` decides the seed, every
rank derives the same permutation from it and takes its own contiguous,
equal-length slice.  Only the seed crosses the wire.  The shards are a
pure function of (seed, len(dataset), rank, size), bit-identical to the
JAX package's for the same world (there a world is one controller per
host; here one process per GPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class TupleDataset:
    """Minimal dataset over parallel arrays (the Chainer TupleDataset role)."""

    def __init__(self, *arrays):
        n = len(arrays[0])
        for a in arrays:
            if len(a) != n:
                raise ValueError("all arrays must share their first dimension")
        self._arrays = arrays

    def __len__(self):
        return len(self._arrays[0])

    def __getitem__(self, i):
        return tuple(a[i] for a in self._arrays)


class SubDataset:
    """A view of ``dataset`` through an index array."""

    def __init__(self, dataset, indices: np.ndarray):
        self._dataset = dataset
        self._indices = np.asarray(indices)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        return self._dataset[int(self._indices[i])]

    @property
    def indices(self) -> np.ndarray:
        return self._indices


def _rank_slice(order: np.ndarray, rank: int, size: int,
                force_equal_length: bool) -> np.ndarray:
    n = len(order)
    per = -(-n // size)  # ceil
    if force_equal_length:
        # pad by wrapping, so every rank runs the same number of
        # iterations per epoch (np.resize repeats cyclically)
        padded = np.resize(order, per * size)
        return padded[rank * per:(rank + 1) * per]
    return order[min(rank * per, n): min((rank + 1) * per, n)]


def scatter_index(n_total: int, comm, *, force_equal_length: bool = True):
    """This rank's share of ``range(n_total)``."""
    return _rank_slice(np.arange(n_total), comm.rank, comm.size,
                       force_equal_length)


def scatter_dataset(dataset, comm, shuffle: bool = False,
                    seed: Optional[int] = None,
                    force_equal_length: bool = True,
                    root: int = 0) -> SubDataset:
    """Shard ``dataset`` over the communicator's ranks (reference
    signature: ``scatter_dataset(dataset, comm, root=0, shuffle=False,
    seed=None)``)."""
    if comm.rank == root and shuffle and seed is None:
        seed = int(np.random.randint(0, 2**31 - 1))
    seed = comm.bcast_obj(seed, root=root)
    n = len(dataset)
    order = (np.random.RandomState(seed).permutation(n) if shuffle
             else np.arange(n))
    return SubDataset(dataset, _rank_slice(order, comm.rank, comm.size,
                                           force_equal_length))
