"""Batch iterator (the Chainer ``SerialIterator`` role).

Counterpart of ``chainermn_tpu/iterators/serial_iterator.py``: the same
order for the same seed, batches kept full across an epoch boundary, and
numpy batches out (the updater moves them to the device).  Checkpointable
state is not ported yet (ROADMAP.md, Queue A4).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SerialIterator:
    def __init__(self, dataset, batch_size: int, *, repeat: bool = True,
                 shuffle: bool = True, seed: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self.epoch = 0
        self.iteration = 0
        self.is_new_epoch = False
        self._order = self._new_order()
        self._pos = 0

    def _new_order(self):
        n = len(self.dataset)
        return self._rng.permutation(n) if self._shuffle else np.arange(n)

    def reset(self):
        self.epoch = 0
        self.iteration = 0
        self.is_new_epoch = False
        self._order = self._new_order()
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        n = len(self.dataset)
        if self._pos >= n:
            if not self._repeat:
                raise StopIteration
            self.epoch += 1
            self._order = self._new_order()
            self._pos = 0
        start, end = self._pos, min(self._pos + self.batch_size, n)
        idx = self._order[start:end]
        if len(idx) < self.batch_size and self._repeat:
            # wrap to keep batches full
            extra = self._order[: self.batch_size - len(idx)]
            idx = np.concatenate([idx, extra])
            self.epoch += 1
            self._order = self._new_order()
            self._pos = 0
            self.is_new_epoch = True
        elif end >= n and self._repeat:
            # exact epoch boundary: advance the epoch now
            self.is_new_epoch = True
            self.epoch += 1
            self._order = self._new_order()
            self._pos = 0
        else:
            self.is_new_epoch = end >= n
            self._pos = end
        self.iteration += 1
        return _collate([self.dataset[int(i)] for i in idx])

    next = __next__

    @property
    def epoch_detail(self):
        return self.epoch + self._pos / max(len(self.dataset), 1)


def _collate(examples):
    first = examples[0]
    if isinstance(first, tuple):
        return tuple(np.stack([e[i] for e in examples])
                     for i in range(len(first)))
    return np.stack(examples)
