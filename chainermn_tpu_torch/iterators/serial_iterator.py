"""Batch iterator (the Chainer ``SerialIterator`` role).

Counterpart of ``chainermn_tpu/iterators/serial_iterator.py``: the same
order for the same seed, batches kept full across an epoch boundary,
numpy batches out (the updater moves them to the device; ``collate=False``
yields the examples as a list, for a per-sample transform downstream), and
the same
checkpointable state (``state_dict``/``load_state_dict``: position, epoch
bookkeeping, order and the MT19937 state, taken under a lock that
``next`` also holds).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class SerialIterator:
    def __init__(self, dataset, batch_size: int, *, repeat: bool = True,
                 shuffle: bool = True, seed: Optional[int] = None,
                 collate: bool = True):
        self.dataset = dataset
        self._collate = collate
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self.epoch = 0
        self.iteration = 0
        self.is_new_epoch = False
        self._order = self._new_order()
        self._pos = 0
        # next() against state_dict(): a prefetching thread may draw while
        # a snapshot reads the state
        self._state_lock = threading.Lock()

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
        with self._state_lock:
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
        examples = [self.dataset[int(i)] for i in idx]
        return _collate(examples) if self._collate else examples

    next = __next__

    @property
    def epoch_detail(self):
        return self.epoch + self._pos / max(len(self.dataset), 1)

    def state_dict(self) -> dict:
        """Position, epoch bookkeeping, order and random state as a flat
        dict of numpy arrays (the JAX iterator's keys)."""
        with self._state_lock:
            keys, pos, has_gauss, cached = self._rng.get_state()[1:]
            return {
                "epoch": np.int64(self.epoch),
                "iteration": np.int64(self.iteration),
                "is_new_epoch": np.int64(self.is_new_epoch),
                "pos": np.int64(self._pos),
                "order": np.asarray(self._order, np.int64),
                "rng_keys": np.asarray(keys, np.uint32),
                "rng_pos": np.int64(pos),
                "rng_has_gauss": np.int64(has_gauss),
                "rng_cached": np.float64(cached),
            }

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict` output: the next batch is the one the
        saved iterator would have drawn."""
        state = {k: np.asarray(v) for k, v in state.items()}
        order = state["order"]
        if len(order) != len(self.dataset):
            raise ValueError(
                f"iterator state is for a {len(order)}-example dataset; "
                f"this iterator has {len(self.dataset)} examples")
        with self._state_lock:
            self.epoch = int(state["epoch"])
            self.iteration = int(state["iteration"])
            self.is_new_epoch = bool(int(state["is_new_epoch"]))
            self._pos = int(state["pos"])
            self._order = order.astype(np.int64)
            self._rng.set_state((
                "MT19937", state["rng_keys"].astype(np.uint32),
                int(state["rng_pos"]), int(state["rng_has_gauss"]),
                float(state["rng_cached"])))


def _collate(examples):
    first = examples[0]
    if isinstance(first, tuple):
        return tuple(np.stack([e[i] for e in examples])
                     for i in range(len(first)))
    return np.stack(examples)
