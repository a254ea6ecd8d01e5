"""Host-side input pipeline.

Counterpart of ``chainermn_tpu/datasets/image_pipeline.py``.  Only
:class:`PrefetchIterator` is ported so far; the image datasets and the
augmentations wait for the ImageNet data path (ROADMAP.md, Queue A6).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np


class PrefetchIterator:
    """Wrap a batch iterator; decode/augment/collate ahead in threads.

    ``inner`` yields batches of samples (what :class:`SerialIterator`
    produces: a collated tuple OR a list of per-sample tuples — both are
    handled).  ``transform`` is applied per SAMPLE in a thread pool.  Up
    to ``prefetch`` finished batches wait in a bounded queue, so the
    device step and the host input work overlap.

    The iterator protocol (``next``, ``epoch``, ``is_new_epoch``,
    ``epoch_detail``, ``iteration``) matches ``SerialIterator``; epoch
    state is captured with each produced batch and restored when that
    batch is CONSUMED, so trainer triggers fire at the right step even
    with look-ahead.  Call :meth:`close` (or let the training process
    exit — the threads are daemons) to shut down.
    """

    # the producer thread cannot rewind, so evaluation must not use it
    rewindable = False

    def __init__(self, inner, transform: Optional[Callable] = None,
                 prefetch: int = 2, workers: int = 4):
        self.inner = inner
        self.transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers))
        self._stop = threading.Event()
        self.epoch = getattr(inner, "epoch", 0)
        self.is_new_epoch = False
        self.iteration = 0
        self._epoch_detail = float(self.epoch)
        self._producer = threading.Thread(target=self._produce, daemon=True)
        self._producer.start()

    # -- producer side ------------------------------------------------------
    def _prepare(self, batch):
        if isinstance(batch, tuple):          # collated arrays -> per-sample
            samples = list(zip(*batch))
        else:
            samples = list(batch)
        if self.transform is not None:
            samples = list(self._pool.map(self.transform, samples))
        first = samples[0]
        if isinstance(first, tuple):
            return tuple(np.stack([s[i] for s in samples])
                         for i in range(len(first)))
        return np.stack(samples)

    def _produce(self):
        try:
            while not self._stop.is_set():
                try:
                    batch = self.inner.next()
                except StopIteration:
                    self._q.put(("stop", None, None))
                    return
                meta = (getattr(self.inner, "epoch", 0),
                        getattr(self.inner, "is_new_epoch", False),
                        getattr(self.inner, "epoch_detail", 0.0))
                out = self._prepare(batch)
                self._q.put(("batch", out, meta))
        except Exception as e:  # surface worker errors at the consumer
            self._q.put(("error", e, None))

    # -- consumer side ------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        kind, payload, meta = self._q.get()
        if kind == "stop":
            raise StopIteration
        if kind == "error":
            self.close()
            raise payload
        self.epoch, self.is_new_epoch, self._epoch_detail = meta
        self.iteration += 1
        return payload

    next = __next__

    @property
    def epoch_detail(self):
        return self._epoch_detail

    def reset(self):
        raise NotImplementedError(
            "PrefetchIterator cannot rewind its producer; create a new one")

    def close(self):
        self._stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._pool.shutdown(wait=False)


__all__ = ["PrefetchIterator"]
