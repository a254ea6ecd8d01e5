"""Multi-node iterators.

Counterpart of ``chainermn_tpu/iterators/multi_node_iterator.py`` (the
reference's ``create_multi_node_iterator``): the master rank iterates the
real dataset and sends each batch to every other rank, whose iterator only
receives -- for a dataset that cannot be scattered.
``create_synchronized_iterator`` instead gives every rank the master's
random seed, so every rank draws the same batches itself.

The batches ride the communicator's object plane: ``send_obj`` from the
master to each rank, ``recv_obj`` on the others, under one tag (the JAX
package broadcasts them; the values are the same).
"""

from __future__ import annotations

import numpy as np

# the object-plane tag of the batches
TAG = 700


class _MasterIterator:
    def __init__(self, iterator, comm, rank_master: int, tag: int = TAG):
        self._it = iterator
        self._comm = comm
        self._master = rank_master
        self._tag = tag

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = self._it.next()
            payload = ("batch", batch, self._it.epoch, self._it.is_new_epoch)
        except StopIteration:
            payload = ("stop", None, self._it.epoch, False)
        for r in range(self._comm.size):
            if r != self._master:
                self._comm.send_obj(payload, r, tag=self._tag)
        if payload[0] == "stop":
            raise StopIteration
        return batch

    next = __next__

    def __getattr__(self, name):
        return getattr(self._it, name)


class _SlaveIterator:
    def __init__(self, comm, rank_master: int, tag: int = TAG):
        self._comm = comm
        self._master = rank_master
        self._tag = tag
        self.epoch = 0
        self.is_new_epoch = False

    def __iter__(self):
        return self

    def __next__(self):
        kind, batch, epoch, new_epoch = self._comm.recv_obj(
            self._master, tag=self._tag)
        self.epoch = epoch
        self.is_new_epoch = new_epoch
        if kind == "stop":
            raise StopIteration
        return batch

    next = __next__


def create_multi_node_iterator(actual_iterator, communicator,
                               rank_master: int = 0):
    """The master's batches on every rank.  On the master pass the real
    iterator; the other ranks may pass None."""
    if communicator.rank == rank_master:
        return _MasterIterator(actual_iterator, communicator, rank_master)
    return _SlaveIterator(communicator, rank_master)


def create_synchronized_iterator(actual_iterator, communicator):
    """Give ``actual_iterator`` rank 0's random seed (drawn from numpy's
    global generator there) and rewind it, so every rank draws the same
    batch order."""
    seed = None
    if communicator.rank == 0:
        seed = int(np.random.randint(0, 2**31 - 1))
    seed = communicator.bcast_obj(seed, root=0)
    if not hasattr(actual_iterator, "_rng"):
        raise TypeError(
            f"{type(actual_iterator).__name__} exposes no _rng to "
            "synchronize; use SerialIterator or synchronize it with the "
            "broadcast seed yourself")
    actual_iterator._rng = np.random.RandomState(seed)
    if hasattr(actual_iterator, "reset"):
        actual_iterator.reset()
    return actual_iterator


__all__ = ["create_multi_node_iterator", "create_synchronized_iterator"]
