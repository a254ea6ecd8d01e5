"""Abstract communicator API.

Counterpart of ``chainermn_tpu/communicators/communicator_base.py`` (the
reference's ``CommunicatorBase``).  In the JAX package one controller
process drives many devices and array collectives are traced ops over a
mesh; here one process drives one GPU, as in the reference, so ``rank`` and
``size`` count processes and every collective is an eager call on this
process's tensors.

``allreduce_grad`` takes a module (its parameters' ``.grad`` are replaced
in place, the reference's ``allreduce_grad(model)``) or a tree of
gradient tensors (a new tree is returned, the JAX package's functional
form).  ``bcast_data`` likewise takes a module or a tree.
"""

from __future__ import annotations

import abc
from typing import Any, List

import torch


class CommunicatorBase(abc.ABC):
    # ---- topology (the reference's rank properties) ------------------------
    @property
    @abc.abstractmethod
    def rank(self) -> int: ...

    @property
    @abc.abstractmethod
    def size(self) -> int:
        """Number of processes (one GPU each) — the gradient-averaging
        denominator."""

    @property
    @abc.abstractmethod
    def intra_rank(self) -> int: ...

    @property
    @abc.abstractmethod
    def intra_size(self) -> int: ...

    @property
    @abc.abstractmethod
    def inter_rank(self) -> int: ...

    @property
    @abc.abstractmethod
    def inter_size(self) -> int: ...

    @property
    @abc.abstractmethod
    def device(self) -> torch.device:
        """The device this process's tensors live on."""

    # ---- object plane (pickled Python objects) -----------------------------
    @abc.abstractmethod
    def bcast_obj(self, obj: Any, root: int = 0) -> Any: ...

    @abc.abstractmethod
    def allgather_obj(self, obj: Any) -> List[Any]: ...

    @abc.abstractmethod
    def allreduce_obj(self, obj: Any, op="sum") -> Any: ...

    # ---- tensor collectives ------------------------------------------------
    @abc.abstractmethod
    def allreduce(self, x, op: str = "sum"): ...

    @abc.abstractmethod
    def bcast(self, x, root: int = 0): ...

    # ---- gradient entry points (the hot path) ------------------------------
    @abc.abstractmethod
    def allreduce_grad(self, grads): ...

    @abc.abstractmethod
    def bcast_data(self, params): ...

    # ---- sub-communicators -------------------------------------------------
    @abc.abstractmethod
    def split(self, color: int, key: int) -> "CommunicatorBase": ...
