"""Model-parallel chain composition.

Counterpart of ``chainermn_tpu/links/multi_node_chain_list.py`` (the
reference's ``MultiNodeChainList``): register stages with
``add_link(module, rank_in, rank_out)``; a call receives each stage's
inputs from ``rank_in``, runs the stage, and sends its output to
``rank_out``; multi-input and multi-output stages and repeated ``(src,
dst)`` pairs are allowed; one ``backward()`` a process spans every stage.

One process a GPU, as the reference deployed: stage ``s`` runs on rank
``s % comm.size`` of the communicator unless pinned with ``process=``
(every rank registers the same stages and pins).  A boundary between two
stages of one rank is the in-process channel (:func:`functions.send` /
:func:`functions.recv`: nothing is copied); a boundary between ranks is
:func:`functions.cross_send` / :func:`functions.cross_recv` over the
communicator's process group (NCCL on the card), whose backwards ship the
cotangent the other way.  In a world of one every stage is local, which is
the JAX package's single-controller case.  A call returns the outputs on a
rank that owns an exit stage (``rank_out=None``), tied to its cross-rank
sends with :func:`functions.pseudo_connect`; the delegate elsewhere (pass
it to :func:`pseudo_loss` and call ``backward()``); ``None`` on a rank that
owns no stage.

Where torch differs from JAX:

* torch modules own their parameters, so stages are built ``nn.Module``s
  (JAX's ``init`` traces flax ``init``).  A rank that does not own a stage
  may register a zero-argument callable that builds it instead, called only
  on the owner, so a remote stage's parameters are never allocated;
  :meth:`stage` gives the module, or ``None`` on other ranks.
* the transfers between two ranks match by the order both ends issue them
  (NCCL has no tags), so before its first transfer a call checks that every
  pair of ranks issues its transfers in the same order, and raises
  ``RuntimeError`` naming the first two that differ.  The JAX package's
  packed tags (:meth:`_cross_tag`) still name each channel's handshake.
* JAX shards a stage's activations over the stage's device group
  (``STAGE_DP_AXIS``); with one GPU a process a stage runs on its rank's
  device, and :meth:`place_activation` is a ``.to(device)``.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
from torch import nn

from chainermn_tpu_torch import functions as F
from chainermn_tpu_torch.communicators._packing import tree_flatten, tree_map
from chainermn_tpu_torch.functions.point_to_point_communication import (
    _channels)

Ranks = Union[int, Sequence[int], None]

_instance_counter = itertools.count()
# Cross-process chains pack their instance into the tags of their channels;
# counted separately so ordinary single-process instances don't use it up.
_cross_instance_counter = itertools.count()
_MAX_CROSS_INSTANCES = 32


def _as_list(ranks: Ranks) -> List[int]:
    return list(ranks) if isinstance(ranks, (list, tuple)) else [ranks]


def pseudo_loss(out) -> torch.Tensor:
    """Scalar pseudo-loss of what a call returns on a rank without the exit
    stage (the reference's "call backward() on the delegate variable"):
    0.0, but its backward reaches every cross-rank send of this rank.  A
    rank that owns no stage gets a zero that requires grad, so that
    ``pseudo_loss(out).backward()`` runs everywhere."""
    leaves = [l for l in tree_flatten(out)[0]
              if isinstance(l, torch.Tensor) and l.is_floating_point()]
    if not leaves:
        return torch.zeros((), requires_grad=True)
    acc = leaves[0].sum().float()
    for l in leaves[1:]:
        acc = acc + l.sum().float()
    return acc


class MultiNodeChainList:
    def __init__(self, comm, n_stages: Optional[int] = None):
        """``n_stages`` is accepted for the JAX signature (a hint there,
        unused here)."""
        del n_stages
        self._comm = comm
        self._links: List[tuple] = []  # (module, rank_in, rank_out)
        # explicit rank pin per stage (None = round-robin)
        self._stage_proc: List[Optional[int]] = []
        self._checked_order = None
        # Private tag namespace of the in-process channels: several chain
        # lists (or raw F.send/F.recv, tag 0) may share one communicator.
        self._tag = 1 + next(_instance_counter)
        if self._n_procs > 1:
            self._cross_base = next(_cross_instance_counter)
            if self._cross_base >= _MAX_CROSS_INSTANCES:
                raise RuntimeError(
                    f"more than {_MAX_CROSS_INSTANCES} cross-process "
                    "MultiNodeChainList instances in one process; the packed "
                    "tag namespace is exhausted")

    # -- placement ----------------------------------------------------------
    @property
    def _n_procs(self) -> int:
        return int(self._comm.size)

    def stage_owner(self, s: int) -> int:
        """Rank that runs stage ``s``: the ``process=`` pin from
        :meth:`add_link` when given, else registration order mod world."""
        if not 0 <= s < len(self._stage_proc):
            raise ValueError(
                f"stage reference {s} is out of range: this chain has "
                f"{len(self._stage_proc)} registered stage(s) — check the "
                f"rank_in/rank_out values passed to add_link")
        pin = self._stage_proc[s]
        return (s % self._n_procs) if pin is None else pin

    def is_local_stage(self, s: int) -> bool:
        return self._n_procs == 1 or self.stage_owner(s) == self._comm.rank

    @property
    def owns_output(self) -> bool:
        """True when this rank runs an exit stage (``rank_out=None``):
        a call returns real outputs here, a delegate elsewhere."""
        return any(self.is_local_stage(s)
                   for s, (_, _, rout) in enumerate(self._links)
                   if rout is None)

    def _cross_tag(self, src: int, dst: int, occ: int) -> int:
        if src >= 32 or dst >= 32 or occ >= 32:
            raise ValueError("cross-process chains support at most 32 "
                             "stages and 32 sends per stage pair")
        return ((self._cross_base % _MAX_CROSS_INSTANCES) << 15
                | src << 10 | dst << 5 | occ)

    # -- registration -------------------------------------------------------
    def add_link(self, module, rank_in: Ranks = None, rank_out: Ranks = None,
                 process: Optional[int] = None):
        """Reference signature: ``add_link(chain, rank_in=..., rank_out=...)``;
        the stage's index is its registration order.  ``module`` is the
        stage's ``nn.Module``, or a zero-argument callable that builds it
        (called only on the rank that runs the stage).  ``process`` pins
        the stage to a rank (default: ``stage % comm.size``)."""
        if process is not None and not 0 <= process < self._n_procs:
            raise ValueError(
                f"add_link(process={process}) out of range: this "
                f"communicator spans {self._n_procs} process(es)")
        self._stage_proc.append(process)
        if not isinstance(module, nn.Module) and callable(module):
            module = module() if self.is_local_stage(len(self._links)) \
                else None
        self._links.append((module, rank_in, rank_out))
        self._checked_order = None
        return self

    @property
    def n_stages(self) -> int:
        return len(self._links)

    def stage(self, s: int) -> Optional[nn.Module]:
        """Stage ``s``'s module (``None`` where a callable built it on
        another rank)."""
        return self._links[s][0]

    @property
    def local_stages(self) -> List[Optional[nn.Module]]:
        """Every stage's module where this rank runs it, else ``None``
        (the layout of JAX's ``params_list``)."""
        return [m if self.is_local_stage(s) else None
                for s, (m, _, _) in enumerate(self._links)]

    def parameters(self):
        """The parameters of this rank's stages."""
        for m in self.local_stages:
            if m is not None:
                yield from m.parameters()

    @property
    def device(self) -> torch.device:
        return self._comm.device

    def place_activation(self, x, stage: int):
        """``x`` (a tensor or a tree of them) on ``stage``'s device, for
        driving a stage's module outside a call (the seq2seq example's
        greedy decoding)."""
        if not self.is_local_stage(stage):
            raise ValueError(
                f"stage {stage} is owned by rank {self.stage_owner(stage)}, "
                f"not this rank ({self._comm.rank})")
        dev = self._comm.device
        return tree_map(lambda a: a.to(dev) if isinstance(a, torch.Tensor)
                        else torch.as_tensor(a, device=dev), x)

    # -- forward ------------------------------------------------------------
    def __call__(self, *inputs, stage_inputs: Optional[dict] = None):
        """The composed forward.  ``inputs`` feed the stages with
        ``rank_in=None`` (all of them to the one entry stage, else one
        each); ``stage_inputs[s]`` adds local tensors to stage ``s``'s
        arguments (e.g. the decoder's targets)."""
        return self._run(inputs, stage_inputs or {})

    apply = __call__

    def traced(self) -> Callable:
        """``fn(*inputs, stage_inputs=None)``: the same composition as plain
        value flow (each boundary a direct data dependency, no channel), in
        a world of one.  Its values and gradients are the call's."""
        if self._n_procs > 1:
            raise ValueError(
                "traced() is single-process only; cross-process chains "
                "need the call (their boundaries are transfers)")
        links = list(self._links)
        entry_stages = [s for s, (_, rin, _) in enumerate(links)
                        if rin is None]

        def fn(*inputs, stage_inputs=None):
            stage_inputs = stage_inputs or {}
            slots: dict = {}
            outputs = []
            for s, (mod, rank_in, rank_out) in enumerate(links):
                received: List[Any] = []
                if rank_in is None:
                    if inputs:
                        if len(entry_stages) == 1:
                            received.extend(inputs)
                        else:
                            received.append(inputs[entry_stages.index(s)])
                else:
                    for r in _as_list(rank_in):
                        received.append(slots[(r, s)].pop(0))
                received.extend(stage_inputs.get(s, ()))
                y = mod(*received)
                if rank_out is None:
                    outputs.append(y)
                else:
                    for r in _as_list(rank_out):
                        slots.setdefault((s, r), []).append(y)
            leftovers = [k for k, q in slots.items() if q]
            if leftovers:
                raise RuntimeError(
                    f"unconsumed sends on edges {leftovers}: some rank_out "
                    "has no matching rank_in consumer in this chain list")
            return outputs[0] if len(outputs) == 1 else tuple(outputs)

        return fn

    # -- the order of the transfers between ranks ---------------------------
    def _issue_order(self, rank: int) -> dict:
        """``{peer: [(direction, (src, dst, occ)), ...]}``: the cross-rank
        transfers ``rank`` issues, in its order (registration order)."""
        order: dict = {}
        occ: dict = {}
        for s, (_, rank_in, rank_out) in enumerate(self._links):
            if self.stage_owner(s) != rank:
                continue
            ends = ([] if rank_in is None else
                    [("recv", r, s) for r in _as_list(rank_in)])
            ends += ([] if rank_out is None else
                     [("send", s, r) for r in _as_list(rank_out)])
            for kind, a, b in ends:
                peer = self.stage_owner(a if kind == "recv" else b)
                if peer == rank:
                    continue
                n = occ[(kind, a, b)] = occ.get((kind, a, b), -1) + 1
                order.setdefault(peer, []).append((kind, (a, b, n)))
        return order

    def _check_order(self) -> None:
        """Raise unless every peer of this rank issues their transfers in
        this rank's order (sends matched with recvs)."""
        if self._checked_order == self.n_stages:
            return
        me = self._comm.rank
        flip = {"send": "recv", "recv": "send"}

        def name(t):
            return "nothing" if t is None else \
                f"{t[0]} {t[1][:2]} (tag {self._cross_tag(*t[1])})"

        for peer, mine in self._issue_order(me).items():
            theirs = [(flip[k], key)
                      for k, key in self._issue_order(peer).get(me, [])]
            for i, (a, b) in enumerate(itertools.zip_longest(mine, theirs)):
                if a != b:
                    raise RuntimeError(
                        f"rank {me} and rank {peer} would issue their "
                        f"transfers in different orders: transfer {i} is "
                        f"{name(a)} on rank {me} but the counterpart of "
                        f"{name(b)} on rank {peer}; transfers between two "
                        "ranks match by issue order (NCCL has no tags), so "
                        "no two of them may cross in registration order")
        self._checked_order = self.n_stages

    def _run(self, inputs, stage_inputs):
        # Fresh composition: a previous call that raised mid-flight must
        # not leak stale activations into this one.  Only this instance's
        # tag namespace is cleared.
        channels = _channels(self._comm)
        for k in [k for k in channels.slots if k[2] == self._tag]:
            del channels.slots[k]
        if self._n_procs > 1:
            self._check_order()

        entry_stages = [s for s, (_, rin, _) in enumerate(self._links)
                        if rin is None]
        if len(entry_stages) > 1 and inputs and \
                len(inputs) != len(entry_stages):
            raise ValueError(
                f"{len(entry_stages)} entry stages but {len(inputs)} inputs; "
                "with multiple rank_in=None stages pass exactly one input per "
                "entry stage (or use stage_inputs)")

        outputs = []
        cross_delegates: List[torch.Tensor] = []
        # Occurrence counters per (src, dst) stage pair: the i-th send of a
        # pair meets the i-th recv, on the same two ranks.
        occ_send: dict = {}
        occ_recv: dict = {}
        for s, (mod, rank_in, rank_out) in enumerate(self._links):
            local = self.is_local_stage(s)
            received: List[Any] = []
            if rank_in is None:
                if local and inputs:
                    if len(entry_stages) == 1:
                        received.extend(inputs)
                    else:
                        received.append(inputs[entry_stages.index(s)])
            else:
                for r in _as_list(rank_in):
                    src_local = self.is_local_stage(r)
                    if local and src_local:
                        received.append(F.recv(
                            self._comm, r, self_rank=s, tag=self._tag,
                            device_put=lambda v, _s=s: self.place_activation(
                                v, _s)))
                    elif local:  # the producer runs on another rank
                        occ = occ_recv[(r, s)] = occ_recv.get((r, s), -1) + 1
                        received.append(F.cross_recv(
                            self._comm, self.stage_owner(r),
                            tag=self._cross_tag(r, s, occ)))
            if not local:
                continue
            if mod is None:
                raise ValueError(f"stage {s} runs on this rank but was "
                                 "registered without a module")
            received.extend(stage_inputs.get(s, ()))
            y = mod(*received)
            if rank_out is None:
                outputs.append(y)
                continue
            for r in _as_list(rank_out):
                if self.is_local_stage(r):
                    F.send(y, self._comm, r, self_rank=s, tag=self._tag)
                else:
                    occ = occ_send[(s, r)] = occ_send.get((s, r), -1) + 1
                    cross_delegates.append(F.cross_send(
                        y, self._comm, self.stage_owner(r),
                        tag=self._cross_tag(s, r, occ)))
        leftovers = [k for k, q in channels.slots.items()
                     if q and k[2] == self._tag]
        if leftovers:
            raise RuntimeError(
                f"unconsumed sends on channels {leftovers}: some rank_out "
                "has no matching rank_in consumer in this chain list")
        if not outputs:
            if cross_delegates:
                return (cross_delegates[0] if len(cross_delegates) == 1
                        else torch.cat(cross_delegates))
            return None
        if cross_delegates:
            # the caller's one backward also drives the sends' backwards
            tied = F.pseudo_connect(torch.cat(cross_delegates), *outputs)
            outputs = list(tied) if len(outputs) > 1 else [tied]
        return outputs[0] if len(outputs) == 1 else tuple(outputs)


__all__ = ["MultiNodeChainList", "pseudo_loss"]
