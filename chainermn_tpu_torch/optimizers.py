"""Multi-node optimizer — gradient allreduce woven into the update step.

Counterpart of ``chainermn_tpu/optimizers.py`` (the reference's
``create_multi_node_optimizer``): wrap any optimizer so that its step runs
``comm.allreduce_grad`` on the gradients of the local forward/backward,
then the inner update.  Here the wrapped object is a ``torch.optim``
optimizer (the JAX package wraps an optax transformation).

``double_buffering=True`` is the fork's double-buffered optimizer;
``zero=True`` shards the optimizer state ZeRO-1-style (a beyond-reference
extension of the JAX package).  ``compression=`` picks the gradient wire
codec (JAX ``optimizers.py:299``): ``NoCompression(wire_dtype)`` runs the
``allreduce_grad_dtype`` program, a quantizer (``"int8"``/``"fp8"``) the
error-feedback exchange with its state in the optimizer
(:class:`_CompressedOptimizer`); a :class:`~chainermn_tpu_torch.planner.Plan`
with quantized stages runs the per-hop exchange, one EF state a quantized
hop (``comp_state`` is then a dict by hop).

Every wrapper's ``local_optimizer`` is the ``torch.optim`` optimizer that
holds this rank's state and whose step moves its parameters (the wrapped
one, or ZeRO-1's optimizer over this rank's flat shards): checkpoints save
and restore its state.
"""

from __future__ import annotations

import inspect
import warnings
from typing import Callable

import torch

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.communicators.mesh_communicator_base import (
    all_gather_tensor)
from chainermn_tpu_torch.ops.cast_scale import cast_scale
from chainermn_tpu_torch.utils.accum import accumulate_microbatches


def _local_grads(params):
    """Each parameter's local gradient, zeros where backward left None."""
    return [p.grad if p.grad is not None else torch.zeros_like(p)
            for p in params]


class _MultiNodeOptimizer:
    """``step()`` = allreduce-mean the gradients, then the inner step.

    Every other attribute (``param_groups``, ``state``, ``zero_grad``,
    ``state_dict``...) is the local optimizer's: the wrapped one, as in
    the reference (ZeRO-1's own, over the shards, for all but
    ``zero_grad``).
    """

    def __init__(self, actual_optimizer: torch.optim.Optimizer, comm,
                 compression=None):
        self.actual_optimizer = actual_optimizer
        self.communicator = comm
        # a stateless codec (NoCompression(wire_dtype)), forwarded to
        # allreduce_grad on every call
        self.compression = compression

    def __getattr__(self, name):
        return getattr(self.local_optimizer, name)

    @property
    def local_optimizer(self) -> torch.optim.Optimizer:
        return self.actual_optimizer

    def allreduce_grad(self) -> None:
        # every parameter, whether or not this rank's backward reached it:
        # an unused one contributes zeros, as its JAX gradient is, so every
        # rank issues the same collectives and the inner step moves it as
        # optax moves a parameter with a zero gradient (momentum)
        params = [p for g in self.actual_optimizer.param_groups
                  for p in g["params"]]
        reduced = self.communicator.allreduce_grad(
            _local_grads(params), compressor=self.compression)
        for p, g in zip(params, reduced):
            p.grad = g

    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError(
                "a closure would re-run forward/backward after the "
                "gradients were averaged; call backward, then step()")
        return self._update()

    def _update(self):
        self.allreduce_grad()
        return self.actual_optimizer.step()


class _CompressedOptimizer(_MultiNodeOptimizer):
    """Quantized gradient exchange (JAX ``optimizers.py:75``):
    ``allreduce_grad(compressor=..., state=...)`` with the error-feedback
    state held here.

    ``comp_state`` is this rank's
    :class:`~chainermn_tpu_torch.compression.CompressionState` (each rank
    keeps its own residual), built at construction over the parameters'
    packed float32 length and updated in place every step, so a checkpoint
    tree that holds it (``{"comp": optimizer.comp_state}``) saves the
    live state and a resume restores into it.  With a per-hop ``Plan`` it
    is a ``{hop: CompressionState}`` dict, each sized to its hop's buffer.
    """

    def __init__(self, actual_optimizer: torch.optim.Optimizer, comm,
                 compression):
        super().__init__(actual_optimizer, comm, compression)
        params = [p for g in actual_optimizer.param_groups
                  for p in g["params"]]
        self.comp_state = comm.init_compression_state(
            [p.detach() for p in params], compression)

    def allreduce_grad(self) -> None:
        params = [p for g in self.actual_optimizer.param_groups
                  for p in g["params"]]
        reduced, new = self.communicator.allreduce_grad(
            _local_grads(params), compressor=self.compression,
            state=self.comp_state)
        if isinstance(self.comp_state, dict):
            for hop, st in self.comp_state.items():
                st.update(new[hop])
        else:
            self.comp_state.update(new)
        for p, g in zip(params, reduced):
            p.grad = g


class _DoubleBufferingOptimizer(_MultiNodeOptimizer):
    """The fork's double-buffered optimizer (JAX ``optimizers.py:120``).

    Update t applies the world mean of step t-1's local gradients (one
    step of staleness); update 0 applies zeros, through the inner step, so
    Adam's step count and SGD's momentum buffer advance as optax's do.

    The mean of step t's gradients starts at update t: they are packed
    (copied, so ``zero_grad(set_to_none=True)`` may free them) and the
    communicator leaves the all-reduce in flight -- the ``xla`` flavor
    casts to its wire dtype and issues it with ``async_op=True``.  Update
    t+1 waits for it, so on the card it overlaps step t+1's forward and
    backward, which is what the reference's side stream bought.  The
    closure that finishes it holds the buffers and the work handles until
    then.  Flavors of several collectives reduce at once (no overlap, the
    same values).
    """

    def __init__(self, actual_optimizer: torch.optim.Optimizer, comm):
        super().__init__(actual_optimizer, comm)
        self._pending = None  # finish() of the previous step's mean

    def _update(self):
        params = [p for g in self.actual_optimizer.param_groups
                  for p in g["params"]]
        if self._pending is None:
            stale = [torch.zeros_like(p) for p in params]
        else:
            stale = self._pending()
        # an unused parameter's local gradient is zero, as JAX's is
        self._pending = self.communicator._allreduce_grad_start(
            _local_grads(params))
        for p, g in zip(params, stale):
            p.grad = g
        return self.actual_optimizer.step()

    def _drain(self) -> None:
        """Wait for the mean in flight; the next update applies it as it
        would have.  For the end of training: no collective is left
        running."""
        if self._pending is not None:
            done = self._pending()
            self._pending = lambda: done

    def pending_grads(self):
        """The gradient mean the next update applies (waited for; the
        caller must not write to it), or None before the first update:
        the part of this optimizer's state that a checkpoint keeps."""
        self._drain()
        return None if self._pending is None else self._pending()

    def set_pending_grads(self, grads) -> None:
        """Make ``grads`` (one tensor per parameter) the mean the next
        update applies, as a restored checkpoint does."""
        grads = list(grads)
        self._pending = lambda: grads


def rebuild_optimizer(optimizer: torch.optim.Optimizer,
                      params) -> torch.optim.Optimizer:
    """A new instance of ``optimizer``'s class over ``params`` (flat
    shards), with the hyperparameters of its one parameter group."""
    cls = type(optimizer)
    hyper = {k: optimizer.param_groups[0][k] for k in optimizer.defaults}
    # a default the constructor does not take (AdamW's
    # decoupled_weight_decay) is set on the group afterwards
    takes = inspect.signature(cls.__init__).parameters
    new = cls(params, **{k: v for k, v in hyper.items() if k in takes})
    new.param_groups[0].update(hyper)
    return new


class _Zero1Optimizer(_MultiNodeOptimizer):
    """ZeRO stage-1 optimizer-state sharding (JAX ``optimizers.py:186``, a
    beyond-reference extension there too).

    Each rank owns 1/size of the flattened parameters: per dtype group the
    gradients are packed, padded to a multiple of ``size`` and
    reduce-scattered (sum, then ``/ size``), so this rank holds the mean of
    its shard; the inner optimizer steps that shard alone, so its state
    (SGD's momentum, Adam's two moments) is 1/size of the unsharded
    state; the updated shards are all-gathered, unpacked and copied into
    the parameters, which stay replicated.  The shard is sliced from the
    current parameters before every step, as the JAX optimizer slices the
    packed parameters it is given.

    With the communicator's ``allreduce_grad_dtype`` the reduce-scatter
    runs in that wire dtype: :func:`~chainermn_tpu_torch.ops.cast_scale`
    into it with scale 1, the sum, and ``cast_scale`` back with scale
    1/size (the cast kernel on the card; at power-of-two sizes the bits of
    JAX's ``astype``, ``reduce_scatter``, ``/ size``, ``astype``).

    The inner optimizer is a new instance of the wrapped optimizer's class
    over the flat shards, with its hyperparameters; the wrapped one keeps
    the model's parameters for ``zero_grad``.  It must have one parameter
    group (shard boundaries erase groups), and no rule whose update reads
    a parameter's shape (LARS's layer-wise trust ratio).
    """

    def __init__(self, actual_optimizer: torch.optim.Optimizer, comm,
                 compression=None):
        groups = actual_optimizer.param_groups
        if len(groups) != 1:
            raise ValueError(
                f"zero=True flattens the parameters into one shard per "
                f"dtype, which erases parameter groups; got {len(groups)}")
        super().__init__(actual_optimizer, comm, compression)
        self._params = list(groups[0]["params"])
        size, rank = comm.size, comm.rank
        bufs, _ = _packing.pack([p.detach() for p in self._params])
        shards = []
        for buf in bufs:
            buf, _ = _packing.pad_to_multiple(buf, size)
            n = buf.shape[0] // size
            shards.append(buf[rank * n:(rank + 1) * n].clone())
        self._local = rebuild_optimizer(actual_optimizer, shards)
        self._shards = shards

    @property
    def local_optimizer(self) -> torch.optim.Optimizer:
        return self._local

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Clear the model's gradients (the shards' are set each step)."""
        self.actual_optimizer.zero_grad(set_to_none=set_to_none)

    def reduce_scatter_grad(self, grads):
        """The mean of ``grads`` (a list of this rank's gradients) over
        the world, as this rank's flat shard of each dtype group; also
        returns the pack metadata and each group's strip."""
        comm = self.communicator
        size = comm.size
        # an explicit NoCompression(wire_dtype) wins over the
        # communicator's knob (its deprecated spelling)
        wire = getattr(self.compression, "wire", None)
        if wire is None and comm.supports_allreduce_grad_dtype:
            wire = comm.allreduce_grad_dtype
        bufs, meta = _packing.pack(grads)
        shards, strips = [], []
        for g in bufs:
            g, strip = _packing.pad_to_multiple(g, size)
            strips.append(strip)
            if wire is not None and g.dtype != wire:
                s = comm.reduce_scatter(cast_scale(g, wire, 1.0))
                s = cast_scale(s, g.dtype, 1.0 / size)
            else:
                s = comm.reduce_scatter(g) / size
            shards.append(s)
        return shards, meta, strips

    def _update(self):
        comm = self.communicator
        grads, meta, strips = self.reduce_scatter_grad(
            _local_grads(self._params))
        pbufs, _ = _packing.pack([p.detach() for p in self._params])
        for shard, g, p in zip(self._shards, grads, pbufs):
            n = shard.shape[0]
            p, _ = _packing.pad_to_multiple(p, comm.size)
            shard.copy_(p[comm.rank * n:(comm.rank + 1) * n])
            shard.grad = g
        self.local_optimizer.step()
        full = []
        for shard, strip in zip(self._shards, strips):
            shard.grad = None
            out = shard.new_empty(shard.shape[0] * comm.size)
            all_gather_tensor(out, shard, group=comm.group)
            full.append(strip(out))
        with torch.no_grad():
            for p, v in zip(self._params, _packing.unpack(full, meta)):
                p.copy_(v)


def _deprecate_raw_wire_knob(communicator, compression) -> None:
    """JAX ``optimizers.py:161``: a communicator with a RAW
    ``allreduce_grad_dtype`` (the knob given directly, not as a codec)
    still works, with a pointer to its replacement."""
    if compression is not None:
        return
    dt = getattr(communicator, "allreduce_grad_dtype", None)
    if dt is not None and getattr(communicator, "compression", None) is None:
        name = str(dt).replace("torch.", "")
        warnings.warn(
            f"allreduce_grad_dtype={name!r} without an explicit "
            "compression codec is deprecated; pass "
            f"compression=NoCompression(wire_dtype={name!r}) (or just "
            f"compression={name!r}) to create_communicator / "
            "create_multi_node_optimizer instead -- it runs the identical "
            "cast-allreduce-cast program",
            DeprecationWarning, stacklevel=3)


def create_multi_node_optimizer(actual_optimizer: torch.optim.Optimizer,
                                communicator, double_buffering: bool = False,
                                zero: bool = False, compression=None):
    """Reference signature: ``create_multi_node_optimizer(optimizer, comm,
    double_buffering)``; ``actual_optimizer`` is a ``torch.optim``
    optimizer over the model's parameters.

    ``zero=True`` shards the optimizer state over the world (ZeRO-1, see
    :class:`_Zero1Optimizer`); it excludes ``double_buffering`` (the
    pending full-size gradients would undo the memory saving).

    ``compression`` selects the gradient wire codec: a name
    (``"int8"``/``"fp8"``), a dtype string, a config dict or a
    :class:`~chainermn_tpu_torch.compression.Compressor`.
    ``NoCompression(wire_dtype=...)`` reproduces the communicator's
    ``allreduce_grad_dtype`` program bit for bit; a quantizer keeps its
    error-feedback state in the returned optimizer
    (:class:`_CompressedOptimizer`) and composes with neither ``zero``
    nor ``double_buffering`` (JAX's refusals).  A
    :class:`~chainermn_tpu_torch.planner.Plan` with per-hop
    ``Stage.compression`` specs executes that plan with one EF state per
    quantized hop (JAX's two refusals: with ``zero``/``double_buffering``,
    and a plan with no quantized stage on this topology)."""
    from chainermn_tpu_torch.compression import (
        is_quantizing, resolve_compressor)
    from chainermn_tpu_torch.planner.compiler import plan_compressed_hops
    from chainermn_tpu_torch.planner.ir import Plan
    if isinstance(compression, Plan):
        if zero or double_buffering:
            raise NotImplementedError(
                "compression=<Plan> (per-hop) composes with neither "
                "zero=True nor double_buffering=True -- the per-hop EF "
                "states ride the plain compressed-optimizer state slot")
        if not plan_compressed_hops(compression,
                                    communicator.plan_topology()):
            raise ValueError(
                f"compression plan {compression.name!r} has no quantizing "
                "stages on this topology; pass the plan to "
                "create_communicator(plan_table=...) instead, or add "
                "Stage.compression specs")
        return _CompressedOptimizer(actual_optimizer, communicator,
                                    compression)
    compression = resolve_compressor(compression)
    _deprecate_raw_wire_knob(communicator, compression)
    if zero and double_buffering:
        raise ValueError("zero=True and double_buffering=True are mutually "
                         "exclusive (the pending full-size gradient buffer "
                         "would defeat ZeRO's memory saving)")
    if is_quantizing(compression):
        if zero:
            raise NotImplementedError(
                "compression=<quantizer> with zero=True is not supported "
                "yet: ZeRO-1's reduce-scatter leg would need per-shard EF "
                "state (the bucketed FSDP engine has that -- use "
                "fsdp_init(bucket_compressors=...))")
        if double_buffering:
            raise NotImplementedError(
                "compression=<quantizer> with double_buffering=True is not "
                "supported: stale-gradient buffering and error feedback "
                "both delay the update stream; composing them changes "
                "convergence semantics")
        return _CompressedOptimizer(actual_optimizer, communicator,
                                    compression)
    if zero:
        return _Zero1Optimizer(actual_optimizer, communicator,
                               compression=compression)
    if double_buffering:
        if compression is not None and compression.wire is not None:
            raise NotImplementedError(
                "compression=NoCompression(wire_dtype) with "
                "double_buffering=True: set allreduce_grad_dtype on the "
                "communicator instead (the pending-buffer allreduce "
                "honors it)")
        return _DoubleBufferingOptimizer(actual_optimizer, communicator)
    if compression is not None and compression.wire is None:
        compression = None  # bare NoCompression() is the do-nothing default
    return _MultiNodeOptimizer(actual_optimizer, communicator,
                               compression=compression)


def make_train_step(communicator, loss_fn: Callable, optimizer,
                    has_aux: bool = False, accum_steps: int = 1):
    """The train step (the hot loop): forward/backward on the local batch,
    ``allreduce_grad``, then the inner update.

    ``loss_fn(batch) -> loss`` (or ``(loss, aux)`` with ``has_aux``, aux a
    dict of scalar tensors) runs the caller's module on this rank's local
    batch, as a reference rank ran its local minibatch.  The module's
    BatchNorm running statistics are buffers that the step never reduces:
    they stay rank-local, as ``make_train_step(with_model_state=True)``
    keeps them in the JAX package.  ``optimizer`` is from
    :func:`create_multi_node_optimizer`.

    ``accum_steps=K`` (K > 1) is gradient accumulation
    (:mod:`.utils.accum`): ``loss_fn`` runs forward and backward on K equal
    microbatches of the local batch in turn, the K gradients are summed and
    divided by K once, and then the ONE ``allreduce_grad`` and update of
    the step run (through every optimizer of
    :func:`create_multi_node_optimizer`), with peak activation memory about
    1/K.  For a loss that is a mean over samples the gradient is the full
    batch's; BatchNorm normalizes each microbatch on its own and updates
    its running buffers K times (JAX's ghost-batch semantics).  A K that
    does not divide the batch raises ``ValueError``.

    Returns ``step(batch) -> loss`` (``(loss, aux)`` with ``has_aux``):
    the loss, and aux, averaged over the world.  ``step.finalize()`` waits
    for a gradient mean the double-buffered optimizer still has in flight
    (the trainer calls it when training ends).

    The loss (and aux) means are all-reduced before the update: the
    double-buffered optimizer's gradient mean is then the step's last
    collective, left in flight.  A blocking all-reduce issued after it on
    the same communicator would wait for it, and the next step's forward
    with it (``tools/check_db_overlap.py`` judges this on the cards).
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    comm = communicator
    # the model's parameters (ZeRO-1's local optimizer holds shards)
    params = [p for g in getattr(optimizer, "actual_optimizer",
                                 optimizer).param_groups
              for p in g["params"]]

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        if accum_steps > 1:
            loss, aux = accumulate_microbatches(loss_fn, batch, accum_steps,
                                                has_aux, params)
        else:
            out = loss_fn(batch)
            loss, aux = out if has_aux else (out, None)
            loss.backward()
        loss = comm.allreduce(loss.detach(), "mean")
        if has_aux:
            aux = comm.allreduce({k: v.detach() for k, v in aux.items()},
                                 "mean")
        optimizer.step()
        return (loss, aux) if has_aux else loss

    step.finalize = getattr(optimizer, "_drain", lambda: None)
    return step


class PerStageOptimizer:
    """Optimizer for model-parallel chains (``MultiNodeChainList``): one
    inner ``torch.optim`` optimizer for each stage this rank runs, each over
    that stage's parameters; a rank steps only its own stages, as each
    reference rank updated only its own sub-chain.

    ``actual_optimizer(params) -> torch.optim.Optimizer`` builds an inner
    optimizer (e.g. ``functools.partial(torch.optim.Adam, lr=2e-3)``): the
    recipe, as the JAX class takes an optax transformation.
    """

    def __init__(self, actual_optimizer: Callable):
        self.actual_optimizer = actual_optimizer
        self.optimizers: list = []
        self._chain = None

    def init(self, chain) -> list:
        """One inner optimizer per stage of the ``MultiNodeChainList``
        ``chain`` that this rank runs (``None`` for the others' stages)."""
        self._chain = chain
        self.optimizers = [None if m is None else
                           self.actual_optimizer(list(m.parameters()))
                           for m in chain.local_stages]
        return self.optimizers

    def _check(self) -> None:
        n = self._chain.n_stages if self._chain is not None else 0
        if self._chain is None or n != len(self.optimizers):
            raise ValueError(
                f"stage count mismatch: {n} stages, {len(self.optimizers)} "
                "optimizer states — re-init the optimizer after changing "
                "the chain list")

    def zero_grad(self, set_to_none: bool = True) -> None:
        for opt in self.optimizers:
            if opt is not None:
                opt.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        """Step every local stage's optimizer on its ``.grad``s."""
        self._check()
        for opt in self.optimizers:
            if opt is not None:
                opt.step()


def create_per_stage_optimizer(actual_optimizer: Callable
                               ) -> PerStageOptimizer:
    return PerStageOptimizer(actual_optimizer)
