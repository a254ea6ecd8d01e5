"""ZeRO-3 / FSDP: fully sharded data parallelism, bucketed.

Counterpart of ``chainermn_tpu/parallel/fsdp.py`` (a beyond-reference
extension there too).  It completes the ZeRO ladder:
``create_multi_node_optimizer(zero=True)`` is stage 1 (optimizer state
sharded, gradients reduce-scattered); here the PARAMETERS are sharded as
well.  Each rank stores 1/size of the flat parameter space and the inner
optimizer's state over that shard; the full parameters exist only inside
the step.

The parameters, in the module's registration order, are cut into K
buckets (:mod:`.buckets`, deterministic across ranks); each bucket is
packed into one flat buffer per dtype (``_packing.pack``), padded to a
multiple of the world size, and this rank keeps its slice.  The step
(:func:`make_fsdp_train_step`):

* forward: each bucket goes through an ``autograd.Function`` whose forward
  casts the shard to the wire dtype (:func:`~chainermn_tpu_torch.ops.
  cast_scale`, scale 1), all-gathers it over the communicator's group,
  strips the pad and casts back: every parameter the loss sees is rounded
  to the wire, this rank's own slice included, as in JAX.  The module's
  parameters are views of the gathered buffers for the duration of the
  step; its buffers (BatchNorm's running statistics) stay its own and
  rank-local (JAX's ``with_model_state``);
* backward: the Function's backward is the transpose -- cast to the wire,
  reduce-scatter (sum), cast back with scale 1/size (1 with
  ``global_loss``).  Each bucket's reduce-scatter starts from its own
  backward, as soon as that bucket's gradient is complete, and runs while
  the backward of the bucket before it goes on.  The reduce-scatter is an
  all-to-all of the ranks' slices followed by their sum in rank order (one
  add per rank), so every element sums in the same order whatever the
  bucketing, as JAX's ``psum_scatter`` does on the CPU: K buckets give the
  bits of one bucket.  A ring ``reduce_scatter`` sums each element
  starting from a rank that depends on where the element falls in the
  buffer, so two bucketings differ in the last bit (a 4-rank gloo world
  did).  The all-to-all moves the same bytes as the ring, but its receive
  buffer is the size of the whole bucket where the ring's output is the
  size of the shard: while a bucket's all-to-all is in flight, a rank
  holds (size - 1)/size of that bucket's bytes more than a ring would.
  So a bucket's all-to-all is waited for and folded into a shard-sized
  gradient when the next bucket's starts (the last one after the
  backward), and at most one bucket's receive buffer is alive at a time:
  the extra peak memory is (size - 1)/size of the largest bucket (of all
  the parameters at K = 1);
* update: the inner optimizer (a new instance of the given optimizer's
  class, with its hyperparameters) steps the shards, so its state (Adam's
  two moments) is 1/size of the replicated state.

With K > 1 the gathers are issued in bucket order, ``async_op=True``, and
the compute stream waits for bucket i only where bucket i's parameters are
first used (a forward pre-hook on each module that holds a parameter; a
``ParameterList``/``ParameterDict``'s are its parent's).
At most ``prefetch + 1`` gathers are issued and not yet consumed: JAX's
optimization-barrier window, done with streams and waits.  With one
bucket there is one gather and one reduce-scatter per dtype buffer, and no
hooks.

Differences from the JAX package, all from one process per GPU:

* :func:`make_fsdp_train_step` takes the :class:`FsdpState` where JAX
  takes the optax rule (the state holds the inner optimizer) and returns
  ``step(batch)``, as :func:`~chainermn_tpu_torch.optimizers.
  make_train_step` does; the state is updated in place.
* :func:`fsdp_full_params` is a collective (a rank holds only its own
  shards), and consolidating a checkpoint reads every rank's file
  (:func:`~chainermn_tpu_torch.extensions.consolidate_fsdp_checkpoint`).
* The shard lengths follow the registration order, not JAX's sorted
  keys, so FSDP checkpoints of the two packages do not interchange.

Same caveat as ZeRO-1: the flat shards erase leaf boundaries, so a rule
whose update reads a parameter's shape (LARS's trust ratio) would compute
shard-wise ratios; it is refused unless ``allow_layerwise=True``.

Quantized buckets (``fsdp_init(bucket_compressors=...)``, JAX
``_make_compressed_gather``): a bucket with an int8/fp8 compressor keeps an
error-feedback state (``FsdpState.comp``: the residual over the bucket's
padded full length, this rank's own scale exponent, the step).  Its
forward all-gather carries each rank's exponent in one slot after its
shard; its backward is the compressed reduce-scatter: EF add, encode each
destination's slice with that destination's exponent (clipped so the
in-wire sum cannot overflow), one saturation flag per destination slice,
the all-to-all of codes and flags, their sum in wire arithmetic in rank
order (:func:`~chainermn_tpu_torch.compression.quantize.sum_wire`: int8
exactly, fp8 in float16 then rounded once), this rank's shard decoded by
its own exponent, and the exponent's delayed update from the shard's amax
and clip count.  ``NoCompression(wire_dtype)`` folds into the bucket's
wire dtype.  A quantized bucket refuses accumulation (EF would advance once
a microbatch), as in JAX.

Per-bucket observability (JAX ``_FsdpObs``): with observability on when
the step is built, each bucket's gather and reduce-scatter get
``fsdp_{gather,scatter}_{begin,end}`` flight events (``link`` ``nvlink``)
and the ``fsdp_overlap_*`` metric family; a compressed bucket's encode
and decode get ``compression_*`` metrics and compute spans (seam
``fsdp``).  On the card an edge records a CUDA event on the current
stream, where JAX's device callbacks fire; the step resolves its events
once, at its end (one synchronize a step, after all of the step's work is
queued), into times on the host's clocks, so the prefetch window and the
backward's reduce-scatters overlap as they do unobserved.  On the CPU an
edge is stamped when the host reaches it.  A gather's begin is its issue,
a reduce-scatter's its start in the backward, and each end is its wait.
Off, the step makes no observability call.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from chainermn_tpu_torch.communicators import _packing
from chainermn_tpu_torch.ops.cast_scale import cast_scale
from chainermn_tpu_torch.optim import LARS
from chainermn_tpu_torch.parallel import buckets as _buckets
from chainermn_tpu_torch.utils.accum import accumulate_microbatches


def _all_gather():
    """``all_gather_tensor`` under the name this torch has (imported late:
    the communicators import this package)."""
    from chainermn_tpu_torch.communicators import mesh_communicator_base as m
    return m.all_gather_tensor


def _reject_multi_node_wrapper(optimizer):
    """FSDP takes a plain ``torch.optim`` optimizer: a multi-node wrapper's
    all-reduce would sum unrelated parameter shards across ranks."""
    from chainermn_tpu_torch.optimizers import _MultiNodeOptimizer
    if isinstance(optimizer, _MultiNodeOptimizer):
        raise TypeError(
            "fsdp takes a plain torch.optim optimizer, not a "
            "create_multi_node_optimizer wrapper -- the gather/scatter "
            "collectives ARE the multi-node integration here")


def _reject_layerwise_optimizer(optimizer):
    """LARS's trust ratios are per-LAYER norms; the flat per-bucket shards
    erase layer boundaries, so they would be computed shard-wise."""
    if isinstance(optimizer, LARS):
        raise ValueError(
            "optimizer is a layer-wise trust-ratio rule (LARS): FSDP "
            "flattens parameters into per-bucket shards, so trust ratios "
            "would be computed over arbitrary shard boundaries instead of "
            "layers -- silently wrong updates. Use an element-wise rule "
            "(SGD/momentum/Adam/AdamW/...), or pass allow_layerwise=True "
            "to fsdp_init if you explicitly want shard-wise semantics.")


class BucketLayout(NamedTuple):
    """Static layout of ONE parameter bucket: a contiguous ``[start,
    stop)`` run of the parameters, packed into per-dtype flat buffers."""
    start: int              # first parameter index (inclusive)
    stop: int               # last parameter index (exclusive)
    pack_meta: Any          # _packing meta over this bucket's parameters
    orig_lens: tuple        # unpadded flat length per dtype buffer
    shard_lens: tuple       # per-rank shard length per dtype buffer
    pads: tuple             # pad appended to each buffer
    nbytes: int             # unpadded payload bytes of the bucket
    wire_dtype: Optional[str] = None  # per-bucket wire override (or None)
    compressor: Optional[str] = None  # quantizer spec JSON (or None)


class FsdpMeta(NamedTuple):
    """Static layout of the bucketed sharded parameter space (picklable;
    no tensor): the parameters' names in registration order, the buckets
    and the world size the shards were cut for."""
    names: tuple
    buckets: tuple                  # tuple[BucketLayout, ...]
    world_size: int

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    @property
    def shard_lens(self) -> tuple:
        """Flat per-buffer shard lengths across buckets (``sum(...) *
        world_size`` bounds the padded parameter count)."""
        return tuple(l for b in self.buckets for l in b.shard_lens)


class FsdpState:
    """This rank's persistent state: ``shards[bucket][buffer]``, a flat
    tensor of the buffer's shard length; ``inner``, the ``torch.optim``
    optimizer over them; ``module``, whose parameters the step swaps for
    the gathered views; ``world_size``, the world the shards were cut
    for; ``comp``, one
    :class:`~chainermn_tpu_torch.compression.CompressionState` or None per
    bucket (``()`` when no bucket is quantized).  A checkpoint stores
    ``shards``, the inner optimizer's state and the quantized buckets' EF
    states under this state's path, and a resume restores them in
    place."""

    def __init__(self, shards, inner, module, world_size: int, comp=()):
        self.shards = shards
        self.inner = inner
        self.module = module
        self.world_size = world_size
        self.comp = comp

    def flat_shards(self) -> List[torch.Tensor]:
        return [s for bucket in self.shards for s in bucket]

    def tree(self) -> dict:
        """What a checkpoint stores: ``{"shards": [[tensor]], "inner":
        optimizer_state_tree(inner)}``."""
        from chainermn_tpu_torch.optim import optimizer_state_tree
        tree = {"shards": [list(b) for b in self.shards],
                "inner": optimizer_state_tree(self.inner)}
        if any(c is not None for c in self.comp):
            tree["comp"] = {str(i): c.tree() for i, c in enumerate(self.comp)
                            if c is not None}
        return tree

    def load_tree(self, tree: dict) -> None:
        """Copy a restored :meth:`tree` into this state, in place."""
        from chainermn_tpu_torch.optim import load_optimizer_state_tree
        with torch.no_grad():
            for bucket, saved in zip(self.shards, tree["shards"]):
                for s, v in zip(bucket, saved):
                    s.copy_(v)
        load_optimizer_state_tree(self.inner, tree["inner"])
        for i, c in enumerate(self.comp):
            if c is not None:
                c.load_tree(tree["comp"][str(i)])


def _normalize_wire(dtype) -> Optional[torch.dtype]:
    if dtype is None:
        return None
    wire = dtype if isinstance(dtype, torch.dtype) else getattr(
        torch, str(getattr(dtype, "name", dtype)), None)
    if not isinstance(wire, torch.dtype):
        raise ValueError(f"unknown wire dtype {dtype!r}")
    if not wire.is_floating_point:
        raise ValueError(
            f"wire_dtype must be a floating dtype, got {wire} -- an "
            f"integer wire would truncate the gathered parameters")
    return wire


def _bucket_compressors(bucket_compressors, n: int) -> list:
    """One resolved compressor (or None) per bucket: a single value goes
    to every bucket, a list must have one entry per bucket."""
    from chainermn_tpu_torch.compression import resolve_compressor
    if bucket_compressors is None:
        bucket_compressors = [None] * n
    elif not isinstance(bucket_compressors, (list, tuple)):
        bucket_compressors = [bucket_compressors] * n
    elif len(bucket_compressors) != n:
        raise ValueError(
            f"bucket_compressors has {len(bucket_compressors)} entries "
            f"but the partition produced {n} buckets")
    return [resolve_compressor(c) for c in bucket_compressors]


def make_fsdp_meta(model: nn.Module, world_size: int, num_buckets: int = 1,
                   bucket_bytes: Optional[int] = None,
                   bucket_wire_dtypes: Optional[Sequence] = None,
                   bucket_compressors=None) -> FsdpMeta:
    """The layout :func:`fsdp_init` cuts ``model``'s parameters into for a
    world of ``world_size`` ranks, without a communicator: what a server
    of another world size needs to consolidate the checkpoint of a
    training world.  The knobs are :func:`fsdp_init`'s."""
    from chainermn_tpu_torch.compression import NoCompression, is_quantizing
    named = list(model.named_parameters())
    leaves = [p for _, p in named]
    assignments = _buckets.partition_buckets(
        leaves, num_buckets=num_buckets if bucket_bytes is None or
        num_buckets != 1 else None, bucket_bytes=bucket_bytes)
    if bucket_wire_dtypes is not None \
            and len(bucket_wire_dtypes) != len(assignments):
        raise ValueError(
            f"bucket_wire_dtypes has {len(bucket_wire_dtypes)} entries "
            f"but the partition produced {len(assignments)} buckets")
    comps = _bucket_compressors(bucket_compressors, len(assignments))
    layouts = []
    for a in assignments:
        # shapes and dtypes only: pack tensors on the meta device
        bufs, pack_meta = _packing.pack([
            torch.empty(p.shape, dtype=p.dtype, device="meta")
            for p in leaves[a.start:a.stop]])
        orig = [int(b.shape[0]) for b in bufs]
        shard = [-(-n // world_size) for n in orig]
        wire = None
        if bucket_wire_dtypes is not None \
                and bucket_wire_dtypes[a.index] is not None:
            wire = _packing.dtype_name(
                _normalize_wire(bucket_wire_dtypes[a.index]))
        comp, spec = comps[a.index], None
        if isinstance(comp, NoCompression):
            # the identity codec IS the wire-dtype knob
            if comp.wire is not None:
                if wire is not None and wire != comp.wire_dtype:
                    raise ValueError(
                        f"bucket {a.index}: bucket_wire_dtypes={wire!r} "
                        f"conflicts with bucket_compressors="
                        f"NoCompression(wire_dtype={comp.wire_dtype!r}) "
                        "-- pass only one spelling")
                wire = comp.wire_dtype
        elif is_quantizing(comp):
            # quantizers ride ONE flat float buffer per bucket
            if len(bufs) != 1 or not bufs[0].dtype.is_floating_point:
                raise NotImplementedError(
                    f"bucket {a.index}: compressor {comp.name!r} needs a "
                    f"single float packed buffer, got "
                    f"{[_packing.dtype_name(b.dtype) for b in bufs]} -- keep "
                    "integer/mixed-dtype leaves in an uncompressed bucket")
            comp.clip_limit(world_size)  # raise early at unworkable sizes
            spec = comp.spec
        elif comp is not None:
            raise TypeError(f"bucket {a.index}: cannot use {comp!r} as a "
                            "bucket compressor")
        layouts.append(BucketLayout(
            start=a.start, stop=a.stop, pack_meta=pack_meta,
            orig_lens=tuple(orig), shard_lens=tuple(shard),
            pads=tuple(s * world_size - n for s, n in zip(shard, orig)),
            nbytes=a.nbytes, wire_dtype=wire, compressor=spec))
    return FsdpMeta(names=tuple(n for n, _ in named),
                    buckets=tuple(layouts), world_size=int(world_size))


def _holders(module: nn.Module) -> Dict[int, list]:
    """``{id(parameter): [(module, attribute), ...]}``: every place a
    parameter is registered (a shared one, in each module holding it)."""
    out: Dict[int, list] = {}
    for m in module.modules():
        for attr, p in m._parameters.items():
            if p is not None:
                out.setdefault(id(p), []).append((m, attr))
    return out


def _release(module: nn.Module) -> None:
    """Free the storage of ``module``'s parameters: each keeps its dtype
    and device, with no elements (a forward outside the step fails)."""
    for p in module.parameters():
        p.grad = None
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)


def fsdp_init(comm, model: nn.Module, optimizer: torch.optim.Optimizer,
              allow_layerwise: bool = False, num_buckets: int = 1,
              bucket_bytes: Optional[int] = None,
              bucket_wire_dtypes: Optional[Sequence] = None,
              bucket_compressors=None):
    """Shard ``model``'s parameters for stage-3 training over ``comm``.

    Returns ``(state, meta)``: the :class:`FsdpState` of this rank and the
    :class:`FsdpMeta` that :func:`make_fsdp_train_step` and
    :func:`fsdp_full_params` need.  Every rank must hold the same
    parameters (``comm.bcast_data(model)`` first).  ``optimizer`` is a
    plain ``torch.optim`` optimizer with one parameter group (not a
    multi-node wrapper, and not LARS unless ``allow_layerwise=True``): the
    inner optimizer is a new instance of its class over the shards, with
    its hyperparameters.  The module's parameter storage is freed: from
    here on the shards are the parameters.

    ``num_buckets=K`` cuts the parameters into K size-balanced contiguous
    buckets (the step then runs K gathers and K reduce-scatters that can
    overlap compute); ``bucket_bytes`` derives the count from a size
    target instead (``num_buckets`` wins when both are given);
    ``bucket_wire_dtypes`` is a per-bucket wire-dtype list (None entries
    fall back to the step's ``wire_dtype``).  ``bucket_compressors`` is
    each bucket's gradient wire codec (one value for every bucket, or a
    list of one per bucket; names, dtype strings, config dicts or
    Compressors): ``NoCompression(wire_dtype=...)`` folds into the bucket's
    wire dtype, a quantizer (``"int8"``/``"fp8"``) makes the bucket's
    reduce-scatter run over 1-byte codes with error feedback, its state in
    ``state.comp`` (the residual is the bucket's full padded length on
    every rank: the usual EF memory cost).
    """
    _reject_multi_node_wrapper(optimizer)
    if not allow_layerwise:
        _reject_layerwise_optimizer(optimizer)
    meta = make_fsdp_meta(model, comm.size, num_buckets, bucket_bytes,
                          bucket_wire_dtypes, bucket_compressors)
    groups = optimizer.param_groups
    if len(groups) != 1:
        raise ValueError(
            f"fsdp flattens the parameters into per-bucket shards, which "
            f"erases parameter groups; got {len(groups)}")
    size, rank = comm.size, comm.rank
    params = [p for _, p in model.named_parameters()]
    shards = []
    for bl in meta.buckets:
        bufs, _ = _packing.pack([p.detach() for p in
                                 params[bl.start:bl.stop]])
        bucket = []
        for buf, n in zip(bufs, bl.shard_lens):
            buf, _ = _packing.pad_to_multiple(buf, size)
            bucket.append(buf[rank * n:(rank + 1) * n].clone()
                          .requires_grad_())
        shards.append(bucket)
    from chainermn_tpu_torch.optimizers import rebuild_optimizer
    inner = rebuild_optimizer(optimizer, [s for b in shards for s in b])
    comp = []
    for bl, bucket in zip(meta.buckets, shards):
        if bl.compressor is None:
            comp.append(None)
            continue
        from chainermn_tpu_torch.compression import (
            EF_VERSION, CompressionState)
        dev = bucket[0].device
        comp.append(CompressionState(
            ef=torch.zeros(bl.shard_lens[0] * size, dtype=torch.float32,
                           device=dev),
            scale=torch.zeros(1, dtype=torch.float32, device=dev),
            step=torch.zeros(1, dtype=torch.float32, device=dev),
            spec=bl.compressor, ef_version=EF_VERSION))
    _release(model)
    return FsdpState(shards, inner, model, size,
                     comp if any(c is not None for c in comp) else ()), meta


def iter_fsdp_states(tree):
    """Yield every :class:`FsdpState` inside a python container tree
    (the checkpoint-state dicts of the examples: ``{"fsdp": state}``)."""
    if isinstance(tree, FsdpState):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from iter_fsdp_states(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from iter_fsdp_states(v)


def fsdp_layout(tree) -> Optional[dict]:
    """Sharding layout of every FsdpState in ``tree`` (None when there is
    none): the world size the shards were cut for, the bucket count and
    the per-bucket shard lengths.  The multi-node checkpointer persists it
    beside the arrays, so a resume into another world size, bucket
    configuration or an unsharded state fails loudly."""
    states = list(iter_fsdp_states(tree))
    if not states:
        return None
    sizes = sorted({st.world_size for st in states})
    n_buckets = sorted({len(st.shards) for st in states})
    layout = {
        "world_size": sizes[0] if len(sizes) == 1 else sizes,
        "num_buckets": n_buckets[0] if len(n_buckets) == 1 else n_buckets,
        "shard_lens": [[[int(s.shape[0]) for s in bucket]
                        for bucket in st.shards] for st in states],
        "n_states": len(states),
    }
    # bucket compression rides the same sidecar, only when present
    from chainermn_tpu_torch.compression import compression_layout
    comp = compression_layout([st.comp for st in states])
    if comp is not None:
        layout["compression"] = comp
    return layout


def unpack_full_params(fulls: Sequence[Sequence[torch.Tensor]],
                       meta: FsdpMeta) -> Dict[str, torch.Tensor]:
    """``{name: parameter}`` from each bucket's full (gathered, padded or
    not) flat buffers."""
    out = {}
    for bl, bufs in zip(meta.buckets, fulls):
        flat = [b[:n] for b, n in zip(bufs, bl.orig_lens)]
        out.update(zip(meta.names[bl.start:bl.stop],
                       _packing.unpack(flat, bl.pack_meta)))
    return out


def fsdp_full_params(state: FsdpState, meta: FsdpMeta, comm
                     ) -> Dict[str, torch.Tensor]:
    """The full parameters, ``{name: tensor}`` in registration order, from
    the bucketed shards: an all-gather of every buffer (exact, no wire),
    so every rank of ``comm`` must call it.  For evaluation, export and
    the end of training."""
    if comm.size != meta.world_size:
        raise ValueError(f"the shards were cut for {meta.world_size} ranks; "
                         f"this communicator has {comm.size}")
    all_gather = _all_gather()
    fulls = []
    for bucket in state.shards:
        bufs = []
        for s in bucket:
            out = s.new_empty(s.shape[0] * comm.size)
            all_gather(out, s.detach(), group=comm.group)
            bufs.append(out)
        fulls.append(bufs)
    return unpack_full_params(fulls, meta)


def load_module_params(module: nn.Module,
                       params: Dict[str, torch.Tensor]) -> None:
    """Make ``params`` (``{name: tensor}``) the storage of ``module``'s
    parameters (the end of training, or evaluation)."""
    named = dict(module.named_parameters())
    with torch.no_grad():
        for name, v in params.items():
            named[name].data = v.detach()


@contextlib.contextmanager
def fsdp_module_params(state: FsdpState, meta: FsdpMeta, comm):
    """Inside the block, ``state.module`` holds its full parameters
    (:func:`fsdp_full_params`, a collective); after it, their storage is
    freed again.  For an evaluator, as JAX passes it ``updater.params``."""
    load_module_params(state.module, fsdp_full_params(state, meta, comm))
    try:
        yield state.module
    finally:
        _release(state.module)


def compressed_scatter_encode(comm, comp, cstate, ct: torch.Tensor, e_vec,
                              cobs=None, bucket: int = 0):
    """A quantized bucket's reduce-scatter, its sending half (JAX
    ``_make_compressed_gather``'s backward): ``ct``, the bucket's full
    gradient padded to ``size x L``, plus the EF residual, each
    destination's slice encoded with that destination's exponent (``e_vec``,
    every rank's, from the forward's gather), one saturation flag after
    each slice.  Returns the bytes to send (``int8``: float8 codes move as
    bytes) and ``fold(recv)``, which takes the all-to-all's received bytes
    (every rank's slice of this rank's shard, in rank order), sums them in
    wire arithmetic, decodes this rank's shard by its own exponent,
    advances ``cstate`` in place (residual, exponent, step) and returns
    the shard's gradient SUM in ``ct``'s dtype.  ``cobs`` (a
    ``CompressionObs``) records the encode and the decode on rank 0 (seam
    ``fsdp``, bucket ``bucket``)."""
    from chainermn_tpu_torch.compression.quantize import sum_wire
    size = comm.size
    L = ct.shape[0] // size
    if cobs is not None:
        item = comp.wire_dtype.itemsize
        tags = ("fsdp", bucket, comp.name, item * 8.0, L * size * (4 - item))
    scale_pos = torch.exp2(e_vec).repeat_interleave(L)
    v = ct.to(torch.float32) + cstate.ef
    if cobs is not None:
        cobs.device_edge(comm.rank, "compress", "begin", *tags, dep=v)
    codes = comp.encode(v, scale_pos, comp.step_of(cstate), comm.rank, size)
    new_ef = v - comp.decode(codes, scale_pos)
    if cobs is not None:
        cobs.device_edge(comm.rank, "compress", "end", *tags,
                         residual=new_ef, dep=codes)
    flags = comp.saturation_flags(v, scale_pos, size, L)
    ext = torch.cat([codes.view(size, L), flags[:, None]], dim=1)
    wire = ext.dtype

    def fold(recv):
        summed = sum_wire(recv.view(wire).view(size, L + 1), wire)
        # this rank's shard, decoded by its own (current) exponent
        gshard = summed[:L].to(torch.float32) * torch.exp2(cstate.scale[0])
        if cobs is not None:
            cobs.device_edge(comm.rank, "decompress", "end", *tags,
                             dep=gshard)
        amax = gshard.abs().max().reshape(1)
        new_e = comp.next_exponent(cstate.scale, amax, size,
                                   summed[L:].to(torch.float32))
        cstate.update(cstate._replace(ef=new_ef, scale=new_e,
                                      step=cstate.step + 1.0))
        return gshard.to(ct.dtype)

    return ext.reshape(-1).view(torch.int8), fold


class _FsdpObs:
    """Per-bucket collective observability of the bucketed step (JAX's
    ``_FsdpObs``, its ``fsdp_overlap`` family):

    * ``fsdp_overlap_buckets`` / ``fsdp_overlap_prefetch`` (gauges),
    * ``fsdp_overlap_bytes`` (counter, labels ``leg`` / ``bucket``),
    * ``fsdp_overlap_seconds`` (histogram, labels ``leg`` / ``bucket``):
      the time between a bucket's begin and end edges (on the card from
      the edges' CUDA events),
    * ``fsdp_overlap_dispatch_seconds`` (histogram): host latency of the
      whole step call.

    The step's edges are kept in issue order and turned into flight events
    and metrics by :meth:`resolve` at the step's end.
    """

    def __init__(self, flight, registry, num_buckets: int, prefetch: int):
        self.flight = flight
        self.registry = registry
        self._edges: list = []
        if registry is not None:
            registry.gauge(
                "fsdp_overlap_buckets",
                "bucket count of the bucketed FSDP step").set(num_buckets)
            registry.gauge(
                "fsdp_overlap_prefetch",
                "prefetch depth of the bucketed FSDP step").set(prefetch)
            self._bytes = registry.counter(
                "fsdp_overlap_bytes",
                "wire bytes moved per FSDP collective leg")
            self._seconds = registry.histogram(
                "fsdp_overlap_seconds",
                "host-observed per-bucket collective latency")
            self._dispatch = registry.histogram(
                "fsdp_overlap_dispatch_seconds",
                "host latency of one bucketed FSDP step dispatch")

    def edge(self, leg: str, edge: str, bucket: int, nbytes: int,
             dep: Optional[torch.Tensor] = None) -> None:
        """One begin/end edge of a per-bucket collective: a CUDA event on
        ``dep``'s current stream, else the host's clocks now."""
        if dep is not None and dep.is_cuda:
            stamp = torch.cuda.Event(enable_timing=True)
            stamp.record(torch.cuda.current_stream(dep.device))
            stamp = (stamp, dep.device)
        else:
            stamp = (time.perf_counter(), time.time(), time.monotonic())
        self._edges.append((leg, edge, bucket, nbytes, stamp))

    def resolve(self) -> None:
        """The step's edges, in issue order, as flight events and metrics.
        An event's time is the host's clocks once a last event on its
        stream has completed, less the device time from it to that one."""
        edges, self._edges = self._edges, []
        now = None
        for *_, stamp in edges:
            if isinstance(stamp[0], torch.cuda.Event):
                last = torch.cuda.Event(enable_timing=True)
                last.record(torch.cuda.current_stream(stamp[1]))
                last.synchronize()
                now = (time.perf_counter(), time.time(), time.monotonic())
                break
        begin: dict = {}
        for leg, edge, bucket, nbytes, stamp in edges:
            if isinstance(stamp[0], torch.cuda.Event):
                back = stamp[0].elapsed_time(last) / 1e3
                stamp = tuple(t - back for t in now)
            if self.flight is not None:
                # the bucketed collectives ride the fast interconnect
                ev = self.flight.record(f"fsdp_{leg}_{edge}", bucket=bucket,
                                        nbytes=nbytes, link="nvlink")
                ev["ts"], ev["mono"] = stamp[1], stamp[2]
            if self.registry is None:
                continue
            key = (leg, bucket)
            if edge == "begin":
                begin[key] = stamp[0]
            else:
                t0 = begin.pop(key, None)
                if t0 is not None:
                    self._seconds.observe(stamp[0] - t0, leg=leg,
                                          bucket=str(bucket))
                self._bytes.inc(nbytes, leg=leg, bucket=str(bucket))

    def record_dispatch(self, seconds: float) -> None:
        if self.registry is not None:
            self._dispatch.observe(seconds)


class _Pending:
    """One bucket's gather in flight: the work handles, the gathered wire
    buffers, and what the bucket's backward needs."""

    def __init__(self, engine, bucket: int, works, outs):
        self.engine, self.bucket = engine, bucket
        self.works, self.outs = works, outs


class _BucketGather(torch.autograd.Function):
    """Forward: wait for the bucket's gather, strip the pad, cast back to
    the shards' dtypes.  Backward: hand the full gradients to the engine,
    which starts their reduce-scatter; the shards' gradients are set by
    the step once the reduce-scatters finish (so none comes back here)."""

    @staticmethod
    def forward(ctx, pend, *shards):
        ctx.pend = pend
        eng = pend.engine
        bl = eng.meta.buckets[pend.bucket]
        for w in pend.works:
            w.wait()
        if eng.obs is not None and pend.outs:
            eng.obs.edge("gather", "end", pend.bucket,
                         eng.wire_nbytes(pend.bucket), dep=pend.outs[0])
        outs = []
        for g, n, s in zip(pend.outs, bl.orig_lens, shards):
            if eng.comps[pend.bucket] is not None:
                # each rank's slot after its shard holds its exponent
                g = g.view(eng.comm.size, -1)
                eng.e_vecs[pend.bucket] = g[:, -1].to(torch.float32)
                g = g[:, :-1].reshape(-1)
            full = g[:n]
            if full.dtype != s.dtype:
                full = eng.cast(full, s.dtype, 1.0)
            outs.append(full)
        pend.works = pend.outs = None  # the wire buffers may go
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.pend.engine.scatter(ctx.pend.bucket, grads)
        return (None,) * (len(grads) + 1)


class _Engine:
    """The collectives of one step of :func:`make_fsdp_train_step`: the
    gathers under the prefetch window, the parameter views, the
    reduce-scatters, and their counters."""

    def __init__(self, comm, state: FsdpState, meta: FsdpMeta, wires,
                 grad_div: int, prefetch: int, obs=None, cobs=None):
        self.comm, self.state, self.meta = comm, state, meta
        self.obs, self.cobs = obs, cobs
        # the reduce-scatter's sum is divided by grad_div (1: global_loss)
        self.wires, self.grad_div, self.prefetch = wires, grad_div, prefetch
        self.all_gather = _all_gather()
        params = [p for _, p in state.module.named_parameters()]
        holders = _holders(state.module)
        # per bucket: (index in the bucket, module, attribute, parameter)
        # of every slot its views fill
        self.slots = [[(j, m, a, p)
                       for j, p in enumerate(params[bl.start:bl.stop])
                       for m, a in holders[id(p)]] for bl in meta.buckets]
        # per module holding a parameter: the last bucket it needs (a
        # ParameterList/Dict is never called: its parent reads it)
        parent = {c: m for m in state.module.modules()
                  for c in m.children()}
        self.needs: Dict[nn.Module, int] = {}
        for i, slots in enumerate(self.slots):
            for _, m, _, _ in slots:
                while isinstance(m, (nn.ParameterList, nn.ParameterDict)) \
                        and m in parent:
                    m = parent[m]
                self.needs[m] = max(self.needs.get(m, 0), i)
        from chainermn_tpu_torch.compression import resolve_compressor
        self.comps = [resolve_compressor(bl.compressor) if bl.compressor
                      else None for bl in meta.buckets]
        # a quantized bucket's gathered exponents (every rank's), which
        # its reduce-scatter encodes with
        self.e_vecs: Dict[int, torch.Tensor] = {}
        self.active = False
        self.hooks: list = []
        self.stats = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        # *_bytes: what this rank handed to the gathers and the
        # reduce-scatters (all-to-alls) of the step
        self.stats = {"gathers": 0, "reduce_scatters": 0, "casts": 0,
                      "max_in_flight": 0, "gather_bytes": 0,
                      "scatter_bytes": 0}

    def wire_nbytes(self, i: int) -> int:
        """Bytes bucket ``i``'s wire moves (JAX's reporting rule: the
        padded buffers, float ones at the bucket's wire width, 4 bytes an
        element otherwise)."""
        item = self.wires[i].itemsize if self.wires[i] is not None else 4
        return sum(sl * self.comm.size * item
                   for sl in self.meta.buckets[i].shard_lens)

    def cast(self, x, dtype, scale: float):
        self.stats["casts"] += 1
        return cast_scale(x, dtype, scale)

    # -- forward ---------------------------------------------------------
    def begin(self) -> None:
        """Start a microbatch: register the forward pre-hooks of the
        bucketed schedule (:meth:`restore` removes them, so the module
        carries none between steps) and issue the first gathers of the
        window."""
        self.active = True
        if self.meta.num_buckets > 1:
            self.hooks = [m.register_forward_pre_hook(self.pre_hook)
                          for m in self.needs]
        self.issued: Dict[int, _Pending] = {}
        self.done: set = set()
        self.next_issue = 0
        self.in_flight = 0
        self.scatters: list = []
        self.scattered: set = set()
        self._fill()

    def _fill(self) -> None:
        k = self.meta.num_buckets
        while self.next_issue < k and self.in_flight < self.prefetch + 1:
            self._issue(self.next_issue)
            self.next_issue += 1

    def _issue(self, i: int) -> None:
        size, wire = self.comm.size, self.wires[i]
        works, outs = [], []
        if self.obs is not None and self.state.shards[i]:
            self.obs.edge("gather", "begin", i, self.wire_nbytes(i),
                          dep=self.state.shards[i][0])
        for s in self.state.shards[i]:
            x = s.detach()
            if self.comps[i] is not None:
                # the exponent rides the gather in one slot (a power of
                # two: exact in any float wire)
                x = torch.cat([x.to(torch.float32),
                               self.state.comp[i].scale.to(torch.float32)])
            if wire is not None and x.is_floating_point() \
                    and x.dtype != wire:
                x = self.cast(x, wire, 1.0)
            out = x.new_empty(x.shape[0] * size)
            works.append(self.all_gather(out, x, group=self.comm.group,
                                         async_op=True))
            outs.append(out)
            self.stats["gathers"] += 1
            self.stats["gather_bytes"] += x.numel() * x.element_size()
        self.issued[i] = _Pending(self, i, works, outs)
        self.in_flight += 1
        self.stats["max_in_flight"] = max(self.stats["max_in_flight"],
                                          self.in_flight)

    def materialize(self, upto: int) -> None:
        """Make buckets ``..upto`` the parameters' storage, in order,
        waiting for each one's gather."""
        for i in range(upto + 1):
            if i in self.done:
                continue
            pend = self.issued.pop(i)  # the window issued it already
            fulls = _BucketGather.apply(pend, *self.state.shards[i])
            views = _packing.unpack(list(fulls),
                                    self.meta.buckets[i].pack_meta)
            for j, m, a, _ in self.slots[i]:
                m._parameters[a] = views[j]
            self.done.add(i)
            self.in_flight -= 1
            self._fill()

    def pre_hook(self, module, _args) -> None:
        if self.active:
            self.materialize(self.needs[module])

    def end_forward(self) -> None:
        """Gather what the forward did not reach, so every rank issues
        the same collectives."""
        self.materialize(self.meta.num_buckets - 1)

    # -- backward --------------------------------------------------------
    def scatter(self, i: int, grads) -> None:
        """Start bucket ``i``'s reduce-scatter (from its backward), once
        the previous bucket's is folded into its shard gradient."""
        self._fold()
        size, wire = self.comm.size, self.wires[i]
        if self.obs is not None and grads:
            self.obs.edge("scatter", "begin", i, self.wire_nbytes(i),
                          dep=grads[0])
        for j, g in enumerate(grads):
            shard = self.state.shards[i][j]
            g, _ = _packing.pad_to_multiple(g.contiguous(), size)
            x, post = g, None
            if self.comps[i] is not None:
                x, post = compressed_scatter_encode(
                    self.comm, self.comps[i], self.state.comp[i], g,
                    self.e_vecs[i], cobs=self.cobs, bucket=i)
            elif wire is not None and g.is_floating_point() \
                    and g.dtype != wire:
                x = self.cast(g, wire, 1.0)
            # every rank's slice of this rank's shard, summed in _fold()
            recv = torch.empty_like(x)
            work = dist.all_to_all_single(recv, x, group=self.comm.group,
                                          async_op=True)
            self.scatters.append((shard, work, recv, x, post, i))
            self.stats["reduce_scatters"] += 1
            self.stats["scatter_bytes"] += x.numel() * x.element_size()
        self.scattered.add(i)

    def _fold(self) -> None:
        """Wait for the reduce-scatter in flight and add its sum, in rank
        order, to the shard gradients; its full-size buffers then go."""
        scatters, self.scatters = self.scatters, []
        for k, (shard, work, recv, _, post, i) in enumerate(scatters):
            work.wait()
            if self.obs is not None and (k + 1 == len(scatters)
                                         or scatters[k + 1][5] != i):
                # the bucket's last buffer is in: its end edge
                self.obs.edge("scatter", "end", i, self.wire_nbytes(i),
                              dep=recv)
            if post is not None:
                out = post(recv)
                g = out / self.grad_div if self.grad_div != 1 else out
                shard.grad = g if shard.grad is None else shard.grad + g
                continue
            parts = recv.view(self.comm.size, -1)
            out = parts[0]
            if len(parts) > 1:
                out = out.clone()
                for part in parts[1:]:  # in rank order
                    out += part
            if out.dtype != shard.dtype:
                g = self.cast(out, shard.dtype, 1.0 / self.grad_div)
            elif self.grad_div != 1:
                g = out / self.grad_div
            else:
                g = out
            shard.grad = g if shard.grad is None else shard.grad + g

    def finish(self) -> None:
        """After a microbatch's backward: reduce-scatter zeros for buckets
        the loss did not reach, fold the last reduce-scatter, and give the
        module its placeholders back."""
        try:
            for i in range(self.meta.num_buckets):
                if i not in self.scattered:
                    self.scatter(i, [torch.zeros(n, dtype=s.dtype,
                                                 device=s.device)
                                     for s, n in zip(self.state.shards[i],
                                                     self.meta.buckets[i]
                                                     .orig_lens)])
            self._fold()
        finally:
            self.restore()

    def restore(self) -> None:
        self.active = False
        self.scatters = []
        for h in self.hooks:
            h.remove()
        self.hooks = []
        for slots in self.slots:
            for _, m, a, p in slots:
                m._parameters[a] = p


def make_fsdp_train_step(comm, loss_fn: Callable, state: FsdpState,
                         meta: FsdpMeta, has_aux: bool = False,
                         wire_dtype=None, accum_steps: int = 1,
                         global_loss: bool = False, prefetch: int = 1):
    """The stage-3 train step over the bucketed layout.

    ``loss_fn(batch) -> loss`` (or ``(loss, aux)`` with ``has_aux``, aux a
    dict of scalar tensors) runs ``state.module`` on this rank's batch,
    exactly as for :func:`~chainermn_tpu_torch.optimizers.make_train_step`:
    inside it the module's parameters are the full (gathered) ones.
    Returns ``step(batch) -> loss`` (``(loss, aux)`` with ``has_aux``);
    the state is updated in place.  ``step.stats`` counts the last step's
    collectives: ``gathers`` and ``reduce_scatters`` (one per dtype buffer
    per bucket per microbatch), ``casts`` (the wire's ``cast_scale``
    calls: four per float buffer per bucket per microbatch; a quantized
    bucket's reduce-scatter casts none), ``max_in_flight`` (the most
    gathers issued and not yet consumed, at most ``prefetch + 1``), and
    ``gather_bytes`` / ``scatter_bytes`` (the bytes this rank handed to
    the gathers and to the reduce-scatters' all-to-alls).

    ``prefetch`` (D) is the window of the bucketed schedule
    (``meta.num_buckets > 1``): bucket i's gather is issued once bucket
    i-1-D's was consumed.  ``wire_dtype`` (e.g. ``"bfloat16"``) casts each
    float shard to the wire before the all-gather and back after, and each
    gradient to the wire before the reduce-scatter and back after; a
    bucket's own ``wire_dtype`` (``fsdp_init(bucket_wire_dtypes=...)``)
    wins.  The shards and the inner optimizer's state stay in full
    precision.

    ``accum_steps=K``: K equal microbatches of the local batch
    (:mod:`~chainermn_tpu_torch.utils.accum`); each microbatch gathers and
    reduce-scatters (as JAX's scan does), the shard gradients sum and are
    divided by K once, then one update.  BatchNorm updates its running
    buffers once per microbatch (ghost batches).

    ``global_loss=True`` declares that ``loss_fn`` already reduces to the
    global objective (a sequence-parallel loss all-reduced inside it):
    the reduce-scatter's sum is then the gradient (no 1/size), and the
    loss and aux are returned as they are.  Otherwise the loss is this
    rank's mean, gradients and the returned loss and aux are world means.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if prefetch < 0:
        raise ValueError(f"prefetch must be >= 0, got {prefetch}")
    if state.world_size != comm.size or meta.world_size != comm.size:
        raise ValueError(f"the shards were cut for {state.world_size} ranks; "
                         f"this communicator has {comm.size}")
    if accum_steps > 1 and any(bl.compressor for bl in meta.buckets):
        raise NotImplementedError(
            "accum_steps > 1 with quantized buckets is not supported: "
            "error feedback would advance once per MICROBATCH, changing "
            "the accumulation semantics -- accumulate uncompressed or "
            "drop the bucket's compressor")
    default_wire = _normalize_wire(wire_dtype)
    wires = [_normalize_wire(bl.wire_dtype) if bl.wire_dtype is not None
             else default_wire for bl in meta.buckets]
    # observability is bound when the step is built: with it off, the step
    # makes no observability call
    from chainermn_tpu_torch.compression import observe as _cobs
    from chainermn_tpu_torch.observability import (
        flight_recorder as _flight, registry as _registry)
    fr = _flight.get_flight_recorder()
    reg = _registry.get_registry() if _registry.enabled() else None
    obs = _FsdpObs(fr, reg, meta.num_buckets, prefetch) \
        if (fr or reg) else None
    cobs = _cobs.get_compression_obs() \
        if any(bl.compressor for bl in meta.buckets) else None
    engine = _Engine(comm, state, meta, wires,
                     1 if global_loss else comm.size, prefetch, obs=obs,
                     cobs=cobs)
    shards = state.flat_shards()

    def micro(batch):
        engine.begin()
        try:
            if meta.num_buckets == 1:
                engine.materialize(0)
            out = loss_fn(batch)
            engine.end_forward()
        except BaseException:
            engine.restore()
            raise
        return out

    def step(batch):
        engine.reset_stats()
        for s in shards:
            s.grad = None
        if accum_steps > 1:
            loss, aux = accumulate_microbatches(
                micro, batch, accum_steps, has_aux, shards,
                after_backward=engine.finish)
        else:
            out = micro(batch)
            loss, aux = out if has_aux else (out, None)
            try:
                loss.backward()
            finally:
                engine.finish()
        state.inner.step()
        loss = loss.detach()
        if has_aux:
            aux = {k: v.detach() for k, v in aux.items()}
        if not global_loss:
            loss = comm.allreduce(loss, "mean")
            if has_aux:
                aux = comm.allreduce(aux, "mean")
        step.stats = dict(engine.stats)
        return (loss, aux) if has_aux else loss

    step.stats = dict(engine.stats)
    step.finalize = lambda: None
    if obs is None:
        return step

    def step_with_metrics(batch):
        t0 = time.perf_counter()
        try:
            out = step(batch)
            obs.record_dispatch(time.perf_counter() - t0)
        finally:
            obs.resolve()
        step_with_metrics.stats = step.stats
        return out

    step_with_metrics.stats = step.stats
    step_with_metrics.finalize = step.finalize
    return step_with_metrics


__all__ = ["BucketLayout", "FsdpMeta", "FsdpState", "fsdp_full_params",
           "fsdp_init", "fsdp_layout", "fsdp_module_params",
           "iter_fsdp_states", "load_module_params", "make_fsdp_meta",
           "make_fsdp_train_step", "unpack_full_params"]
