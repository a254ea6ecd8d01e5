"""Inference weights: restore, cast, quantize, broadcast.

Counterpart of ``chainermn_tpu/serving/weights.py``:

* :func:`load_inference_params` restores the newest consistent checkpoint
  generation through the port's ``create_multi_node_checkpointer``
  (:mod:`chainermn_tpu_torch.extensions.checkpoint`), or takes a live
  tree, consolidates every FSDP-sharded state in it
  (:func:`~chainermn_tpu_torch.extensions.consolidate_fsdp_checkpoint`:
  from every rank's checkpoint file, so a one-process server loads what
  the training world saved) and casts its floating leaves;
* :func:`quantize_inference_params` stores every floating weight of two or
  more axes as per-channel int8 codes and float32 scales
  (:func:`~chainermn_tpu_torch.compression.quantize_per_channel_int8`),
  about 4x fewer bytes; :func:`dequantize_inference_params` gives float32
  back, and ``load_inference_params(int8_weights=True)`` round-trips the
  weights through the codec (the artifact's precision);
* :func:`broadcast_inference_params` gives every rank root's tree, over
  the communicator, bit for bit;
* :func:`shard_params_tp` slices a TransformerLM's ``state_dict``
  Megatron-style into ``tp`` shards, JAX's slicing of its flax tree on the
  port's names and layouts.

The channel of a weight is its output channel: the JAX package takes the
last axis of the flax leaf, which for the port's ``[out, in]`` dense and
conv weights is axis 0 and for an embedding the feature axis.  A
``state_dict`` does not say which leaf is which, so the quantizers take
``channel_axes`` (:func:`chainermn_tpu_torch.weights.channel_axes` of the
model gives JAX's axes); without it every leaf is quantized along axis 0.

:func:`broadcast_inference_params` takes a planner multicast plan
(``plan=``, e.g. :func:`weights_multicast_plan` or one of
``planner.broadcast_plans``) and runs its leaf-mode stage chain without the
gradient mean.
"""

from __future__ import annotations

import torch

from chainermn_tpu_torch.communicators._packing import tree_map


_QUANT_CODES = "int8_codes"
_QUANT_SCALE = "int8_scale"


def load_inference_params(source, metas=None, *, checkpointer=None,
                          comm=None, dtype=None, int8_weights: bool = False,
                          channel_axes=None):
    """An inference parameter tree (a ``state_dict``, or any tree of
    tensors).

    ``source`` is a live tree or -- with ``checkpointer`` -- the resume
    template whose newest consistent generation is restored first.  Each
    :class:`~chainermn_tpu_torch.parallel.FsdpState` in it becomes its
    full ``{name: tensor}`` parameters
    (:func:`~chainermn_tpu_torch.extensions.consolidate_fsdp_checkpoint`;
    pass the matching ``metas``): from the checkpoint's files of every
    training rank with ``checkpointer``, or gathered over ``comm`` from
    live shards.  ``int8_weights=True`` round-trips the weights through
    the per-channel int8 codec (:func:`quantize_inference_params`, along
    ``channel_axes``) before returning float32; ``dtype`` then casts the
    floating leaves (e.g. ``torch.bfloat16``).
    """
    from chainermn_tpu_torch.extensions.checkpoint import (
        consolidate_fsdp_checkpoint)
    from chainermn_tpu_torch.parallel.fsdp import iter_fsdp_states
    state = source
    if any(True for _ in iter_fsdp_states(source)):
        if metas is None:
            raise ValueError(
                "source holds FSDP-sharded state but no FsdpMeta was "
                "given -- pass the meta(s) from fsdp_init (the sharded "
                "layout cannot be consolidated without it)")
        state = consolidate_fsdp_checkpoint(
            source, metas, checkpointer=checkpointer, comm=comm)
    elif checkpointer is not None:
        state, gen = checkpointer.resume(source)
        if gen is None:
            raise FileNotFoundError(
                f"no consistent checkpoint generation found under "
                f"{getattr(checkpointer, 'path', '?')!r} for "
                f"{getattr(checkpointer, 'name', '?')!r} -- train and "
                f"save first, or point the loader at the right path")
    if int8_weights:
        state = dequantize_inference_params(
            quantize_inference_params(state, channel_axes))
    if dtype is not None:
        state = tree_map(lambda x: x.to(dtype) if torch.is_tensor(x)
                         and x.is_floating_point() else x, state)
    return state


def broadcast_inference_params(comm, params, root: int = 0, *, plan=None):
    """Root's ``params`` on every rank of ``comm``, bit for bit.  Every
    rank passes a tree of the same structure, shapes and dtypes (the other
    ranks' values are overwritten); returns new tensors.

    ``plan`` (a leaf-packed multicast plan; build it with the same
    ``root``) runs through the planner's leaf-mode stage chain -- not
    ``execute_plan``, whose gradient mean would scale the weights by
    1/size; int8 trees from :func:`quantize_inference_params` ride it as
    they are.  Without one, one broadcast a leaf (the flat multicast)."""
    if plan is None:
        return comm.bcast(params, root=root)
    from chainermn_tpu_torch.planner.compiler import _run_leaf_plan
    plan.validate()
    if plan.packing != "leaf":
        raise ValueError(
            f"broadcast plan {plan.name!r} must use leaf packing "
            f"(arbitrary param trees); got {plan.packing!r}")
    return _run_leaf_plan(plan, comm.plan_topology(), comm, params,
                          mean=False)


def _is_matrix(x) -> bool:
    return torch.is_tensor(x) and x.ndim >= 2 and x.is_floating_point()


def quantize_inference_params(params, channel_axes=None):
    """The per-channel int8 form of a parameter tree: every floating
    tensor with two or more axes becomes ``{"int8_codes", "int8_scale"}``
    (quantized along ``channel_axes[name]`` for a ``{name: tensor}`` tree,
    else axis 0, the output channel of the port's dense and conv weights);
    vectors and scalars stay as they are (biases and norms are small and
    precision-critical)."""
    from chainermn_tpu_torch.compression.quantize import (
        quantize_per_channel_int8)
    axes = channel_axes or {}

    def leaf(x, name=None):
        if not _is_matrix(x):
            return x
        codes, scale = quantize_per_channel_int8(
            x, channel_axis=axes.get(name, 0))
        return {_QUANT_CODES: codes, _QUANT_SCALE: scale}

    if isinstance(params, dict) and all(torch.is_tensor(v)
                                        for v in params.values()):
        return {k: leaf(v, k) for k, v in params.items()}
    return tree_map(leaf, params)


def dequantize_inference_params(qparams):
    """Inverse of :func:`quantize_inference_params` (float32)."""
    from chainermn_tpu_torch.compression.quantize import dequantize_int8

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {_QUANT_CODES, _QUANT_SCALE}:
                return dequantize_int8(node[_QUANT_CODES],
                                       node[_QUANT_SCALE])
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(qparams)


def weights_multicast_plan(root: int = 0, name: str = "serving_weights",
                           hierarchical: bool = False, topology=None):
    """The weight broadcast as a planner plan: a leaf-packed ``multicast``
    over the whole world, or (``hierarchical=True``) the intra-then-inter
    two-stage form that crosses the inter-node boundary once a node
    (``planner.plans.multicast_plan``; a non-zero ``root`` then needs the
    ``topology`` to split into (inter, intra) coordinates)."""
    from chainermn_tpu_torch.planner.plans import multicast_plan

    return multicast_plan(hierarchical=hierarchical, root=root,
                          topology=topology, name=name)


def shard_params_tp(params, tp_size: int, *, n_heads: int,
                    n_kv_heads=None):
    """A :class:`~chainermn_tpu_torch.models.TransformerLM` ``state_dict``
    (``{name: tensor}``) sliced Megatron-style into ``tp_size`` shards,
    each leaf stacked on a new leading ``[tp]`` axis (rank ``t`` of the
    tensor-parallel ranks loads ``[t]`` into a ``tp_size`` model).

    Per block, as JAX's: ``qkv`` sliced by head group (q by ``n_heads``,
    k and v by ``n_kv_heads``: GQA groups stay with their queries), ``up``
    by output features, ``proj``/``down`` by input features (the port's
    weights are ``[out, in]``: columns here where JAX slices the rows of
    ``[in, out]`` kernels) with their biases divided by ``tp_size`` (the
    block adds the bias before its row-parallel sum).  Everything else --
    embeddings, layer norms, the head, a MoE layer's router and experts --
    is replicated.
    """
    tp = int(tp_size)
    n_kv = n_kv_heads or n_heads
    if tp < 1 or n_heads % tp or n_kv % tp:
        raise ValueError(
            f"tp_size ({tp}) must be >= 1 and divide n_heads "
            f"({n_heads}) and n_kv_heads ({n_kv})")

    def qkv_slices(w):
        d = w.shape[0]
        hd = d // (n_heads + 2 * n_kv)
        if hd * (n_heads + 2 * n_kv) != d:
            raise ValueError(
                f"qkv dim {d} is not (n_heads + 2*n_kv_heads) * head_dim "
                f"for n_heads={n_heads}, n_kv_heads={n_kv}")
        nq, nkv = n_heads * hd, n_kv * hd
        q, k, v = w[:nq], w[nq:nq + nkv], w[nq + nkv:]
        lq, lkv = nq // tp, nkv // tp
        return [torch.cat([q[i * lq:(i + 1) * lq], k[i * lkv:(i + 1) * lkv],
                           v[i * lkv:(i + 1) * lkv]]) for i in range(tp)]

    def col_slices(w, axis):
        n = w.shape[axis] // tp
        if n * tp != w.shape[axis]:
            raise ValueError(
                f"dim {w.shape[axis]} not divisible by tp_size {tp}")
        return list(torch.split(w, n, dim=axis))

    out = {}
    for name, w in params.items():
        parts = name.split(".")
        module = parts[-2] if len(parts) >= 2 else ""
        if module == "qkv":
            shards = qkv_slices(w)
        elif module == "up":
            shards = col_slices(w, 0)
        elif module in ("proj", "down"):
            shards = col_slices(w, 1) if parts[-1] == "weight" \
                else [w / tp] * tp
        else:
            shards = [w] * tp
        out[name] = torch.stack(shards)
    return out


__all__ = ["broadcast_inference_params", "dequantize_inference_params",
           "load_inference_params", "quantize_inference_params",
           "shard_params_tp", "weights_multicast_plan"]
