"""Inference weights: restore, cast, broadcast.

Counterpart of ``chainermn_tpu/serving/weights.py``:

* :func:`load_inference_params` restores the newest consistent checkpoint
  generation through the port's ``create_multi_node_checkpointer``
  (:mod:`chainermn_tpu_torch.extensions.checkpoint`), or takes a live
  tree, and casts its floating leaves;
* :func:`broadcast_inference_params` gives every rank root's tree, over
  the communicator, bit for bit.

The JAX package's other paths raise ``NotImplementedError`` naming their
ROADMAP.md queue: FSDP consolidation and :func:`shard_params_tp` (A9),
per-channel int8 weights (A10), the planner's multicast plans (A11).
"""

from __future__ import annotations

import torch

from chainermn_tpu_torch.communicators._packing import tree_map


def _queue(what: str, queue: str):
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md Queue {queue}")


def load_inference_params(source, metas=None, *, checkpointer=None,
                          dtype=None, int8_weights: bool = False):
    """An inference parameter tree (a ``state_dict``, or any tree of
    tensors).

    ``source`` is a live tree or -- with ``checkpointer`` -- the resume
    template whose newest consistent generation is restored first.
    ``dtype`` casts the floating leaves (e.g. ``torch.bfloat16``).
    """
    if metas is not None:
        raise _queue("consolidating an FSDP-sharded state (metas=)", "A9")
    if int8_weights:
        raise _queue("int8_weights=True (per-channel int8 weights)", "A10")
    state = source
    if checkpointer is not None:
        state, gen = checkpointer.resume(source)
        if gen is None:
            raise FileNotFoundError(
                f"no consistent checkpoint generation found under "
                f"{getattr(checkpointer, 'path', '?')!r} for "
                f"{getattr(checkpointer, 'name', '?')!r} -- train and "
                f"save first, or point the loader at the right path")
    if dtype is not None:
        state = tree_map(lambda x: x.to(dtype) if torch.is_tensor(x)
                         and x.is_floating_point() else x, state)
    return state


def broadcast_inference_params(comm, params, root: int = 0, *, plan=None):
    """Root's ``params`` on every rank of ``comm``, bit for bit.  Every
    rank passes a tree of the same structure, shapes and dtypes (the other
    ranks' values are overwritten); returns new tensors."""
    if plan is not None:
        raise _queue("a planner multicast plan (plan=)", "A11")
    return comm.bcast(params, root=root)


def quantize_inference_params(params):
    raise _queue("quantize_inference_params (per-channel int8)", "A10")


def dequantize_inference_params(qparams):
    raise _queue("dequantize_inference_params (per-channel int8)", "A10")


def weights_multicast_plan(root: int = 0, name: str = "serving_weights",
                           hierarchical: bool = False, topology=None):
    raise _queue("weights_multicast_plan (the planner's multicast)", "A11")


def shard_params_tp(params, tp_size: int, *, n_heads: int,
                    n_kv_heads=None):
    raise _queue("shard_params_tp (tensor-parallel slicing)", "A9")


__all__ = ["broadcast_inference_params", "dequantize_inference_params",
           "load_inference_params", "quantize_inference_params",
           "shard_params_tp", "weights_multicast_plan"]
