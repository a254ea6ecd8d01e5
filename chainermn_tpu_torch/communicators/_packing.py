"""Flat-buffer pack / unpack of gradient trees.

Counterpart of ``chainermn_tpu/communicators/_packing.py`` (the reference's
``pack_params``/``unpack_params``): gather every gradient into one flat
buffer per dtype group (or one buffer in a forced communication dtype), so
that a single collective moves them all, then scatter back.

A tree is a tensor, or a dict / list / tuple of trees.  Leaves are visited
as ``jax.tree.flatten`` visits them (dict keys sorted), so the buffers are
laid out exactly as the JAX package lays them out.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch


def tree_flatten(tree: Any):
    """``(leaves, treedef)``; :func:`tree_unflatten` inverts it."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([l for ls, _ in parts for l in ls],
                ("dict", keys, [d for _, d in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(t) for t in tree]
        return ([l for ls, _ in parts for l in ls],
                (type(tree), None, [d for _, d in parts]))
    return [tree], None


def tree_unflatten(treedef, leaves: List[Any]):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, subs = d
        vals = [build(s) for s in subs]
        if kind == "dict":
            return dict(zip(keys, vals))
        return kind(vals)

    return build(treedef)


def tree_map(fn, tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(l) for l in leaves])


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (numpy's spelling)."""
    return str(dtype).replace("torch.", "")


def pack(tree: Any, comm_dtype: Optional[torch.dtype] = None):
    """Flatten a tree into per-dtype flat buffers.

    Returns ``(buffers, meta)``: ``buffers`` a list of 1-D tensors (one per
    dtype group, or one in ``comm_dtype``), ``meta`` what :func:`unpack`
    needs to rebuild the tree.
    """
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        return [], (treedef, [], [])
    groups: dict = {}
    order = []  # (group_key, index_within_group, shape, orig_dtype)
    for leaf in leaves:
        key = "comm" if comm_dtype is not None else dtype_name(leaf.dtype)
        groups.setdefault(key, [])
        order.append((key, len(groups[key]), tuple(leaf.shape), leaf.dtype))
        flat = leaf.reshape(-1)
        if comm_dtype is not None and leaf.dtype != comm_dtype:
            flat = flat.to(comm_dtype)
        groups[key].append(flat)
    keys = list(groups)
    # torch.cat copies even one leaf: the collective runs in place on the
    # buffers, never on the caller's tensors
    buffers = [torch.cat(groups[k]) for k in keys]
    return buffers, (treedef, keys, order)


def pad_to_multiple(buf: torch.Tensor, m: int):
    """Pad a flat buffer with zeros so its length divides ``m`` (the
    reduce-scatter leg of the two-dimensional communicator needs it).
    Returns ``(padded, strip)``; ``strip`` slices a buffer of the padded
    length back to the original one, ``strip(padded) == buf``."""
    n = int(buf.shape[0])
    rem = (-n) % m
    if rem:
        buf = torch.cat([buf, buf.new_zeros(rem)])
    return buf, lambda b: b[:n]


def unpack(buffers: List[torch.Tensor], meta, scale: Optional[float] = None):
    """Inverse of :func:`pack`, with an optional ``*= scale`` (the
    reference's 1/size multiply).

    The scale is applied AFTER the cast back to each leaf's own dtype, in
    that dtype: with a reduced-precision wire a wire-dtype multiply would
    round the factor into the wire's mantissa before the restore."""
    treedef, keys, order = meta
    if not order:
        return tree_unflatten(treedef, [])
    sizes: dict = {k: [] for k in keys}
    for key, _, shape, _ in order:
        n = 1
        for d in shape:
            n *= d
        sizes[key].append(n)
    pieces = {k: torch.split(buf, sizes[k]) for k, buf in zip(keys, buffers)}
    leaves = []
    for key, idx, shape, dtype in order:
        piece = pieces[key][idx].reshape(shape)
        if piece.dtype != dtype:
            piece = piece.to(dtype)
        if scale is not None:
            piece = piece * torch.tensor(scale, dtype=piece.dtype,
                                         device=piece.device)
        leaves.append(piece)
    return tree_unflatten(treedef, leaves)
