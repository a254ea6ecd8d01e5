"""Weights between the flax models and the port's.

The JAX package's ``models.ResNet`` keeps its weights as flax
``variables``: ``{"params": ..., "batch_stats": ...}``, nested dicts of
arrays named by flax (``models.MLP`` has ``params`` only).  This module
maps them onto the port's ``state_dict`` (and back), taking numpy arrays
only:

* conv kernels HWIO -> OIHW; dense kernels ``[in, out]`` -> ``[out, in]``;
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, and ``batch_stats``
  ``mean``/``var`` -> the ``running_mean``/``running_var`` buffers;
* flax's automatic names are walked in the order flax created them:
  ``conv_init``, ``bn_init``, ``{Block}_{i}`` (``BottleneckBlock`` or
  ``BasicBlock``, numbered across all stages) holding ``Conv_{j}``,
  ``{Norm}_{j}`` (``BatchNorm`` or ``FusedBatchNormAct``), ``conv_proj``
  and ``norm_proj``, then ``Dense_0``;
* the MLP's ``Dense_0``, ``Dense_1``, ``Dense_2`` are the port's ``l1``,
  ``l2``, ``l3``;
* the TransformerLM's ``tok_emb``/``pos_emb`` ``embedding`` are the
  embeddings' ``weight``; each ``block_{i}`` holds ``ln_attn``, ``qkv``,
  ``proj``, ``ln_mlp``, ``up``, ``down`` (the port's ``blocks.{i}.*``);
  then ``ln_f`` and ``head``; LayerNorm ``scale`` -> ``weight``.  It has
  ``params`` only.  A MoE block (``moe_experts > 0``) holds ``moe`` in
  place of ``up`` and ``down``: ``moe/router`` is a dense layer (the
  port's ``blocks.{i}.moe.router``), and the expert stacks ``up_kernel [E,
  d, h]``, ``up_bias [E, h]``, ``down_kernel [E, h, d]`` and ``down_bias
  [E, d]`` keep flax's layout, sliced to the rows of the experts the
  port's layer holds (its expert-parallel rank's; all of them in a world
  of one).  A tensor-parallel model (``tp_size > 1``) takes a shard's
  tree (JAX's ``shard_params_tp``, one slice of its ``[tp]`` axis);
* the ViT's ``patch_embed`` is a conv with a bias; ``cls_token`` (with
  ``pooling="cls"``) and ``pos_embed`` are parameters of the same name and
  shape; each ``block_{i}`` holds the TransformerLM's six layers (the
  port's ``blocks.{i}.*``), then ``ln_f`` and ``head``.  It has ``params``
  only;
* the ResNet's ``s2d`` stem ``conv_init`` is a conv like any other
  (``[4, 4, 12, C]`` HWIO, input channels in JAX's space-to-depth order
  ``(bh, bw, c)``, which the port's ``space_to_depth`` keeps);
* the seq2seq encoder's ``Embed_0`` and ``OptimizedLSTMCell_0`` are the
  port's ``embed`` and ``lstm``, the decoder's ``embed``, ``cell`` and
  ``out`` its ``embed``, ``lstm`` and ``out``: the cell's eight kernels
  (``ii``/``if``/``ig``/``io`` ``[E, H]`` and ``hi``/``hf``/``hg``/``ho``
  ``[H, H]``) stack, transposed and in gate order i, f, g, o, into
  ``weight_ih_l0`` ``[4H, E]`` and ``weight_hh_l0`` ``[4H, H]``, the hidden
  kernels' biases into ``bias_hh_l0``, and ``bias_ih_l0`` is zero.  Both
  have ``params`` only;
* VGG's ``Conv_{i}`` and ``BatchNorm_{i}`` (13 each in VGG-16) are the
  port's ``convs.{i}`` and ``norms.{i}``, ``Dense_0`` and ``Dense_1`` its
  ``fc`` and ``classifier``;
* AlexNet's ``Conv_0``..``Conv_4`` (with ``bias``) and ``Dense_0``..
  ``Dense_2`` are ``convs.{i}`` and ``dense.{i}``; NIN's ``Conv_0``..
  ``Conv_11`` (with ``bias``) are ``convs.{i}``.  Both have ``params``
  only;
* GoogLeNet's stem ``Conv_0``..``Conv_2`` (and GoogLeNetBN's
  ``BatchNorm_0``..``BatchNorm_2``) are ``convs.{j}`` (and
  ``norms.{j}``); each block ``inc3a``..``inc5b`` holds ``Conv_{j}``
  (and ``BatchNorm_{j}``), the port's ``blocks.inc{name}.convs.{j}`` (and
  ``.norms.{j}``), six a block in GoogLeNet and seven in GoogLeNetBN; the
  aux heads ``aux4a`` and ``aux4d`` hold ``Conv_0``, ``Dense_0`` and
  ``Dense_1``, the port's ``aux.aux{name}.conv``, ``.fc`` and
  ``.classifier``; ``Dense_0`` is ``classifier``.  GoogLeNet has
  ``params`` only, GoogLeNetBN ``batch_stats`` too.

A conv with a ``bias`` leaf maps it to the port's ``bias``.  Every leaf of
the flax tree must be taken by the map, and every tensor of the port's
``state_dict`` filled.

Two more maps serve other paths: :func:`flax_stage_to_state_dict` takes
rank ``s``'s slice of the JAX pipeline's stacked stage parameters (a run
of transformer blocks, ``{"block_{i}": ...}`` with ``[S, ...]`` leaves)
into the ``state_dict`` of an ``nn.Sequential`` of the port's Blocks, and
:func:`channel_axes` gives each weight's output-channel axis in the port's
layout (the last axis of its flax leaf), which per-channel int8 serving
weights quantize along.
"""

from __future__ import annotations

import functools
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch
from torch import nn

from chainermn_tpu_torch.models.alexnet import AlexNet
from chainermn_tpu_torch.models.googlenet import AUX_AFTER, GoogLeNet
from chainermn_tpu_torch.models.mlp import MLP
from chainermn_tpu_torch.models.nin import NIN
from chainermn_tpu_torch.models.seq2seq import Seq2SeqDecoder, Seq2SeqEncoder
from chainermn_tpu_torch.models.transformer import TransformerLM
from chainermn_tpu_torch.models.vgg import VGG
from chainermn_tpu_torch.models.vit import ViT

_NORM_NAMES = ("FusedBatchNormAct", "BatchNorm")
_GATES = "ifgo"  # flax OptimizedLSTMCell's order, and torch's
_EXPERT_STACKS = ("up_kernel", "up_bias", "down_kernel", "down_bias")


def _norm_key(model: nn.Module, name: str) -> str:
    """State-dict prefix of the norm called ``name`` (a norm followed by
    an unfused ReLU sits at index 0 of an ``nn.Sequential``)."""
    mod = model.get_submodule(name)
    return f"{name}.0" if isinstance(mod, nn.Sequential) else name


def _encoder_blocks(n: int):
    """The TransformerLM's and the ViT's ``block_{i}``: ``(flax scope,
    port name, kind)`` of their six layers."""
    for i in range(n):
        for name in ("ln_attn", "qkv", "proj", "ln_mlp", "up", "down"):
            yield ((f"block_{i}", name), f"blocks.{i}.{name}",
                   "ln" if name.startswith("ln") else "dense")


def _layers(model: nn.Module):
    """``(flax scope, port name, kind)`` of every layer with weights, in
    flax's creation order; kind is "conv", "norm" (BatchNorm), "dense",
    "embed", "ln" (LayerNorm), "lstm" or "param" (a bare parameter)."""
    if isinstance(model, Seq2SeqEncoder):
        yield ("Embed_0",), "embed", "embed"
        yield ("OptimizedLSTMCell_0",), "lstm", "lstm"
        return
    if isinstance(model, Seq2SeqDecoder):
        yield ("embed",), "embed", "embed"
        yield ("cell",), "lstm", "lstm"
        yield ("out",), "out", "dense"
        return
    if isinstance(model, TransformerLM):
        yield ("tok_emb",), "tok_emb", "embed"
        yield ("pos_emb",), "pos_emb", "embed"
        for i, blk in enumerate(model.blocks):
            for name in ("ln_attn", "qkv", "proj", "ln_mlp") + (
                    ("moe",) if hasattr(blk, "moe") else ("up", "down")):
                yield ((f"block_{i}", name), f"blocks.{i}.{name}",
                       "ln" if name.startswith("ln") else
                       "moe" if name == "moe" else "dense")
        yield ("ln_f",), "ln_f", "ln"
        yield ("head",), "head", "dense"
        return
    if isinstance(model, ViT):
        yield ("patch_embed",), "patch_embed", "conv"
        if model.pooling == "cls":
            yield ("cls_token",), "cls_token", "param"
        yield ("pos_embed",), "pos_embed", "param"
        yield from _encoder_blocks(len(model.blocks))
        yield ("ln_f",), "ln_f", "ln"
        yield ("head",), "head", "dense"
        return
    if isinstance(model, MLP):
        for i in range(3):
            yield (f"Dense_{i}",), f"l{i + 1}", "dense"
        return
    if isinstance(model, VGG):
        for i in range(len(model.convs)):
            yield (f"Conv_{i}",), f"convs.{i}", "conv"
            yield ("{norm}_%d" % i,), f"norms.{i}", "norm"
        yield ("Dense_0",), "fc", "dense"
        yield ("Dense_1",), "classifier", "dense"
        return
    if isinstance(model, (AlexNet, NIN)):
        for i in range(len(model.convs)):
            yield (f"Conv_{i}",), f"convs.{i}", "conv"
        for i in range(len(getattr(model, "dense", ()))):
            yield (f"Dense_{i}",), f"dense.{i}", "dense"
        return
    if isinstance(model, GoogLeNet):
        for scope, units in [((), model)] + [((n,), b) for n, b in
                                             model.blocks.items()]:
            pre = f"blocks.{scope[0]}." if scope else ""
            for j in range(len(units.convs)):
                yield scope + (f"Conv_{j}",), f"{pre}convs.{j}", "conv"
                if units.norms is not None:
                    yield (scope + ("{norm}_%d" % j,), f"{pre}norms.{j}",
                           "norm")
        if model.aux_heads:
            for n in AUX_AFTER:
                for flax_name, port in (("Conv_0", "conv"), ("Dense_0", "fc"),
                                        ("Dense_1", "classifier")):
                    yield ((f"aux{n}", flax_name), f"aux.aux{n}.{port}",
                           "conv" if port == "conv" else "dense")
        yield ("Dense_0",), "classifier", "dense"
        return
    yield ("conv_init",), "conv_init", "conv"
    yield ("bn_init",), "bn_init", "norm"
    for i, blk in enumerate(model.blocks):
        scope = f"{type(blk).__name__}_{i}"
        for j in range(len([n for n, _ in blk.named_children()
                            if n.startswith("conv") and n[4:].isdigit()])):
            yield (scope, f"Conv_{j}"), f"blocks.{i}.conv{j}", "conv"
            yield (scope, f"{{norm}}_{j}"), f"blocks.{i}.norm{j}", "norm"
        if blk.proj:
            yield (scope, "conv_proj"), f"blocks.{i}.conv_proj", "conv"
            yield (scope, "norm_proj"), f"blocks.{i}.norm_proj", "norm"
    yield ("Dense_0",), "dense", "dense"


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _leaf_paths(tree, prefix=()):
    if not isinstance(tree, Mapping):
        return {prefix}
    return {q for k, v in tree.items() for q in _leaf_paths(v, prefix + (k,))}


def _norm_name(params) -> str:
    """Which norm class named the flax model's norm layers (the first
    ``{name}_0`` scope found, depth first)."""
    for scope, sub in params.items():
        if isinstance(sub, Mapping):
            for name in _NORM_NAMES:
                if scope == f"{name}_0":
                    return name
            found = _norm_name(sub)
            if found:
                return found
    return ""


def flax_to_state_dict(variables, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port ``model``'s ``state_dict`` (float32 CPU tensors) holding the
    flax ``variables`` of the same architecture; raises if a leaf of
    ``variables`` is left over."""
    trees = {"params": variables["params"],
             "batch_stats": variables.get("batch_stats", {})}
    norm = _norm_name(trees["params"]) or _NORM_NAMES[0]
    taken = set()

    def take(tree, scope, *leaf):
        taken.add((tree,) + scope + leaf)
        return _get(trees[tree], scope + leaf)

    sd = {}
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    for scope, name, kind in _layers(model):
        scope = tuple(s.format(norm=norm) for s in scope)
        p = functools.partial(take, "params", scope)
        if kind == "conv":
            sd[f"{name}.weight"] = t(np.asarray(p("kernel"))
                                     .transpose(3, 2, 0, 1))
            if "bias" in _get(trees["params"], scope):
                sd[f"{name}.bias"] = t(p("bias"))
        elif kind == "dense":
            sd[f"{name}.weight"] = t(np.asarray(p("kernel")).T)
            sd[f"{name}.bias"] = t(p("bias"))
        elif kind == "embed":
            sd[f"{name}.weight"] = t(p("embedding"))
        elif kind == "moe":
            lo, hi = model.get_submodule(name).expert_rows
            sd[f"{name}.router.weight"] = t(np.asarray(
                p("router", "kernel")).T)
            sd[f"{name}.router.bias"] = t(p("router", "bias"))
            for leaf in _EXPERT_STACKS:
                sd[f"{name}.{leaf}"] = t(np.asarray(p(leaf))[lo:hi])
        elif kind == "param":
            sd[name] = t(p())
        elif kind == "ln":
            sd[f"{name}.weight"] = t(p("scale"))
            sd[f"{name}.bias"] = t(p("bias"))
        elif kind == "lstm":
            cat = lambda pre, leaf: np.concatenate(  # noqa: E731
                [np.asarray(p(pre + g, leaf)).T for g in _GATES])
            sd[f"{name}.weight_ih_l0"] = t(cat("i", "kernel"))
            sd[f"{name}.weight_hh_l0"] = t(cat("h", "kernel"))
            sd[f"{name}.bias_hh_l0"] = t(cat("h", "bias"))
            sd[f"{name}.bias_ih_l0"] = torch.zeros_like(
                sd[f"{name}.bias_hh_l0"])
        else:
            s = functools.partial(take, "batch_stats", scope)
            key = _norm_key(model, name)
            sd[f"{key}.weight"] = t(p("scale"))
            sd[f"{key}.bias"] = t(p("bias"))
            sd[f"{key}.running_mean"] = t(s("mean"))
            sd[f"{key}.running_var"] = t(s("var"))
    left = sorted("/".join(q) for q in _leaf_paths(trees) - taken)
    if left:
        raise ValueError(f"flax leaves without a place in "
                         f"{type(model).__name__}: {left[:8]} "
                         f"({len(left)} in all)")
    return sd


def load_flax_variables(model: nn.Module, variables) -> nn.Module:
    """Copy flax ``variables`` into ``model`` in place (every parameter and
    buffer must be covered); returns the model."""
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    return model


def state_dict_to_flax(model: nn.Module, norm: str = _NORM_NAMES[0]):
    """The inverse: ``{"params": ..., "batch_stats": ...}`` as nested dicts
    of float32 numpy arrays, flax-named with ``norm`` as the norm class
    (``{"params": ...}`` alone for a model without BatchNorm).  A MoE
    layer gives the expert stacks it holds (its rank's slice)."""
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in model.state_dict().items()}
    params, stats = {}, {}

    def put(tree, scope, leaf):
        for s in scope[:-1]:
            tree = tree.setdefault(s, {})
        tree[scope[-1]] = leaf

    for scope, name, kind in _layers(model):
        scope = tuple(s.format(norm=norm) for s in scope)
        if kind == "conv":
            leaf = {"kernel": np.ascontiguousarray(
                sd[f"{name}.weight"].transpose(2, 3, 1, 0))}
            if f"{name}.bias" in sd:
                leaf["bias"] = sd[f"{name}.bias"]
            put(params, scope, leaf)
        elif kind == "dense":
            put(params, scope, {"kernel": np.ascontiguousarray(
                sd[f"{name}.weight"].T), "bias": sd[f"{name}.bias"]})
        elif kind == "embed":
            put(params, scope, {"embedding": sd[f"{name}.weight"]})
        elif kind == "moe":
            put(params, scope, {"router": {
                "kernel": np.ascontiguousarray(sd[f"{name}.router.weight"].T),
                "bias": sd[f"{name}.router.bias"]},
                **{leaf: sd[f"{name}.{leaf}"] for leaf in _EXPERT_STACKS}})
        elif kind == "param":
            put(params, scope, sd[name])
        elif kind == "ln":
            put(params, scope, {"scale": sd[f"{name}.weight"],
                                "bias": sd[f"{name}.bias"]})
        elif kind == "lstm":
            cell = {}
            for pre, w in (("i", "weight_ih_l0"), ("h", "weight_hh_l0")):
                for g, k in zip(_GATES, np.split(sd[f"{name}.{w}"], 4)):
                    cell[pre + g] = {"kernel": np.ascontiguousarray(k.T)}
            for g, b in zip(_GATES, np.split(sd[f"{name}.bias_hh_l0"]
                                             + sd[f"{name}.bias_ih_l0"], 4)):
                cell["h" + g]["bias"] = b
            put(params, scope, cell)
        else:
            key = _norm_key(model, name)
            put(params, scope, {"scale": sd[f"{key}.weight"],
                                "bias": sd[f"{key}.bias"]})
            put(stats, scope, {"mean": sd[f"{key}.running_mean"],
                               "var": sd[f"{key}.running_var"]})
    return {"params": params, "batch_stats": stats} if stats else \
        {"params": params}


def flax_stage_to_state_dict(stacked, stage: int) -> Dict[str, torch.Tensor]:
    """Rank ``stage``'s parameters of a pipeline whose every stage is a run
    of transformer blocks: ``stacked`` is the JAX pipeline's stacked stage
    tree (``{"block_{i}": {layer: {leaf: [S, ...]}}}``, the TransformerLM's
    block layers, numpy or JAX arrays) and the result the ``state_dict``
    (``{"{i}.{layer}.weight|bias": tensor}``, float32) of an
    ``nn.Sequential`` of the port's ``Block`` s, slice ``[stage]`` of every
    leaf through the TransformerLM's block map (dense kernels transposed,
    LayerNorm ``scale`` as ``weight``)."""
    n = len([k for k in stacked if str(k).startswith("block_")])
    if n != len(stacked) or not n:
        raise ValueError(f"a stage tree holds block_0..block_{{n-1}} only, "
                         f"got {sorted(stacked)}")
    sd = {}
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.array(np.asarray(a)[stage], np.float32))
    for (block, layer), _, kind in _encoder_blocks(n):
        tree = stacked[block][layer]
        name = f"{block.split('_')[1]}.{layer}"
        if kind == "dense":
            sd[f"{name}.weight"] = t(tree["kernel"]).T.contiguous()
        else:
            sd[f"{name}.weight"] = t(tree["scale"])
        sd[f"{name}.bias"] = t(tree["bias"])
    return sd


def channel_axes(model: nn.Module) -> Dict[str, int]:
    """``{state_dict name: axis}`` of each weight with two or more axes:
    its output channel in the port's layout, the axis the JAX package
    quantizes serving weights along (the last of the flax leaf): 0 for
    dense, conv and LSTM weights (``[out, ...]``), the feature axis (-1)
    for embeddings and bare parameters, -1 for a MoE layer's expert stacks
    (kept in flax's layout)."""
    out = {}
    for _, name, kind in _layers(model):
        if kind in ("conv", "dense"):
            out[f"{name}.weight"] = 0
        elif kind == "embed":
            out[f"{name}.weight"] = -1
        elif kind == "param":
            out[name] = -1
        elif kind == "lstm":
            out[f"{name}.weight_ih_l0"] = out[f"{name}.weight_hh_l0"] = 0
        elif kind == "moe":
            out[f"{name}.router.weight"] = 0
            out.update({f"{name}.{k}": -1 for k in _EXPERT_STACKS})
    return out
