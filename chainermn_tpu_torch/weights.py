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
  ``params`` only;
* the seq2seq encoder's ``Embed_0`` and ``OptimizedLSTMCell_0`` are the
  port's ``embed`` and ``lstm``, the decoder's ``embed``, ``cell`` and
  ``out`` its ``embed``, ``lstm`` and ``out``: the cell's eight kernels
  (``ii``/``if``/``ig``/``io`` ``[E, H]`` and ``hi``/``hf``/``hg``/``ho``
  ``[H, H]``) stack, transposed and in gate order i, f, g, o, into
  ``weight_ih_l0`` ``[4H, E]`` and ``weight_hh_l0`` ``[4H, H]``, the hidden
  kernels' biases into ``bias_hh_l0``, and ``bias_ih_l0`` is zero.  Both
  have ``params`` only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from chainermn_tpu_torch.models.mlp import MLP
from chainermn_tpu_torch.models.seq2seq import Seq2SeqDecoder, Seq2SeqEncoder
from chainermn_tpu_torch.models.transformer import TransformerLM

_NORM_NAMES = ("FusedBatchNormAct", "BatchNorm")
_GATES = "ifgo"  # flax OptimizedLSTMCell's order, and torch's
_PARAMS_ONLY = (MLP, TransformerLM, Seq2SeqEncoder, Seq2SeqDecoder)


def _norm_key(model: nn.Module, name: str) -> str:
    """State-dict prefix of the norm called ``name`` (a norm followed by
    an unfused ReLU sits at index 0 of an ``nn.Sequential``)."""
    mod = model.get_submodule(name)
    return f"{name}.0" if isinstance(mod, nn.Sequential) else name


def _layers(model: nn.Module):
    """``(flax scope, port name, kind)`` of every layer with weights, in
    flax's creation order; kind is "conv", "norm" (BatchNorm), "dense",
    "embed", "ln" (LayerNorm) or "lstm"."""
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
        for i in range(len(model.blocks)):
            for n in ("ln_attn", "qkv", "proj", "ln_mlp", "up", "down"):
                yield ((f"block_{i}", n), f"blocks.{i}.{n}",
                       "ln" if n.startswith("ln") else "dense")
        yield ("ln_f",), "ln_f", "ln"
        yield ("head",), "head", "dense"
        return
    if isinstance(model, MLP):
        for i in range(3):
            yield (f"Dense_{i}",), f"l{i + 1}", "dense"
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


def _norm_name(params) -> str:
    """Which norm class named the flax blocks' norm layers."""
    for scope, sub in params.items():
        if scope.startswith(("BottleneckBlock_", "BasicBlock_")):
            for name in _NORM_NAMES:
                if f"{name}_0" in sub:
                    return name
    return _NORM_NAMES[0]


def flax_to_state_dict(variables, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port ``model``'s ``state_dict`` (float32 CPU tensors) holding the
    flax ``variables`` of the same architecture."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    norm = _norm_name(params)
    sd = {}
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    for scope, name, kind in _layers(model):
        scope = tuple(s.format(norm=norm) for s in scope)
        p = _get(params, scope)
        if kind == "conv":
            sd[f"{name}.weight"] = t(np.asarray(p["kernel"])
                                     .transpose(3, 2, 0, 1))
        elif kind == "dense":
            sd[f"{name}.weight"] = t(np.asarray(p["kernel"]).T)
            sd[f"{name}.bias"] = t(p["bias"])
        elif kind == "embed":
            sd[f"{name}.weight"] = t(p["embedding"])
        elif kind == "ln":
            sd[f"{name}.weight"] = t(p["scale"])
            sd[f"{name}.bias"] = t(p["bias"])
        elif kind == "lstm":
            cat = lambda pre, leaf: np.concatenate(  # noqa: E731
                [np.asarray(p[pre + g][leaf]).T for g in _GATES])
            sd[f"{name}.weight_ih_l0"] = t(cat("i", "kernel"))
            sd[f"{name}.weight_hh_l0"] = t(cat("h", "kernel"))
            sd[f"{name}.bias_hh_l0"] = t(cat("h", "bias"))
            sd[f"{name}.bias_ih_l0"] = torch.zeros_like(
                sd[f"{name}.bias_hh_l0"])
        else:
            s = _get(stats, scope)
            key = _norm_key(model, name)
            sd[f"{key}.weight"] = t(p["scale"])
            sd[f"{key}.bias"] = t(p["bias"])
            sd[f"{key}.running_mean"] = t(s["mean"])
            sd[f"{key}.running_var"] = t(s["var"])
    return sd


def load_flax_variables(model: nn.Module, variables) -> nn.Module:
    """Copy flax ``variables`` into ``model`` in place (every parameter and
    buffer must be covered); returns the model."""
    model.load_state_dict(flax_to_state_dict(variables, model), strict=True)
    return model


def state_dict_to_flax(model: nn.Module, norm: str = _NORM_NAMES[0]):
    """The inverse: ``{"params": ..., "batch_stats": ...}`` as nested dicts
    of float32 numpy arrays, flax-named with ``norm`` as the norm class
    (``{"params": ...}`` alone for the MLP and the TransformerLM)."""
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
            put(params, scope, {"kernel": np.ascontiguousarray(
                sd[f"{name}.weight"].transpose(2, 3, 1, 0))})
        elif kind == "dense":
            put(params, scope, {"kernel": np.ascontiguousarray(
                sd[f"{name}.weight"].T), "bias": sd[f"{name}.bias"]})
        elif kind == "embed":
            put(params, scope, {"embedding": sd[f"{name}.weight"]})
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
    if isinstance(model, _PARAMS_ONLY):
        return {"params": params}
    return {"params": params, "batch_stats": stats}
