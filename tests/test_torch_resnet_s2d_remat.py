"""The ResNet's space-to-depth stem and remat policies, port vs JAX.

* ``space_to_depth`` equals JAX's on the same NHWC input (the port's works
  on NCHW and keeps JAX's channel order ``(bh, bw, c)``; ``F.pixel_unshuffle``
  would give ``(c, bh, bw)``, which the test tells apart).
* A small s2d ResNet (basic and bottleneck blocks, width 8, 32x32) from
  flax's perturbed weights: train and eval logits and the updated running
  statistics within float32 1e-4 of flax's, and the parameter gradients
  within 1e-4 (the tolerance of ``test_torch_resnet.py``); the flax stem
  kernel ``[4, 4, 12, 8]`` maps as any conv and the weights round-trip
  exactly.
* ``remat_policy`` "block" and "norm" against "none" in the port: the same
  loss and gradients bit for bit (the CPU runs the plain norm, and the
  recomputed forward is the same arithmetic), the running buffers moved
  ONCE (equal to "none"'s, and moved), "block" recomputing every
  convolution of the blocks while "norm" recomputes none of them (counted
  at the ATen level), and both recomputing the blocks' norms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from chainermn_tpu.models.resnet import (
    BasicBlock as JBasic, BottleneckBlock as JBottleneck, ResNet as JResNet,
    space_to_depth as jspace_to_depth)
from chainermn_tpu_torch import weights
from chainermn_tpu_torch.models import resnet as tres
from chainermn_tpu_torch.ops.fused_norm import FusedBatchNormAct
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-4
BLOCKS = {"basic": (JBasic, tres.BasicBlock),
          "bottleneck": (JBottleneck, tres.BottleneckBlock)}


def _models(block, policy="none"):
    jb, tb = BLOCKS[block]
    return (JResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                    block_cls=jb, stem="s2d"),
            tres.ResNet(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                        block_cls=tb, stem="s2d", remat_policy=policy,
                        device="cpu"))


def _perturbed(model, x, seed=0):
    v = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(seed), jnp.asarray(x))
    rng = np.random.RandomState(seed + 1)
    noise = lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape)  # noqa
    return {"params": jax.tree.map(lambda a: jnp.asarray(noise(a),
                                                         jnp.float32),
                                   v["params"]),
            "batch_stats": jax.tree.map(lambda a: jnp.asarray(
                np.abs(noise(a)) + 0.05, jnp.float32), v["batch_stats"])}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 4, 6, 5)])
def test_space_to_depth_matches_jax(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jspace_to_depth(jnp.asarray(x), 2))
    got = tres.space_to_depth(_nchw(x), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    # PyTorch's own op orders the channels (c, bh, bw): not JAX's
    other = F.pixel_unshuffle(_nchw(x), 2).permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(other, want)
    with pytest.raises(ValueError, match="not divisible"):
        tres.space_to_depth(torch.zeros(1, 3, 5, 4), 2)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_s2d_logits_stats_and_grads_match_flax(block):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, size=2)
    jmodel, model = _models(block)
    v = _perturbed(jmodel, x)
    assert v["params"]["conv_init"]["kernel"].shape == (4, 4, 12, 8)

    def jloss(p):
        logits, mut = jmodel.apply(
            {"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
            train=True, mutable=["batch_stats"])
        loss = -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(2), y])
        return loss, (logits, mut["batch_stats"])

    (_, (jlogits, jstats)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(v["params"])
    weights.load_flax_variables(model, v)
    assert tuple(model.conv_init.weight.shape) == (8, 12, 4, 4)
    model.train()
    logits = model(_nchw(x))
    _close(logits.detach(), jlogits, "train logits")
    F.cross_entropy(logits, torch.from_numpy(y)).backward()
    got = _flat(weights.state_dict_to_flax(model, norm="BatchNorm"))
    for k, want in _flat({"batch_stats": jstats}).items():
        _close(got[k], want, k)
    grads = {k: p.grad for k, p in model.named_parameters()}
    gmodel = _models(block)[1]
    with torch.no_grad():
        for k, p in gmodel.named_parameters():
            p.copy_(grads[k])
    got = _flat(weights.state_dict_to_flax(gmodel, norm="BatchNorm")
                ["params"])
    for k, want in _flat(jgrads).items():
        _close(got[k], want, k)
    # eval mode with the updated running statistics
    model.eval()
    jeval = jax.jit(functools.partial(jmodel.apply, train=False))(
        {"params": v["params"], "batch_stats": jstats}, jnp.asarray(x))
    _close(model(_nchw(x)).detach(), jeval, "eval logits")


def test_s2d_weights_round_trip():
    x = np.zeros((1, 32, 32, 3), np.float32)
    jmodel, model = _models("bottleneck")
    v = _perturbed(jmodel, x, seed=5)
    weights.load_flax_variables(model, v)
    back = _flat(weights.state_dict_to_flax(model, norm="BatchNorm"))
    want = _flat(v)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


class _Counts(TorchDispatchMode):
    """Convolutions dispatched at the ATen level (a convolution that a
    selective checkpoint serves from its cache never reaches here)."""

    def __init__(self):
        super().__init__()
        self.convs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.convolution.default,
                    torch.ops.aten._convolution.default):
            self.convs += 1
        return func(*args, **(kwargs or {}))


def _step(block, policy):
    gen = torch.Generator().manual_seed(0)
    jb, tb = BLOCKS[block]
    model = tres.ResNet(stage_sizes=(1, 2), num_filters=8, num_classes=10,
                        block_cls=tb, remat_policy=policy, device="cpu",
                        generator=gen)
    model.train()
    norms = [0]
    for m in model.modules():
        if isinstance(m, FusedBatchNormAct):
            m.register_forward_hook(
                lambda *_: norms.__setitem__(0, norms[0] + 1))
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(4, 3, 32, 32).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, size=4))
    before = {k: b.clone() for k, b in model.named_buffers()}
    counts = _Counts()
    with counts:
        loss = F.cross_entropy(model(x), y)
        fwd_norms = norms[0]
        loss.backward()
    return dict(loss=float(loss.detach()), before=before,
                grads={k: p.grad for k, p in model.named_parameters()},
                buffers=dict(model.named_buffers()), convs=counts.convs,
                fwd_norms=fwd_norms, norms=norms[0],
                block_norms=sum(isinstance(m, FusedBatchNormAct)
                                for b in model.blocks for m in b.modules()),
                block_convs=sum(isinstance(m, tres.Conv)
                                for b in model.blocks for m in b.modules()))


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_remat_policies_equal_none(block):
    ref = _step(block, "none")
    assert ref["norms"] == ref["fwd_norms"]  # nothing recomputed
    for policy in ("block", "norm"):
        got = _step(block, policy)
        assert got["loss"] == ref["loss"], policy
        for k, g in ref["grads"].items():
            assert torch.equal(got["grads"][k], g), (policy, k)
        for k, b in ref["buffers"].items():
            # moved once: the recomputed forward left them alone
            assert torch.equal(got["buffers"][k], b), (policy, k)
            if "running" in k:
                assert not torch.equal(b, got["before"][k]), k
        # both recompute the blocks' norms in the backward pass
        assert got["norms"] == ref["norms"] + got["block_norms"], policy
        # "block" recomputes the blocks' convolutions, "norm" keeps them
        extra = got["block_convs"] if policy == "block" else 0
        assert got["convs"] == ref["convs"] + extra, policy
