"""The port's sequence parallelism against the JAX package's, on the CPU.

``chainermn_tpu_torch.parallel.sequence`` on gloo worlds of 2 and 4
processes (``tests/torch_dist_worker.py`` mode ``seq``), each rank holding
its block of the sequence, against ``chainermn_tpu.parallel.sequence``
under ``shard_map`` on a CPU mesh of the same size, from the same
numpy-seeded q/k/v and cotangent (the loss ``sum(out * g)``):

* ``ring`` and ``ulysses``: output within rtol/atol 2e-5, q/k/v gradients
  within 5e-4 (``tests/test_sequence_parallel.py``'s tolerances);
* ``ring_flash`` (the port's plain flash path on the CPU) against JAX
  ``ring_attention(attn_fn=flash_attention)`` run as
  ``tests/test_flash_attention.py`` runs it (interpret mode,
  ``check_vma=False``): 3e-4 forward, 2e-3 gradients;
* causal ``ring`` over a ``split_axes(("intra",))`` sub-communicator (rings
  of half the world's ranks) against a JAX ring on that many devices;
* ``ulysses`` refuses heads the world does not divide with JAX's
  ``ValueError``; ``TransformerLM`` under ``ring_flash`` rotates the
  grouped k/v heads as they are and matches the JAX model's ``xla`` twin
  (``tests/test_transformer.py::test_gqa_ring_flash_keeps_grouped_kv``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_worker
from chainermn_tpu.models import TransformerLM as JLM
from chainermn_tpu.ops.flash_attention import flash_attention
from chainermn_tpu.parallel.sequence import ring_attention, ulysses_attention
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, T, H, D = 2, 64, 4, 16
TOL = {"ring": (2e-5, 5e-4), "ulysses": (2e-5, 5e-4),
       "ring_flash": (3e-4, 2e-3)}
GQA = dict(vocab=50, d_model=64, n_heads=4, n_kv_heads=2, max_len=128)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return {f"attn/{c}": (rng.randn(B, T, H, D) * (1.0 if c == "g" else 0.3))
            .astype(np.float32) for c in "qkvg"}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    inputs = _inputs(30 + n)
    flax_model = JLM(**GQA, n_layers=1, attention_impl="xla")
    toks = np.random.RandomState(1).randint(0, 50, (2, 128)).astype(np.int32)
    params = jax.tree.map(np.asarray, flax_model.init(jax.random.key(0),
                                                      jnp.asarray(toks)))
    inputs.update({f"gqa/var/{k}": v for k, v in
                   torch_dist_worker.flatten(params).items()})
    inputs["gqa/toks"] = toks
    inputs["gqa/cfg"] = np.asarray([GQA["vocab"], GQA["d_model"],
                                    GQA["n_heads"], GQA["n_kv_heads"],
                                    GQA["max_len"]])
    outs = torch_dist_worker.launch("seq", inputs, n,
                                    tmp_path_factory.mktemp(f"seq{n}"))
    return n, inputs, outs, (flax_model, params, toks)


def _jax_attention(n, impl, causal, inputs):
    """JAX's output and q/k/v gradients of ``sum(out * g)``, sharded
    ``n`` ways on the sequence."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    if impl == "ulysses":
        fn = lambda a, b, c: ulysses_attention(  # noqa: E731
            a, b, c, axis_name="sp", causal=causal)
    else:
        kw = {"attn_fn": flash_attention} if impl == "ring_flash" else {}
        fn = lambda a, b, c: ring_attention(  # noqa: E731
            a, b, c, axis_name="sp", causal=causal, **kw)
    sharded = jax.shard_map(fn, mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                            out_specs=P(None, "sp"), check_vma=False)
    q, k, v, g = (jnp.asarray(inputs[f"attn/{c}"]) for c in "qkvg")
    out, vjp = jax.vjp(jax.jit(sharded), q, k, v)
    return [np.asarray(a) for a in (out,) + vjp(g)]


def _blocks(a, n):
    return np.split(a, n, axis=1)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("impl", ["ring", "ulysses", "ring_flash"])
def test_attention_and_gradients_match_jax(world, impl, causal):
    n, inputs, outs, _ = world
    want = _jax_attention(n, impl, causal, inputs)
    fwd, bwd = TOL[impl]
    key = f"attn/{impl}/{int(causal)}"
    for name, w, tol in zip(("out", "dq", "dk", "dv"), want,
                            (fwd, bwd, bwd, bwd)):
        for r, blk in enumerate(_blocks(w, n)):
            np.testing.assert_allclose(outs[r][f"{key}/{name}"], blk,
                                       rtol=tol, atol=tol,
                                       err_msg=f"{key} {name} rank {r}")


def test_ring_over_a_sub_communicator(world):
    """Nodes of half the world: each node's ranks form one ring over
    split_axes(("intra",)) (rings of one rank in the world of two), each
    equal to a JAX ring on that many devices."""
    n, inputs, outs, _ = world
    m = n // 2
    want = _jax_attention(m, "ring", True, inputs)
    for r, out in enumerate(outs):
        for name, w, tol in zip(("out", "dq", "dk", "dv"), want,
                                (2e-5, 5e-4, 5e-4, 5e-4)):
            np.testing.assert_allclose(out[f"sub/{name}"],
                                       _blocks(w, m)[r % m], rtol=tol,
                                       atol=tol, err_msg=f"{name} rank {r}")


def test_ulysses_refuses_indivisible_heads_as_jax(world):
    n, _, outs, _ = world
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    bad = jnp.zeros((1, 4 * n, n + n // 2, 8))
    with pytest.raises(ValueError) as e:
        jax.shard_map(lambda a, b, c: ulysses_attention(a, b, c, "sp"),
                      mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                      out_specs=P(None, "sp"))(bad, bad, bad)
    for out in outs:
        assert str(out["attn/ulysses_refusal"]) == str(e.value)


def test_gqa_ring_flash_keeps_grouped_kv(world):
    n, _, outs, (flax_model, params, toks) = world
    want = np.asarray(flax_model.apply(params, jnp.asarray(toks)))
    for r, out in enumerate(outs):
        # n - 1 rotations of (k, v), each with the grouped heads
        np.testing.assert_array_equal(out["gqa/rotated_heads"],
                                      [GQA["n_kv_heads"]] * 2 * (n - 1))
        np.testing.assert_allclose(out["gqa/logits"], _blocks(want, n)[r],
                                   rtol=2e-3, atol=2e-3, err_msg=f"rank {r}")
