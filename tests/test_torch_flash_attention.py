"""The port's flash attention against the JAX package's, on the CPU.

On CPU tensors the port's ``flash_attention`` runs its plain forward and its
plain backward (a port of JAX's ``_blockwise_backward``); the JAX side runs
its Pallas kernels in interpret mode with 32-row tiles (so several tiles are
folded), its backward either through the Pallas kernels (``bwd_impl=
"pallas"``) or the blockwise oracle.  Same inputs from numpy seeds, float32:
out and lse within 1e-5, gradients (of out and, through glse, of the lse)
within 1e-4 -- the two sides sum in other orders and JAX folds the softmax
tile by tile.  ``_keep_mask`` is bit-identical, and the ``ValueError``s
carry JAX's messages.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("chainermn_tpu.ops.flash_attention")
tfa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")

B, T, H, D = 2, 64, 4, 16
OUT_TOL, GRAD_TOL = 1e-5, 1e-4

CASES = {
    # name: keyword overrides of (causal=False, tq=tk=T, hk=H, d=D)
    "full": {},
    "causal": {"causal": True},
    "gqa2": {"causal": True, "hk": 2},
    "mqa": {"hk": 1},
    "cross": {"tq": 64, "tk": 96},
    "cross_causal_offsets": {"causal": True, "tq": 32, "tk": 96,
                             "offs": (64, 0)},
    "t100": {"causal": True, "tq": 100, "tk": 100, "d": 32},
    "segments": {"causal": True, "seg": True},
    "dropout": {"causal": True, "rate": 0.1},
    "offsets_scalar_glse": {"causal": True, "offs": (5, 3), "glse": True},
    "offsets_vector_glse": {"causal": True, "offs": "vector",
                            "glse": True},
    "everything": {"causal": True, "hk": 2, "seg": True, "rate": 0.2,
                   "offs": (4, 0), "glse": True, "d": 32},
}


def _case(causal=False, tq=T, tk=T, hk=H, d=D, seg=False, rate=0.0,
          offs=None, glse=False, seed=0):
    rng = np.random.RandomState(seed)
    x = {"q": rng.randn(B, tq, H, d).astype(np.float32) * 0.5,
         "k": rng.randn(B, tk, hk, d).astype(np.float32) * 0.5,
         "v": rng.randn(B, tk, hk, d).astype(np.float32),
         "g": rng.randn(B, tq, H, d).astype(np.float32),
         "glse": (rng.randn(B, H, tq).astype(np.float32) if glse
                  else np.zeros((B, H, tq), np.float32))}
    kw = {}
    if seg:
        qs = rng.randint(0, 3, (B, tq)).astype(np.int32)
        qs[0, :5] = 7  # a padding id: these rows attend to nothing
        kw.update(q_segment_ids=qs,
                  kv_segment_ids=rng.randint(0, 3, (B, tk)).astype(np.int32))
    if rate:
        kw.update(dropout_rate=rate, dropout_seed=1234 + seed)
    if offs == "vector":
        kw.update(q_offset=np.array([0, 7], np.int32),
                  kv_offset=np.array([3, 0], np.int32))
    elif offs is not None:
        kw.update(q_offset=offs[0], kv_offset=offs[1])
    blocks = {k: 32 for k, t in (("block_q", tq), ("block_k", tk))
              if t % 32 == 0}
    return x, kw, blocks, causal


def _jax(x, kw, blocks, causal, bwd_impl):
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal, return_lse=True,
                                   bwd_impl=bwd_impl, **blocks, **jkw)

    (out, lse), vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in "qkv"))
    grads = vjp((jnp.asarray(x["g"]), jnp.asarray(x["glse"])))
    return [np.asarray(a) for a in (out, lse, *grads)]


def _port(x, kw, blocks, causal):
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    q, k, v = (torch.tensor(x[n], requires_grad=True) for n in "qkv")
    out, lse = tfa.flash_attention(q, k, v, causal, return_lse=True,
                                   **blocks, **tkw)
    ((out * torch.from_numpy(x["g"])).sum()
     + (lse * torch.from_numpy(x["glse"])).sum()).backward()
    return [a.detach().numpy() for a in (out, lse, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("bwd_impl", ["pallas", "blockwise"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax(name, bwd_impl):
    x, kw, blocks, causal = _case(**CASES[name])
    want = _jax(x, kw, blocks, causal, bwd_impl)
    got = _port(x, kw, blocks, causal)
    # empty rows: output 0 and the lse sentinel on both sides
    empty = want[1] >= 1e30
    np.testing.assert_array_equal(got[1] >= 1e30, empty)
    assert not CASES[name].get("seg") or empty.any()
    for i, what in enumerate(("out", "lse", "dq", "dk", "dv")):
        a, b = got[i], want[i]
        if what == "lse":
            a, b = a[~empty], b[~empty]
        tol = OUT_TOL if i < 2 else GRAD_TOL
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                   err_msg=f"{what} ({name}, {bwd_impl})")


def test_plain_functions_match_public_path():
    """flash_forward_plain / flash_backward_plain, called directly with the
    public function's conventions, give the autograd path's values."""
    x, kw, _, causal = _case(**CASES["everything"])
    q, k, v = (torch.from_numpy(x[n]) for n in "qkv")
    qseg = torch.from_numpy(kw["q_segment_ids"])
    kseg = torch.from_numpy(kw["kv_segment_ids"])
    offs = torch.tensor([[4, 0]] * B, dtype=torch.int32)
    ctl = dict(qseg=qseg, kseg=kseg, offs=offs, seed=kw["dropout_seed"],
               rate=kw["dropout_rate"])
    out, lse = tfa.flash_forward_plain(q, k, v, causal, **ctl)
    g, glse = torch.from_numpy(x["g"]), torch.from_numpy(x["glse"])
    delta = (g * out).sum(-1).transpose(1, 2)
    grads = tfa.flash_backward_plain(q, k, v, g, lse, delta, glse, causal,
                                     block_k=16, **ctl)
    got = [out, lse, *grads]
    # the kernel wrappers take the same plain versions on CPU tensors
    wrapped = [*tfa.flash_fwd(q, k, v, causal, **ctl),
               tfa.flash_bwd_dq(q, k, v, g, lse, delta, glse, causal, **ctl),
               *tfa.flash_bwd_dkv(q, k, v, g, lse, delta, glse, causal,
                                  **ctl)]
    want = _port(x, kw, {}, causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)
    for a, b in zip(wrapped, [got[i] for i in (0, 1, 2, 3, 4)]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert all(n == 0 for n in tfa.launch_counts().values())


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.999999])
@pytest.mark.parametrize("seed", [0, 1, 123456789, 0xFFFFFFFF])
def test_keep_mask_bit_identical(seed, rate):
    q_pos = np.arange(-3, 301, dtype=np.int32)[:, None]
    k_pos = np.arange(0, 257, dtype=np.int32)[None, :]
    for bh in (0, 5, 63, 1000003):
        want = np.asarray(jfa._keep_mask(
            jnp.uint32(seed), bh, jnp.asarray(q_pos), jnp.asarray(k_pos),
            rate))
        got = tfa._keep_mask(seed, bh, torch.from_numpy(q_pos),
                             torch.from_numpy(k_pos), rate).numpy()
        np.testing.assert_array_equal(got, want)
    # with a [B, H, 1, 1] head grid, as both forward paths build it
    bh = np.arange(8).reshape(2, 4, 1, 1)
    want = np.asarray(jfa._keep_mask(
        jnp.uint32(seed), jnp.asarray(bh, jnp.int32),
        jnp.asarray(q_pos[None, None]), jnp.asarray(k_pos[None, None]),
        rate))
    got = tfa._keep_mask(seed, torch.from_numpy(bh),
                         torch.from_numpy(q_pos[None, None]),
                         torch.from_numpy(k_pos[None, None]), rate).numpy()
    np.testing.assert_array_equal(got, want)


def _errors(call):
    try:
        call()
    except ValueError as e:
        return str(e)
    return None


BAD = {
    "kv_shapes": (lambda m, q, k, v: m.flash_attention(q, k, v[:, :, :2])),
    "batch_dim": (lambda m, q, k, v: m.flash_attention(q, k[:1], v[:1])),
    "heads": (lambda m, q, k, v: m.flash_attention(q, k[:, :, :3],
                                                    v[:, :, :3])),
    "dropout_range": (lambda m, q, k, v: m.flash_attention(
        q, k, v, dropout_rate=1.0)),
    "dropout_seed": (lambda m, q, k, v: m.flash_attention(
        q, k, v, dropout_rate=0.1)),
    "offset_shape": (lambda m, q, k, v: m.flash_attention(
        q, k, v, True, q_offset=np.zeros(3, np.int32))),
    "block_q": (lambda m, q, k, v: m.flash_attention(q, k, v, block_q=48)),
    "block_k": (lambda m, q, k, v: m.flash_attention(q, k, v, block_k=40)),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_value_errors_match_jax(name):
    rng = np.random.RandomState(0)
    x = [rng.randn(B, T, H, D).astype(np.float32) for _ in range(3)]
    want = _errors(lambda: BAD[name](jfa, *map(jnp.asarray, x)))
    got = _errors(lambda: BAD[name](tfa, *map(torch.from_numpy, x)))
    assert want is not None and got == want


def test_unknown_bwd_impl_refused_as_in_jax():
    rng = np.random.RandomState(0)
    x = [rng.randn(1, 16, 2, 16).astype(np.float32) for _ in range(3)]
    with pytest.raises(ValueError) as want:
        jax.grad(lambda q: jfa.flash_attention(
            q, *map(jnp.asarray, x[1:]), bwd_impl="fused").sum())(
                jnp.asarray(x[0]))
    with pytest.raises(ValueError) as got:
        tfa.flash_attention(*map(torch.from_numpy, x), bwd_impl="fused")
    assert str(got.value) == str(want.value)


def test_work_counts():
    """FLOPs count 2*D per allowed (q, k) pair and product; the causal
    T = 8192 LM shape gives the bounds quoted for the card."""
    b, t, h, d = 1, 8192, 16, 128
    pairs = t * (t + 1) // 2
    for kind, n in (("fwd", 2), ("bwd_dkv", 4), ("bwd_dq", 3)):
        assert tfa.flash_attention_flops(b, t, t, h, d, True, kind) == \
            2 * d * n * b * h * pairs
    assert tfa.flash_attention_flops(2, 3, 5, 1, 16, False) == \
        2 * 16 * 2 * 2 * 15
    # offsets move the diagonal: q positions 10, 11 see keys 9..10, 9..11
    assert tfa._pairs(2, 4, True, q_offset=10, kv_offset=9) == 2 + 3
    assert tfa._pairs(3, 4, True, q_offset=0, kv_offset=1) == 0 + 1 + 2
    ms = tfa.flash_attention_flops(b, t, t, h, d, True, "fwd") / 989e12 * 1e3
    assert abs(ms - 0.278) < 0.001
    e = 2
    qb = b * t * h * d * e
    assert tfa.flash_attention_bytes(b, t, t, h, h, d) == \
        4 * qb + b * h * t * 4
    assert tfa.flash_attention_bytes(b, t, t, h, 4, d, torch.float32,
                                     "bwd_dq") == \
        3 * 2 * qb + 2 * 2 * qb // 4 + 2 * b * h * t * 4
