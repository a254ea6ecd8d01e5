"""The cast_scale kernel's plain version against the JAX package's kernel.

``cast_scale_plain`` (what the port's ``cast_scale`` runs on a CPU tensor,
and what the CUDA kernel is held to on the card) must give the bits of
``chainermn_tpu.ops.cast_scale`` -- the Pallas kernel, run in interpret mode
on the CPU as ``tests/test_ops.py`` runs it -- for every (source,
destination) pair and ``None``, lengths 1 to 33000, 2-D shapes, scales 1,
1/8 and 1/3, and values past float16's range (which must become inf).
NaN payloads are not part of the contract (bfloat16 rounding canonicalizes
them differently): NaN positions must agree, the other bits exactly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops import cast_scale as jcast

tcs = importlib.import_module("chainermn_tpu_torch.ops.cast_scale")

DTYPES = ["float32", "bfloat16", "float16"]
SCALES = [1.0, 0.125, 1.0 / 3.0]


def _source(n, seed):
    """randn over several decades, with values past float16's range, a
    float16 subnormal and a NaN."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n).astype(np.float32) * np.float32(10.0) ** rng.randint(
        -3, 5, n)
    x[::13] = 7e4
    x[5::17] = -7e4
    x[3::19] = 3e-8
    x[7::23] = np.nan
    return x


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16
                  ).numpy()


def _check(got: torch.Tensor, want, what):
    want = np.asarray(want)
    assert str(got.dtype) == f"torch.{want.dtype}", what
    assert tuple(got.shape) == want.shape, what
    nan = torch.isnan(got).numpy()
    np.testing.assert_array_equal(nan, np.isnan(want.astype(np.float32)),
                                  err_msg=what)
    want_bits = want.view(np.int32 if want.dtype.itemsize == 4 else np.int16)
    np.testing.assert_array_equal(_bits(got)[~nan], want_bits[~nan],
                                  err_msg=what)


@pytest.mark.parametrize("dst", DTYPES + [None])
@pytest.mark.parametrize("src", DTYPES)
def test_plain_matches_jax_bit_exact(src, dst):
    for i, n in enumerate((1, 127, 128, 1000, 33000)):
        x32 = _source(n, seed=i)
        x = _torch(x32, src)
        jx = jnp.asarray(x32).astype(jnp.dtype(src))
        for scale in SCALES:
            got = tcs.cast_scale(x, dst, scale)
            want = jcast(jx, None if dst is None else jnp.dtype(dst), scale)
            _check(got, want, f"{src}->{dst} n={n} scale={scale}")
    # a 2-D buffer keeps its shape
    x32 = _source(13 * 17, seed=9).reshape(13, 17)
    got = tcs.cast_scale(_torch(x32, src), dst, 3.0)
    want = jcast(jnp.asarray(x32).astype(jnp.dtype(src)),
                 None if dst is None else jnp.dtype(dst), 3.0)
    _check(got, want, f"{src}->{dst} 2-D")


def test_overflow_to_inf_and_none_keeps_the_dtype():
    x = torch.tensor([7e4, -7e4, 65504.0, 65519.0, 65520.0])
    y = tcs.cast_scale(x, torch.float16, 1.0)
    assert y.tolist() == [float("inf"), float("-inf"), 65504.0, 65504.0,
                          float("inf")]
    assert tcs.cast_scale(x, None, 0.5).dtype == torch.float32
    assert tcs.cast_scale(x, "bfloat16", 1.0).dtype == torch.bfloat16


def test_wrapper_checks_and_counts_no_launch_on_the_cpu():
    tcs.reset_launch_counts()
    x = torch.ones(4, 4)
    tcs.cast_scale(x, torch.float16, 2.0)
    assert tcs.launch_counts() == {"cast_scale": 0}
    with pytest.raises(ValueError, match="contiguous"):
        tcs.cast_scale(x.t(), torch.float16, 1.0)
    with pytest.raises(ValueError, match="not one of"):
        tcs.cast_scale(x.double(), torch.float16, 1.0)
    with pytest.raises(ValueError, match="not one of"):
        tcs.cast_scale(x, torch.int8, 1.0)
    with pytest.raises(ValueError, match="not supported"):
        tcs.cast_scale(x.to("meta"), torch.float16, 1.0)


def test_bytes_and_build_key():
    from chainermn_tpu_torch.ops import _build
    assert tcs.cast_scale_bytes(10, torch.float32, torch.float16) == 60
    path = _build.library_path("cast_scale")
    assert path.parent == _build.BUILD and path.name.startswith(
        "libcast_scale-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
