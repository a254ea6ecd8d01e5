"""Which q/k/v views the flash-attention kernels read in place.

The wgmma kernels read q, k, v and dO through TMA tensor maps built from
the tensors' base pointers and strides; the other kernels read 16-byte
vectors.  ``_kernel_view`` passes a view through when both can read it
(unit stride along D, a 16-byte aligned base, strides that are multiples
of 16 bytes, no broadcast dimension) and copies it otherwise.  These checks
need no card: they hold the view rule on CPU tensors, at every head dim
the launcher accepts.
"""

import importlib

import pytest
import torch

tfa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")

DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def _qkv(dtype, d, b=2, t=24, h=4):
    """q, k, v as a model's fused qkv projection gives them: views of one
    ``[B, T, 3 H D]`` tensor, T stride ``3 H D``."""
    gen = torch.Generator().manual_seed(d)
    qkv = torch.randn(b, t, 3 * h * d, generator=gen).to(dtype)
    return qkv, [qkv[..., i * h * d:(i + 1) * h * d].view(b, t, h, d)
                 for i in range(3)]


def test_head_dims_are_the_launchers():
    assert tfa.HEAD_DIMS == (16, 32, 64, 128)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_qkv_split_views_pass_through(d, dtype):
    qkv, views = _qkv(dtype, d)
    for x in views:
        y = tfa._kernel_view(x)
        assert y is x
        assert y.stride() == (qkv.shape[1] * qkv.shape[2], qkv.shape[2], d, 1)
        assert y.data_ptr() % 16 == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_view_one_element_in_is_copied(d, dtype):
    b, t, h = 2, 24, 4
    flat = torch.randn(b * t * h * d + 1).to(dtype)
    x = flat[1:].view(b, t, h, d)  # base off the 16-byte grid
    assert x.data_ptr() % 16 != 0
    y = tfa._kernel_view(x)
    assert y is not x and y.is_contiguous() and y.data_ptr() % 16 == 0
    assert torch.equal(y, x)


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_broadcast_and_strided_head_views_are_copied(d):
    k = torch.randn(2, 24, 1, d, dtype=torch.bfloat16)
    wide = k.expand(2, 24, 4, d)  # zero stride along a head axis of 4
    y = tfa._kernel_view(wide)
    assert y is not wide and y.is_contiguous() and torch.equal(y, wide)
    # a dimension of extent 1 may carry any stride: it is never stepped
    assert tfa._kernel_view(k) is k
    # a D stride other than 1 is copied
    t = torch.randn(2, 24, 4, 2 * d, dtype=torch.bfloat16)[..., ::2]
    y = tfa._kernel_view(t)
    assert y is not t and y.stride(3) == 1 and torch.equal(y, t)


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_kv_head_slice_of_a_wider_tensor_passes_through(d):
    """GQA k/v cut from a tensor with more heads keep their strides when
    the head stride stays a multiple of 16 bytes."""
    kv = torch.randn(2, 24, 8, d, dtype=torch.bfloat16)
    k = kv[:, :, 2:4]
    assert tfa._kernel_view(k) is k
