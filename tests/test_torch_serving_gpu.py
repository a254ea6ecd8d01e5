"""Serving on the card: the flash forward kernel at the engine's shapes,
and one small bf16 engine drain.

Marked ``gpu`` (the CUDA kernels have no CPU mode): skipped without a card.
Imports torch and the port only, so the card's machine (no JAX) runs it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_serving_gpu.py

``cmn_flash_fwd`` is held against its plain version on a paged cache
gathered as ``paged_attention`` gathers it: B 16, Tk 2048 (128 pages of
16), H 16, D 128, Tq 64 (a prefill chunk) and 5 (a spec verify pass at k
4), kv heads 16 and 4, offsets mixed across the rows with two idle rows at
offset 0 and a decode at the cache's last position; relative L2 within
1e-5 (float32) or 1e-2 (bf16), ``chip_smoke.py``'s phase-10 limits.
"""

import importlib
import os
import sys

import pytest
import torch

tfa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
tkv = importlib.import_module("chainermn_tpu_torch.serving.kv_cache")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
smoke = importlib.import_module("chip_smoke")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the flash kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tq", [64, 5])
@pytest.mark.parametrize("hk", [16, 4])
def test_flash_at_serving_shapes(cuda, dtype, tq, hk):
    before = tfa.flash_fwd.launches
    _, rel = smoke.serving_case(tfa, tkv, torch, cuda, dtype, tq, hk,
                                seed=tq + hk)
    assert tfa.flash_fwd.launches == before + 1
    assert rel <= smoke.FLASH_TOL[str(dtype).split(".")[1]], rel


@pytest.mark.gpu
def test_engine_drain_on_the_card(cuda):
    """A bf16 LM (D 128, GQA 2/1) through the engine: every attention of
    every pass is one ``cmn_flash_fwd`` launch, no backward kernel
    launches, every request completes and every page comes back."""
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.serving import InferenceEngine, ServingConfig
    model = TransformerLM(512, 256, 2, 2, 256, "flash", dtype=torch.bfloat16,
                          n_kv_heads=1, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(0))
    eng = InferenceEngine(model, ServingConfig(
        page_size=16, num_pages=64, max_seqs=4, chunk_tokens=16,
        max_pages_per_seq=8, cache_dtype=torch.bfloat16))
    gen = torch.Generator().manual_seed(1)
    sizes = (40, 3, 17, 64, 9, 25)
    for n in sizes:
        eng.submit(torch.randint(1, 512, (n,), generator=gen).tolist(), 12)
    tfa.reset_launch_counts()
    comps = eng.run_until_idle()
    assert tfa.launch_counts() == {"flash_fwd": 2 * eng.passes["target"],
                                   "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    assert sorted(len(c.tokens) for c in comps) == [12] * len(sizes)
    assert eng.scheduler.allocator.num_free == 64
    assert all(0 <= t < 512 for c in comps for t in c.tokens)
