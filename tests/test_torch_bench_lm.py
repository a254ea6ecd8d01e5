"""The LM bench: its FLOP count, its CPU line and the ledger.

* ``lm_train_gflop_per_token`` equals the JAX bench's for several
  configurations (GQA included) and a 2*M*N*K count taken by hooks on the
  port's ``TransformerLM`` at a tiny configuration (every dense product
  counted as it runs, attention as the causal half of its two products);
* ``bench_lm --device cpu`` prints one JSON line, stamped ``bench_lm/v1``,
  with JAX's keys and the smoke mark, and ``tools.ledger ingest`` takes
  it as a ``bench_lm/v1`` artifact.
"""

import json
import os
import sys

import pytest
import torch
import torch.distributed as dist

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmarks.bench_lm import (  # noqa: E402
    lm_train_gflop_per_token as jax_gflop)
from chainermn_tpu_torch.benchmarks import bench_lm  # noqa: E402

JAX_KEYS = ("metric", "value", "unit", "seq_len", "d_model", "layers",
            "n_params_m", "train_gflop_per_token")


@pytest.mark.parametrize("cfg", [
    (8192, 2048, 8, 32768, 16, None),   # the card's configuration
    (256, 64, 2, 512, 4, None),         # the CPU smoke
    (4096, 1024, 12, 50000, 16, 4),     # GQA 4 of 16
    (2048, 512, 3, 1000, 8, 1),         # multi-query
    (100, 96, 1, 7, 6, 2)])
def test_gflop_per_token_equals_jax(cfg):
    assert bench_lm.lm_train_gflop_per_token(*cfg) == jax_gflop(*cfg)


@pytest.mark.parametrize("n_kv", [None, 2])
def test_gflop_per_token_equals_a_hooked_count(monkeypatch, n_kv):
    from chainermn_tpu_torch.models import TransformerLM
    from chainermn_tpu_torch.models import transformer
    t, d, layers, vocab, heads = 32, 64, 2, 96, 4
    model = TransformerLM(vocab=vocab, d_model=d, n_layers=layers,
                          n_heads=heads, n_kv_heads=n_kv, max_len=t,
                          attention_impl="xla", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    flops = [0]

    def dense_hook(mod, inp, out):
        x = inp[0]
        rows = x.numel() // x.shape[-1]
        flops[0] += 2 * rows * mod.weight.shape[1] * mod.weight.shape[0]

    for mod in model.modules():
        if isinstance(mod, transformer.Dense):
            mod.register_forward_hook(dense_hook)
    attend = transformer._attend

    def counted(impl, comm, q, k, v, causal):
        b, tq, h, hd = q.shape
        assert causal and b == 1
        # scores and values over the causal half, every q head
        flops[0] += 2 * 2 * (tq * k.shape[1] / 2) * h * hd
        return attend(impl, comm, q, k, v, causal)

    monkeypatch.setattr(transformer, "_attend", counted)
    with torch.no_grad():
        model(torch.zeros(1, t, dtype=torch.long))
    got = 3 * flops[0] / t / 1e9
    want = bench_lm.lm_train_gflop_per_token(t, d, layers, vocab, heads,
                                             n_kv)
    assert got == pytest.approx(want, rel=1e-12)


def test_cpu_line_has_jax_keys_and_ingests(tmp_path, capsys):
    from chainermn_tpu_torch.tools import ledger
    created = not dist.is_initialized()
    try:
        out = bench_lm.main(["--device", "cpu", "--attempts", "1"])
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(out))
    for key in JAX_KEYS:
        assert key in line, key
    assert line["smoke"] is True and line["schema"] == "bench_lm/v1"
    assert line["metric"] == "tiny_lm_cpu_smoke_train_throughput"
    assert line["train_gflop_per_token"] == round(jax_gflop(256, 64, 2, 512,
                                                             4), 4)
    assert (line["seq_len"], line["d_model"], line["layers"]) == (256, 64, 2)
    assert line["step_calls"] == 4   # 1 warm-up, 3 timed
    assert line["value"] > 0 and line["final_loss"] == line["final_loss"]
    (tmp_path / "LM_BENCH_r99.json").write_text(lines[0])
    assert ledger.main(["ingest", "--root", str(tmp_path)]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["ingested"] == 1 and summary["unknown"] == 0
