"""The long-context probe on the CPU.

* ``bench_flash_64k --device cpu --T 512`` records every stage (JAX's
  four and the port's window check), stamped ``flash_64k_probe/v1``, and
  ``tools.ledger ingest`` takes the document; a failing stage is recorded
  with ``ok: false`` and the exit code is non-zero, the other stages run;
  the CPU refuses a T whose plain scores it could not hold.
* The window identity at T 512 through the plain version: the last W rows
  of out, lse and dq and the dk/dv rows of the last W keys, from the whole
  sequence (``flash_attention``: on CPU tensors the plain forward and the
  plain backward), equal the plain forward's autograd on those W queries
  alone with offsets (T - W, 0): within 1e-5 in float32 and the bf16
  tolerance in bf16; a wrong offset breaks it.
* The probe's forward at T 512 and its window's offset rule against the
  JAX package's flash attention (interpret-mode Pallas) on the same
  inputs.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.ops.flash_attention import flash_attention as jflash
from chainermn_tpu_torch.benchmarks import bench_flash_64k as probe
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

STAGES = {"alloc_on_device", "forward", "forward_backward", "train_step",
          "window"}
CPU = torch.device("cpu")


def _run(tmp_path, capsys, *extra):
    out = tmp_path / "FLASH_64K_r99.json"
    rc = probe.main(["--device", "cpu", "--T", "512", "--out", str(out),
                     *extra])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    doc = json.loads(out.read_text())
    assert json.loads(line) == doc
    return rc, doc


def test_every_stage_recorded_and_ingested(tmp_path, capsys):
    from chainermn_tpu_torch.tools import ledger
    rc, doc = _run(tmp_path, capsys)
    assert rc == 0 and doc["ok"]
    assert set(doc["stages"]) == STAGES
    assert all(s["ok"] for s in doc["stages"].values())
    assert (doc["B"], doc["T"], doc["H"], doc["D"]) == (1, 512, 4, 128)
    assert doc["schema"] == "flash_64k_probe/v1" and doc["backend"] == "cpu"
    step = doc["stages"]["train_step"]
    assert step["weight_delta_norm"] > 0 and len(set(step["losses"])) == 3
    assert "host_ms" in doc["stages"]["forward"]
    assert ledger.main(["ingest", "--root", str(tmp_path)]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["ingested"] == 1 and summary["unknown"] == 0


def test_a_failing_stage_is_recorded_and_fails_the_run(tmp_path, capsys,
                                                        monkeypatch):
    def broken(*a, **k):
        raise AssertionError("zero weight update: broken backward")

    monkeypatch.setattr(probe, "train_step_stage", broken)
    rc, doc = _run(tmp_path, capsys)
    assert rc == 1 and doc["ok"] is False
    assert set(doc["stages"]) == STAGES
    bad = doc["stages"]["train_step"]
    assert bad["ok"] is False and "broken backward" in bad["error"]
    assert all(s["ok"] for n, s in doc["stages"].items()
               if n != "train_step")


def test_cpu_refuses_a_long_sequence():
    with pytest.raises(SystemExit, match="T 8192 on the CPU"):
        probe.main(["--device", "cpu", "--T", "8192"])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, probe.WINDOW_TOL)])
@pytest.mark.parametrize("window", [64, 256])
def test_window_identity_on_the_cpu(dtype, tol, window):
    q, k, v, g = probe.operands(CPU, (1, 512, 4, 128), 4, seed=5,
                                dtype=dtype)
    res = probe.window_check(q, k, v, g, window=window, tol=tol)
    assert set(res["rel_l2"]) == {"out", "lse", "dq", "dk", "dv"}
    assert all(e <= tol for e in res["rel_l2"].values()), res
    # on CPU tensors the forward IS the plain forward: out and lse exact
    assert res["rel_l2"]["out"] == 0 and res["rel_l2"]["lse"] == 0


def test_window_identity_needs_the_offset(monkeypatch):
    """Dropping the (T - W) offset breaks the identity: the check can
    fail."""
    q, k, v, g = probe.operands(CPU, (1, 512, 4, 64), 4, seed=6,
                                dtype=torch.float32)
    fa = probe._fa()
    plain = fa.flash_forward_plain
    monkeypatch.setattr(fa, "flash_forward_plain",
                        lambda *a, offs=None, **kw: plain(*a, **kw))
    with pytest.raises(AssertionError, match="window check over"):
        probe.window_check(q, k, v, g, window=64, tol=1e-5)


def test_probe_forward_and_window_match_jax():
    """The forward at T 512 and the window's offset rule against the JAX
    package's flash attention (Pallas in interpret mode, 128-row tiles):
    JAX's window (q offset T - W) is the port's plain window."""
    t, w = 512, 128
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(1, t, 4, 128).astype(np.float32) * 0.5
               for _ in range(3))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, causal=True, block_q=128,
                             block_k=128))
    want_w = np.asarray(jflash(jq[:, -w:], jk, jv, causal=True,
                               block_q=128, block_k=128, q_offset=t - w))
    np.testing.assert_allclose(want_w, want[:, -w:], rtol=1e-5, atol=1e-5)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    assert probe.forward_stage(qt, kt, vt, True)["finite"]
    fa = probe._fa()
    got = fa.flash_attention(qt, kt, vt, causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    offs = torch.tensor([[t - w, 0]], dtype=torch.int32)
    got_w, _ = fa.flash_forward_plain(qt[:, -w:], kt, vt, True, offs=offs)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=1e-5, atol=1e-5)
