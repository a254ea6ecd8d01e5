"""The card's evidence suite, its contract checked on the CPU.

* nine checks under JAX's ``tools/tpu_smoke.py`` names, in its order;
* an unknown ``--only`` name is refused (no empty-but-green document);
* a selection with no check is not green (exit 1, ``ok: false``);
* ``--only`` merges into an existing ``--out`` of the same device kind and
  not into another kind's;
* without a card the tool refuses unless ``--device cpu`` is given, and a
  CPU document says ``on_gpu: false``; it is stamped ``gpu_smoke/v1`` and
  ``tools.ledger ingest`` takes it;
* the cast check holds the port's cast against JAX's check on the same
  inputs;
* the GQA check holds out, dq, dk and dv against the plain version's
  autograd in relative L2, so a kernel returning zeros (whose output is
  within JAX's max-abs gate of the oracle) fails it;
* the T 32768 backward check and the long training steps carry the
  probe's window check, and record its launches as ``compare_launches``.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from chainermn_tpu_torch.tools import gpu_smoke
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tpu_smoke():
    spec = importlib.util.spec_from_file_location(
        "jax_tpu_smoke", os.path.join(REPO, "tools", "tpu_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _doc(path):
    with open(path) as f:
        return json.load(f)


def test_checks_are_jax_s():
    assert [n for n, _ in gpu_smoke.CHECKS] == [
        n for n, _ in _jax_tpu_smoke().CHECKS]


def test_unknown_only_is_refused():
    with pytest.raises(SystemExit, match="unknown check"):
        gpu_smoke.main(["--only", "cast_scale,flash_typo", "--device", "cpu"])


def test_empty_selection_is_not_green(tmp_path, capsys):
    out = tmp_path / "E.json"
    assert gpu_smoke.main(["--only", ",", "--device", "cpu",
                           "--out", str(out)]) == 1
    doc = _doc(out)
    assert doc["checks"] == {} and doc["ok"] is False


def test_only_merges_into_the_same_kind(tmp_path, capsys):
    out = str(tmp_path / "GPU_SMOKE_r99.json")
    assert gpu_smoke.main(["--only", "cast_scale", "--device", "cpu",
                           "--out", out]) == 0
    assert gpu_smoke.main(["--only", "flash_train_T256k", "--device", "cpu",
                           "--out", out]) == 0
    doc = _doc(out)
    assert set(doc["checks"]) == {"cast_scale", "flash_train_T256k"}
    assert doc["on_gpu"] is False and doc["device_kind"] == "cpu"
    assert doc["schema"] == "gpu_smoke/v1" and doc["ok"]
    assert "skipped" in doc["checks"]["flash_train_T256k"]
    from chainermn_tpu_torch.tools import ledger
    capsys.readouterr()
    assert ledger.main(["ingest", "--root", str(tmp_path)]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["ingested"] == 1 and summary["unknown"] == 0
    # another device kind's document is replaced, not merged
    other = dict(doc, device_kind="NVIDIA H100 80GB HBM3")
    with open(out, "w") as f:
        json.dump(other, f)
    assert gpu_smoke.main(["--only", "cast_scale", "--device", "cpu",
                           "--out", out]) == 0
    assert set(_doc(out)["checks"]) == {"cast_scale"}


def test_refuses_without_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpu_smoke.main(["--only", "cast_scale"])


def test_cast_check_matches_jax():
    got = gpu_smoke.check_cast_scale(torch.device("cpu"))
    want = _jax_tpu_smoke().check_cast_scale()
    assert got["n"] == want["n"] and got["bit_exact"]
    assert got["max_err"] == want["max_err"] == 0.0


def test_a_failing_check_is_recorded(tmp_path, monkeypatch, capsys):
    def broken(dev):
        raise AssertionError("cast_scale mismatch 1.0")

    monkeypatch.setattr(gpu_smoke, "CHECKS", [
        (n, broken if n == "cast_scale" else f)
        for n, f in gpu_smoke.CHECKS])
    out = tmp_path / "F.json"
    assert gpu_smoke.main(["--only", "cast_scale,flash_train_T256k",
                           "--device", "cpu", "--out", str(out)]) == 1
    doc = _doc(out)
    assert doc["checks"]["cast_scale"]["ok"] is False
    assert "mismatch" in doc["checks"]["cast_scale"]["error"]
    assert doc["checks"]["flash_train_T256k"]["ok"] is True
    assert doc["ok"] is False
    assert np.isfinite(doc["checks"]["cast_scale"]["wall_s"])


def test_gqa_check_holds_out_and_gradients():
    res = gpu_smoke.check_gqa_rectangular(torch.device("cpu"), Tq=128,
                                          Tkv=512)
    assert set(res["rel_l2"]) == {"out", "dq", "dk", "dv"}
    assert all(e <= gpu_smoke.FLASH_TOL for e in res["rel_l2"].values())
    assert res["fwd_max_err"] <= gpu_smoke.PARITY_FWD_TOL
    assert res["heads"] == "8q/2kv"


def test_gqa_check_fails_a_kernel_returning_zeros(monkeypatch):
    fa = gpu_smoke._fa()

    def zeros(q, k, v, causal=False):
        return (q + 0.0 * (k.float().sum() + v.float().sum())).mul(0.0)

    monkeypatch.setattr(fa, "flash_attention", zeros)
    with pytest.raises(AssertionError, match="relative L2"):
        gpu_smoke.check_gqa_rectangular(torch.device("cpu"), Tq=128)


@pytest.mark.parametrize("check", ["flash_bwd_T32k", "flash_train_T64k"])
def test_long_checks_carry_the_window_check(check):
    res = dict(gpu_smoke.CHECKS)[check](torch.device("cpu"), T=512)
    win = res["window"]
    assert set(win["rel_l2"]) == {"out", "lse", "dq", "dk", "dv"}
    assert all(e <= win["tol"] for e in win["rel_l2"].values())
    assert res["compare_launches"] == win["launches"]
