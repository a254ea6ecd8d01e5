"""The convergence ledger on the CPU.

* the four rows under JAX's names with JAX's floors (read from JAX's
  ``tools/convergence_ledger.py``), never lowered;
* an unknown check is refused;
* the ``mnist_mlp`` row (JAX's arguments: naive, 5 epochs, batch 100, 100
  units, seed 0) reaches its 0.97 floor with ``--device cpu``; the
  document is stamped ``convergence_ledger/v1`` and ``tools.ledger
  ingest`` takes it;
* a row under its floor fails the run;
* without a card the tool refuses unless ``--device cpu`` is given.
"""

import importlib.util
import json
import os

import pytest
import torch
import torch.distributed as dist

from chainermn_tpu_torch.tools import convergence_ledger as conv
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_ledger():
    spec = importlib.util.spec_from_file_location(
        "jax_convergence_ledger",
        os.path.join(REPO, "tools", "convergence_ledger.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def own_world():
    created = not dist.is_initialized()
    yield
    if created and dist.is_initialized():
        dist.destroy_process_group()


def test_rows_and_floors_are_jax_s():
    j = _jax_ledger()
    for name in ("MNIST_ACC_FLOOR", "SEQ2SEQ_BLEU_FLOOR", "RESNET_ACC_FLOOR",
                 "VIT_ACC_FLOOR"):
        assert getattr(conv, name) == getattr(j, name), name
    assert [n for n, _ in conv.CHECKS] == [
        "mnist_mlp", "seq2seq_copy_reverse",
        "tiny_resnet_synthetic_imagenet", "tiny_vit_synthetic_imagenet"]


def test_unknown_check_is_refused():
    with pytest.raises(SystemExit, match="unknown check"):
        conv.main(["--only", "mnist_mlp,imagenet_full", "--device", "cpu"])


def test_mnist_row_reaches_its_floor(tmp_path, capsys, own_world):
    out = tmp_path / "CONVERGENCE_r99.json"
    rc = conv.main(["--only", "mnist_mlp", "--device", "cpu", "--out",
                    str(out)])
    doc = json.loads(out.read_text())
    assert rc == 0 and doc["ok"], doc
    row = doc["checks"]["mnist_mlp"]
    assert row["val_accuracy"] >= 0.97 == row["floor"]
    assert (row["epochs"], row["communicator"]) == (5, "naive")
    assert doc["schema"] == "convergence_ledger/v1"
    assert doc["backend"] == "cpu"
    from chainermn_tpu_torch.tools import ledger
    capsys.readouterr()
    assert ledger.main(["ingest", "--root", str(tmp_path)]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["ingested"] == 1 and summary["unknown"] == 0


def test_a_row_under_its_floor_fails(tmp_path, monkeypatch, capsys,
                                     own_world):
    from chainermn_tpu_torch.examples import train_mnist
    real = train_mnist.main

    def one_epoch(argv):   # one epoch at 2 units: under the floor
        argv = list(argv)
        argv[argv.index("--epoch") + 1] = "1"
        argv[argv.index("--unit") + 1] = "2"
        return real(argv)

    monkeypatch.setattr(train_mnist, "main", one_epoch)
    out = tmp_path / "C.json"
    assert conv.main(["--only", "mnist_mlp", "--device", "cpu", "--out",
                      str(out)]) == 1
    row = json.loads(out.read_text())["checks"]["mnist_mlp"]
    assert row["ok"] is False and "below floor 0.97" in row["error"]


def test_refuses_without_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        conv.main(["--only", "mnist_mlp"])
