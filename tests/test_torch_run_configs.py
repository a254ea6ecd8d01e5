"""``benchmarks/run_configs.py``: the five BASELINE configs, and the new
entry points' refusal of the CPU.

* ``--device cpu`` rows of every config carry the JAX runner's keys
  (``config``, ``metric``, ``value``, ``unit``, ``devices``,
  ``communicator``, ``final_loss``) plus ``card``, ``wall_s`` and
  ``smoke``; the CPU smoke metrics end in ``_cpu_smoke`` (``mnist_mlp`` is
  the CPU config by definition and keeps its name).  The single-rank rows
  run in this process, ``seq2seq_mp`` on a gloo world of 2 and
  ``resnet50_hier`` on one of 4 (``torch_dist_worker.py`` mode
  ``configs``), every rank with the same final loss.
* From a card, ``mnist_mlp`` starts a gloo world of CPU processes: that
  path runs here with 2.
* On too few ranks the multi-rank configs raise, naming ``torchrun``; on a
  box without a card every entry point of this slice raises unless
  ``device='cpu'`` is asked for.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker
from chainermn_tpu_torch.benchmarks import run_configs
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KEYS = {"config", "metric", "value", "unit", "devices", "communicator",
        "final_loss", "card", "wall_s", "smoke"}


@pytest.fixture
def world1():
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    yield
    if created:
        dist.destroy_process_group()


def _check(row, config, devices):
    assert KEYS <= set(row), row
    assert row["config"] == config and row["devices"] == devices
    assert row["smoke"] is True and row["card"] is None
    assert np.isfinite(row["value"]) and row["value"] > 0
    assert np.isfinite(row["final_loss"])
    if config != "mnist_mlp":
        assert row["metric"].endswith("_cpu_smoke")


def test_single_rank_rows(world1, tmp_path):
    out = tmp_path / "rows.json"
    rows = run_configs.main(["--device", "cpu", "--out", str(out),
                             "--configs",
                             "vgg16_cifar_db,resnet50_xla,mnist_mlp"])
    # JAX's order, whatever the order asked for
    assert [r["config"] for r in rows] == ["mnist_mlp", "resnet50_xla",
                                           "vgg16_cifar_db"]
    for r in rows:
        _check(r, r["config"], 1)
    assert rows[0]["metric"] == "mnist_mlp_naive_cpu_train_throughput"
    assert rows[0]["communicator"] == "naive"
    assert rows[2]["communicator"] == "xla+double_buffering"
    assert json.loads(out.read_text()) == rows


@pytest.mark.parametrize("world,configs", [(2, "seq2seq_mp,mnist_mlp"),
                                           (4, "resnet50_hier")])
def test_multi_rank_rows(tmp_path, world, configs):
    outs = torch_dist_worker.launch(
        "configs", {"argv": np.asarray(f"--device cpu --configs {configs}")},
        world, tmp_path)
    rows = [json.loads(str(o["rows"])) for o in outs]
    for name, by_rank in zip(sorted(configs.split(","),
                                    key=run_configs.CONFIGS.index),
                             zip(*rows)):
        for r in by_rank:
            _check(r, name, world)
        assert len({r["final_loss"] for r in by_rank}) == 1
    if world == 4:
        assert rows[0][0]["communicator"] == "hierarchical (inter=2 x intra=2)"


def test_mnist_mlp_from_a_card_runs_on_a_cpu_world():
    row = run_configs.spawn_cpu_world(2)
    assert row["config"] == "mnist_mlp" and row["devices"] == 2
    assert row["world"] == "gloo, 2 CPU processes"
    assert np.isfinite(row["final_loss"]) and row["value"] > 0


@pytest.mark.parametrize("config,ranks", [("seq2seq_mp", 2),
                                          ("resnet50_hier", 4)])
def test_multi_rank_configs_refuse_too_few_ranks(world1, config, ranks):
    with pytest.raises(RuntimeError,
                       match=f"torchrun --nproc_per_node {ranks}"):
        run_configs.main(["--device", "cpu", "--configs", config])


@pytest.mark.parametrize("argv,err", [(["--configs", "bert"], SystemExit),
                                      (["--repeats", "0"], SystemExit),
                                      (["--tune-remat", "--configs",
                                        "resnet50_xla"], SystemExit)])
def test_flag_refusals(argv, err):
    with pytest.raises(err):
        run_configs.main(["--device", "cpu"] + argv)


def test_new_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without a CUDA card")
    from chainermn_tpu_torch.examples import train_cifar, train_parallel_conv
    from chainermn_tpu_torch.models import (
        NIN, VGG, VGG16, AlexNet, GoogLeNet, GoogLeNetBN)
    calls = [lambda: train_cifar.main(["--iterations", "1"]),
             lambda: train_parallel_conv.main(["--steps", "1"]),
             lambda: run_configs.main(["--configs", "mnist_mlp"]),
             lambda: VGG16(), lambda: VGG(cfg=(8, "M")), lambda: AlexNet(),
             lambda: NIN(), lambda: GoogLeNet(), lambda: GoogLeNetBN()]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
