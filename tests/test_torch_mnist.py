"""The MNIST slice: the port's MLP, data and example against the JAX package.

* ``models.MLP`` from flax-initialised weights (through ``weights.py``)
  gives flax's logits at 1e-5 (float32 matrix products summed in another
  order), and its weights convert back to flax's tree bit for bit.
* ``make_classification`` (numpy only) is bit-identical to the JAX
  package's; ``PrefetchIterator`` yields the JAX one's batches and epoch
  flags.
* ``LogReport``/``PrintReport``/``Evaluator`` and the trainer's extension
  order.
* ``examples/train_mnist.py`` at ``--unit 16 --epoch 1 --device cpu`` on a
  2-process gloo world with ``--communicator hierarchical
  --double-buffering``: finite losses, validation accuracy above chance,
  and the same validation metrics on both ranks.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker
from chainermn_tpu.datasets import PrefetchIterator as JPrefetch
from chainermn_tpu.datasets import make_classification as jmake
from chainermn_tpu.iterators import SerialIterator as JIter
from chainermn_tpu.models import MLP as JMLP
from chainermn_tpu_torch import weights
from chainermn_tpu_torch.datasets import PrefetchIterator as TPrefetch
from chainermn_tpu_torch.datasets import make_classification as tmake
from chainermn_tpu_torch.iterators import SerialIterator as TIter
from chainermn_tpu_torch.models import MLP
from chainermn_tpu_torch.runtime.bootstrap import init_distributed
from chainermn_tpu_torch.training import Trainer, extensions
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("units", [16, 1000])
def test_mlp_forward_matches_flax(units):
    rng = np.random.RandomState(0)
    x = rng.randn(5, 28, 28).astype(np.float32)  # flattened by both
    variables = JMLP(units, 10).init(jax.random.key(1), jnp.asarray(x))
    want = np.asarray(JMLP(units, 10).apply(variables, jnp.asarray(x)))
    model = MLP(units, 10, device="cpu")
    weights.load_flax_variables(model, jax.tree.map(np.asarray, variables))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = weights.state_dict_to_flax(model)
    flat_back = torch_dist_worker.flatten(back)
    flat_want = torch_dist_worker.flatten(jax.tree.map(np.asarray,
                                                       variables))
    assert flat_back.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(flat_back[k], flat_want[k])


def test_mlp_init_is_flax_shaped_and_seeded():
    a = MLP(32, 10, device="cpu", generator=torch.Generator().manual_seed(0))
    b = MLP(32, 10, device="cpu", generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert a.l1.weight.shape == (32, 784) and a.l3.weight.shape == (10, 32)
    assert float(a.l1.bias.detach().abs().sum()) == 0.0
    # lecun_normal truncated at 2 std: |w| <= 2 / (0.8796 sqrt(fan_in))
    bound = 2 / (0.87962566 * 784 ** 0.5)
    assert float(a.l1.weight.detach().abs().max()) <= bound + 1e-6


@pytest.mark.parametrize("kw", [
    dict(n=100, dim=784, n_classes=10, noise=4.0, seed=0),
    dict(n=37, dim=12, n_classes=3, scale=2.0, seed=5, class_seed=7),
    dict(n=8, dim=48, n_classes=4, image_shape=(3, 4, 4), seed=1)])
def test_make_classification_is_bit_identical(kw):
    got, want = tmake(**kw), jmake(**kw)
    assert len(got) == len(want)
    for a, b in zip(got._arrays, want._arrays):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_prefetch_iterator_matches_jax():
    ds = tmake(n=23, dim=5, n_classes=3, seed=2)
    t = TPrefetch(TIter(ds, 4, seed=3), prefetch=2, workers=2)
    j = JPrefetch(JIter(ds, 4, seed=3), prefetch=2, workers=2)
    try:
        for _ in range(14):  # across several epochs
            for a, b in zip(t.next(), j.next()):
                np.testing.assert_array_equal(a, b)
            assert (t.epoch, t.is_new_epoch, t.epoch_detail,
                    t.iteration) == (j.epoch, j.is_new_epoch,
                                     j.epoch_detail, j.iteration)
    finally:
        t.close()
        j.close()
    assert not TPrefetch.rewindable


class _Updater:
    """Three iterations per epoch; observations 1, 2, 3, 4, ..."""

    def __init__(self, comm):
        self.iteration, self.comm = 0, comm

    epoch = property(lambda self: self.iteration // 3)
    is_new_epoch = property(lambda self: self.iteration % 3 == 0)

    def update(self):
        self.iteration += 1
        return {"main/loss": torch.tensor(float(self.iteration))}

    def finalize(self):
        self.finalized = True


class _Comm:
    rank, size, device = 0, 1, torch.device("cpu")


def test_reports_evaluator_and_extension_order(tmp_path):
    calls = []

    class Eval(extensions.Evaluator):
        def evaluate(self):
            calls.append("validation")
            return {"loss": 0.5}

    up = _Updater(_Comm())
    trainer = Trainer(up, (2, "epoch"), log_trigger=None, out=str(tmp_path))
    out = io.StringIO()
    log = extensions.LogReport()
    trainer.extend(extensions.PrintReport(["epoch", "main/loss",
                                           "validation/loss"], out=out))
    trainer.extend(log)
    trainer.extend(Eval(TIter(tmake(n=4, dim=2), 2, repeat=False),
                        lambda b: {}, _Comm()))
    trainer.extend(lambda tr: calls.append("every"), trigger=(1, "iteration"),
                   name="every")
    trainer.run()
    assert trainer.get_extension("LogReport") is log
    assert up.finalized
    # the evaluator (priority 60) ran before LogReport (50) averaged
    assert [r["main/loss"] for r in log.log] == [2.0, 5.0]
    assert [r["validation/loss"] for r in log.log] == [0.5, 0.5]
    assert [r["epoch"] for r in log.log] == [1, 2]
    lines = out.getvalue().splitlines()
    assert lines[0].split() == ["epoch", "main/loss", "validation/loss"]
    assert [float(v) for v in lines[2].split()] == [2, 5, 0.5]
    assert calls.count("every") == 6 and calls.count("validation") == 2
    assert (tmp_path / "log").read_text().count("main/loss") == 2
    with pytest.raises(ValueError, match="rewindable"):
        extensions.Evaluator(TPrefetch(TIter(tmake(n=4, dim=2), 2)),
                             lambda b: {}, _Comm())


@pytest.fixture(scope="module")
def mnist_world(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("mnist")
    argv = (f"--unit 16 --epoch 1 --device cpu --communicator hierarchical "
            f"--double-buffering --out {out_dir}")
    return torch_dist_worker.launch("mnist", {"argv": np.asarray(argv)}, 2,
                                    out_dir)


def test_example_trains_on_a_gloo_world(mnist_world):
    r0, r1 = mnist_world
    for out in mnist_world:
        for k in ("main/loss", "main/accuracy", "validation/loss",
                  "validation/accuracy"):
            assert out[f"log/{k}"].shape == (1,) and np.all(
                np.isfinite(out[f"log/{k}"])), k
        assert out["log/validation/accuracy"][0] > 0.5  # chance is 0.1
        assert out["log/main/loss"][0] < np.log(10)
    for k in ("validation/loss", "validation/accuracy", "main/loss"):
        np.testing.assert_array_equal(r0[f"log/{k}"], r1[f"log/{k}"])


def test_example_refuses_what_is_not_ported(tmp_path):
    from chainermn_tpu_torch import observability as obs
    from chainermn_tpu_torch.examples import train_mnist
    # --observability is ported (A13 a): the run trains and writes its
    # metrics JSONL
    try:
        res = train_mnist.main(["--observability", "--device", "cpu",
                                "--epoch", "1", "--unit", "32",
                                "--prefetch", "0", "--out",
                                str(tmp_path / "obs")])
    finally:
        obs.disable()
        obs.reset_flight_recorder()
        obs.get_registry().reset()
    assert res["log"][-1]["validation/accuracy"] > 0.5
    kinds = {r.get("kind") for r in obs.read_jsonl(
        str(tmp_path / "obs" / "metrics.jsonl"))}
    assert {"step_report", "metric", "straggler_report"} <= kinds
    assert not dist.is_initialized() or dist.get_world_size() == 1
    # --compression is ported (A10): int8 runs and trains
    res = train_mnist.main(["--compression", "int8", "--device", "cpu",
                            "--epoch", "1", "--unit", "32", "--prefetch",
                            "0", "--out", str(tmp_path)])
    rec = res["log"][-1]
    assert np.isfinite(rec["main/loss"]) and rec["validation/accuracy"] > 0.5


def test_create_communicator_default_is_hierarchical_on_a_world_of_one():
    from chainermn_tpu_torch import create_communicator
    created = not dist.is_initialized()
    init_distributed(device="cpu")
    try:
        comm = create_communicator(device="cpu")
        g = {"a": torch.arange(3.0)}
        assert comm.flavor == "hierarchical"
        assert torch.equal(comm.allreduce_grad(g)["a"], g["a"])
    finally:
        if created:
            dist.destroy_process_group()
