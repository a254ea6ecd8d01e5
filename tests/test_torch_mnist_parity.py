"""The whole MNIST example, epoch by epoch, against the JAX example.

Both sides run on a world of two processes (ROADMAP Queue A, item 4):

* JAX: ``examples/mnist/train_mnist.py`` in two processes of one CPU
  device each, through the JAX package's bootstrap environment contract
  (``CHAINERMN_TPU_COORDINATOR``/``_NUM_PROCESSES``/``_PROCESS_ID``, gloo
  collectives between the processes).  Each process scatters its own half
  of the data (``scatter_dataset`` by process rank) and iterates it with
  ``--batchsize`` rows a process, as each rank of the port does.
* The port: ``chainermn_tpu_torch.examples.train_mnist.main`` in a 2-rank
  gloo world, started from the JAX example's own ``MLP.init(jax.random.
  key(seed))`` (the ``flax_init`` keyword, through ``weights.py``).

Six variants (``naive``, ``hierarchical``, ``xla``, each with and without
``--double-buffering``) run for 2 epochs at ``--unit 16`` in ONE world per
side; each epoch's ``main/loss``, ``validation/loss``, ``main/accuracy``
and ``validation/accuracy`` are held to the stated float32 tolerances.
Their source: each side sums its float32 products in its own order, and
Adam (1e-3) divides each gradient component by its own running scale, so
the components near zero move by up to a step of lr where the two sums
differ.  Over the 120 steps this gave at most 8.4e-4 relative in a loss
(without double buffering; 1.2e-5 with it) and 8.3e-5 in an accuracy,
while a 2^-20 change of one initial weight moves the port's own run by
3e-8: the gap is the two libraries' float order, not a difference of
step (ROADMAP Queue C 7).  The accuracies may differ by 2 of the 2,000
validation examples.

The shards themselves are checked first: each rank's sample indices, JAX
against the port.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

import torch_dist_worker
from chainermn_tpu.models import MLP as JMLP
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIT, EPOCHS, SEED = 16, 2, 0
VARIANTS = [f"--communicator {c}{db}" for c in ("naive", "hierarchical",
                                                 "xla")
            for db in ("", " --double-buffering")]
KEYS = ("main/loss", "validation/loss", "main/accuracy",
        "validation/accuracy")
LOSS_RTOL = 2e-3      # relative, each epoch's mean loss
ACC_ATOL = 1e-3       # absolute: 2 of the 2,000 validation examples

# One JAX process: the example once per variant, in this process's world.
_JAX_WORKER = r"""
import json, os, runpy, sys
sys.path.insert(0, {repo!r})
import chainermn_tpu
chainermn_tpu.init_distributed()
# the world is up; the example's own call must not start a second one
chainermn_tpu.init_distributed = lambda *a, **k: None
import jax
rank = jax.process_index()
assert jax.device_count() == 2 and jax.local_device_count() == 1
for i, variant in enumerate({variants!r}):
    out = os.path.join({tmp!r}, f"jax_{{i}}_{{rank}}")
    sys.argv = ["train_mnist.py"] + variant.split() + [
        "--epoch", "{epochs}", "--unit", "{unit}", "--seed", "{seed}",
        "--out", out]
    runpy.run_path(os.path.join({repo!r}, "examples", "mnist",
                                "train_mnist.py"), run_name="__main__")
"""


def _jax_world(tmp_path):
    """Start the two JAX processes; returns them."""
    script = tmp_path / "jax_mnist_world.py"
    script.write_text(_JAX_WORKER.format(
        repo=REPO, variants=VARIANTS, tmp=str(tmp_path), epochs=EPOCHS,
        unit=UNIT, seed=SEED))
    port = torch_dist_worker._free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", JAX_NUM_CPU_DEVICES="1",
               CHAINERMN_TPU_COORDINATOR=f"127.0.0.1:{port}",
               CHAINERMN_TPU_NUM_PROCESSES="2", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    return [subprocess.Popen(
        [sys.executable, str(script)], cwd=str(tmp_path),
        env={**env, "CHAINERMN_TPU_PROCESS_ID": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]


def _wait(procs, timeout=300):
    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"JAX rank {r}:\n{log[-4000:]}"


class _Comm:
    """What ``scatter_dataset`` reads of a communicator, on both sides."""

    def __init__(self, rank, size):
        self.rank, self.size, self.host_size = rank, size, size

    def bcast_obj(self, obj, root=0):
        return obj


def test_each_rank_scatters_the_same_samples():
    from chainermn_tpu.datasets import make_classification as jmake
    from chainermn_tpu.datasets import scatter_dataset as jscatter
    from chainermn_tpu_torch.datasets import make_classification
    from chainermn_tpu_torch.datasets import scatter_dataset
    for n, seed, shuffle in ((12000, SEED, True), (2000, 1, False)):
        ds, jds = (make_classification(n=n, dim=784, n_classes=10, noise=4.0,
                                       seed=seed),
                   jmake(n=n, dim=784, n_classes=10, noise=4.0, seed=seed))
        shards = []
        for r in range(2):
            got = scatter_dataset(ds, _Comm(r, 2), shuffle=shuffle,
                                  seed=SEED).indices
            want = jscatter(jds, _Comm(r, 2), shuffle=shuffle,
                            seed=SEED)._indices
            np.testing.assert_array_equal(got, want)
            shards.append(got)
        assert len(set(shards[0]) | set(shards[1])) == n


def test_mnist_example_per_epoch_matches_jax(tmp_path):
    variables = JMLP(UNIT, 10).init(jax.random.key(SEED),
                                    jnp.zeros((1, 784)))
    init = torch_dist_worker.flatten(jax.tree.map(np.asarray, variables))
    jax_procs = _jax_world(tmp_path)
    try:
        argvs = [f"{v} --epoch {EPOCHS} --unit {UNIT} --seed {SEED} "
                 f"--device cpu --out {tmp_path / f'torch_{i}'}"
                 for i, v in enumerate(VARIANTS)]
        port = torch_dist_worker.launch(
            "mnistpar", {"variants": np.asarray(argvs),
                         **{f"init/{k}": v for k, v in init.items()}},
            2, tmp_path)
    finally:
        _wait(jax_procs)
    for i, variant in enumerate(VARIANTS):
        with open(tmp_path / f"jax_{i}_0" / "log") as f:
            want = json.load(f)
        assert [r["epoch"] for r in want] == list(range(1, EPOCHS + 1))
        for key in KEYS:
            w = np.asarray([r[key] for r in want])
            got = port[0][f"{i}/{key}"]
            np.testing.assert_array_equal(port[1][f"{i}/{key}"], got)
            if key.endswith("loss"):
                np.testing.assert_allclose(got, w, rtol=LOSS_RTOL,
                                           err_msg=f"{variant} {key}")
            else:
                np.testing.assert_allclose(got, w, rtol=0, atol=ACC_ATOL,
                                           err_msg=f"{variant} {key}")
        # the run learned: a failing parity would not pass as two dead runs
        assert want[-1]["validation/accuracy"] > 0.9, (variant, want)
