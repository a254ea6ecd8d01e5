"""The port stands alone: no JAX, no ``chainermn_tpu``, no quiet CPU fallback.

* Every module of ``chainermn_tpu_torch`` imports in a fresh interpreter
  whose import hook refuses ``jax``, ``flax``, ``optax`` and
  ``chainermn_tpu`` (Triton, which only the kernels' first launch imports,
  is not needed either, nor is ``nvcc``, which builds the CUDA kernels at
  their first launch).
* An AST scan of the package and of ``chip_smoke.py`` finds no import of
  those packages anywhere, lazy imports included.
* Without a CUDA card, the entry points called without ``device=`` raise
  instead of running on the CPU, and ``chip_smoke.py`` exits non-zero
  without printing a result.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "chainermn_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "optax", "chainermn_tpu")

_GUARD = f"""
import importlib, pkgutil, sys
BANNED = {BANNED!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED + ("triton",):
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {REPO!r})
import chainermn_tpu_torch
names = ["chainermn_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(chainermn_tpu_torch.__path__,
                                          "chainermn_tpu_torch.")]
for n in names:
    importlib.import_module(n)
print("imported", len(names))
"""


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_every_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 20


def test_no_banned_import_anywhere():
    found = []
    for path in _py_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {m}"
                      for m in mods if m.split(".")[0] in BANNED]
    assert not found, found


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a box without a CUDA card")


def test_entry_points_refuse_the_cpu_unless_asked():
    _no_cuda()
    from chainermn_tpu_torch import create_communicator, init_distributed
    from chainermn_tpu_torch.examples import train_imagenet, train_mnist
    from chainermn_tpu_torch.models import MLP, ResNet50
    from chainermn_tpu_torch.parallel import init_topology

    calls = [init_distributed, init_topology,
             lambda: create_communicator("xla"), create_communicator,
             lambda: ResNet50(), lambda: MLP(),
             lambda: train_imagenet.main(["--iterations", "1"]),
             lambda: train_mnist.main(["--epoch", "1"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_elastic_entry_points_refuse_the_cpu_unless_asked(tmp_path):
    """The async A/B leg, the supervisor's default world and the smokes'
    default runs go to the card; on a box without one they raise (or
    fail) rather than run on the CPU."""
    _no_cuda()
    from chainermn_tpu_torch.elastic import Supervisor, SupervisorConfig
    from chainermn_tpu_torch.tools import elastic_smoke
    from chainermn_tpu_torch.utils.proc_world import worker_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elastic_smoke.run_async_ab(n_saves=1)
    src = ("import sys\nsys.path.insert(0, %r)\nfrom chainermn_tpu_torch "
           "import init_distributed\nfrom chainermn_tpu_torch.utils."
           "proc_world import worker_device\ninit_distributed(device="
           "worker_device())\nprint('RESULT {}')\n" % REPO)
    cfg = SupervisorConfig(n_procs=1, max_restarts=0, dump_dir=str(tmp_path),
                           out_dir=str(tmp_path), attempt_timeout_s=120)
    with pytest.raises(RuntimeError, match="gave up"):
        Supervisor(src, cfg).run()
    assert worker_device() is None


def test_measurement_entry_points_refuse_the_cpu_unless_asked():
    """``benchmarks.bench_lm``, ``bench_flash_64k``, ``tools.gpu_smoke``
    and ``tools.convergence_ledger`` run on the card by default; without
    one they raise rather than run on the CPU."""
    _no_cuda()
    from chainermn_tpu_torch.benchmarks import bench_flash_64k, bench_lm
    from chainermn_tpu_torch.tools import convergence_ledger, gpu_smoke
    for call in (lambda: bench_lm.main(["--attempts", "1"]),
                 lambda: bench_flash_64k.main(["--T", "512"]),
                 lambda: gpu_smoke.main(["--only", "cast_scale"]),
                 lambda: convergence_ledger.main(["--only", "mnist_mlp"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


_MEASUREMENT = _GUARD.split("import chainermn_tpu_torch\n")[0] + """
import importlib, os
before = set(os.listdir(os.path.join({repo!r}, "build"))) \\
    if os.path.isdir(os.path.join({repo!r}, "build")) else set()
names = ("benchmarks.bench_lm", "benchmarks.bench_flash_64k",
         "tools.gpu_smoke", "tools.convergence_ledger",
         "examples.train_mnist")
for n in names:
    mod = importlib.import_module("chainermn_tpu_torch." + n)
    assert callable(mod.main), n
from chainermn_tpu_torch.ops import _build
fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")
assert not any(w.launches for w in fa.KERNELS)
after = set(os.listdir(os.path.join({repo!r}, "build"))) \\
    if os.path.isdir(os.path.join({repo!r}, "build")) else set()
assert after == before, after - before
bad = [m for m in sys.modules if m.split(".")[0] in BANNED + ("triton",)]
assert not bad, bad
print("measurement", len(names))
""".replace("{repo!r}", repr(REPO))


def test_measurement_modules_stand_alone():
    """The four measurement modules and the MNIST example import with JAX,
    ``chainermn_tpu`` and Triton refused, and importing them builds
    nothing (no new entry under ``build/``, no kernel launched)."""
    proc = subprocess.run([sys.executable, "-c", _MEASUREMENT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-2:] == ["measurement", "5"]


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    _no_cuda()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd, script in ((REPO, "chip_smoke.py"),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


_FACADE = _GUARD.split("import chainermn_tpu_torch\n")[0] + """
import chainermn_tpu_torch as c
from chainermn_tpu_torch.ops import _build
from chainermn_tpu_torch.runtime import native
missing = [n for n in c.__all__ if getattr(c, n, None) is None]
assert not missing, missing
o = c.observability
missing = [n for n in o.__all__ if getattr(o, n, None) is None]
assert not missing, missing
for n in ("Watchdog", "WatchdogConfig", "start_watchdog",
          "watchdog_thread_count", "TelemetryAggregator",
          "contention_report", "occupancy_timelines", "overlap_matrix",
          "link_rates", "attribution_consistency", "feed_link_observations",
          "diff_runs", "diff_profiles", "run_profile", "load_run",
          "RunLedger", "build_manifest", "classify_artifact",
          "ingest_artifacts", "iter_artifacts"):
    assert n in o.__all__, n
import chainermn_tpu_torch.elastic as e
missing = [n for n in e.__all__ if getattr(e, n, None) is None]
assert not missing, missing
for n in ("AsyncCheckpointer", "MANIFEST_SCHEMA", "Supervisor",
          "SupervisorConfig", "build_restart_manifest", "resize_report",
          "resume_resized", "retune_plan_table", "write_restart_manifest"):
    assert n in e.__all__, n
import importlib
for n in ("ledger", "obs_report", "perf_gate", "attribution_smoke",
          "elastic_run", "elastic_smoke"):
    assert callable(importlib.import_module(
        "chainermn_tpu_torch.tools." + n).main), n
from chainermn_tpu_torch.runtime.bootstrap import install_crash_dumps
assert install_crash_dumps() is None  # observability off: nothing
assert _build._LIBS == {} and native._lib is None, "something was built"
print("names", len(c.__all__))
"""

_NATIVE = _GUARD.split("import chainermn_tpu_torch\n")[0] + """
import threading
from chainermn_tpu_torch.benchmarks.bench_transport import free_port
from chainermn_tpu_torch.runtime.native import NativeTransport, library_path
coord = "127.0.0.1:%d" % free_port()
tps = [None, None]
def boot(r):
    tps[r] = NativeTransport(r, 2, coord)
ts = [threading.Thread(target=boot, args=(r,), daemon=True) for r in (0, 1)]
[t.start() for t in ts]
[t.join(60) for t in ts]
try:
    tps[0].send(1, 3, b"ping")
    assert tps[1].recv(0, 3, timeout=30) == b"ping"
finally:
    [t.close() for t in tps if t is not None]
print(library_path())
"""


def test_facade_names_resolve_without_building_anything():
    proc = subprocess.run([sys.executable, "-c", _FACADE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 60
    for name in ("ControlPlane", "SocketControlPlane", "get_control_plane",
                 "reserved_tag", "observability", "CommunicatorBase",
                 "scatter_index", "create_multi_node_evaluator",
                 "MultiNodeBatchNormalization", "Topology", "init_topology",
                 "flash_attention", "InferenceEngine", "ServingConfig",
                 "Plan", "PlanTable", "execute_plan"):
        import chainermn_tpu_torch
        assert name in chainermn_tpu_torch.__all__, name


def test_native_transport_builds_without_jax():
    """``csrc/dcn_transport.cpp`` builds with g++ into ``build/native/``
    and two native ranks exchange a frame, in an interpreter that refuses
    JAX and ``chainermn_tpu``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    proc = subprocess.run([sys.executable, "-c", _NATIVE], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    path = proc.stdout.split()[-1]
    assert os.path.relpath(path, REPO).startswith(
        os.path.join("build", "native"))


_ANALYSIS = _GUARD.split("import chainermn_tpu_torch\n")[0] + """
import importlib
import chainermn_tpu_torch as c
for n in ("lint_step", "LintError", "LintReport", "extract_schedule",
          "CollectiveSchedule"):
    assert n in c.__all__ and getattr(c, n) is not None, n
for n in ("captured", "entrypoints", "hlo", "lint", "protocol", "rules",
          "schedule"):
    importlib.import_module("chainermn_tpu_torch.analysis." + n)
for n in ("cmn_lint", "check_db_overlap", "contention_smoke"):
    assert callable(importlib.import_module(
        "chainermn_tpu_torch.tools." + n).main), n
from chainermn_tpu_torch.tools import cmn_lint
assert cmn_lint.main(["--protocol"]) == 0
from chainermn_tpu_torch.analysis.entrypoints import lint_mnist
(rep,) = lint_mnist(flavors=["xla"])
assert rep.ok, rep.render_text()
bad = [m for m in sys.modules if m.split(".")[0] in BANNED]
assert not bad, bad
print("analysis", len(c.__all__))
"""


def test_analysis_and_its_tools_stand_alone():
    """``analysis/``, the three tools and the five lint names of the
    facade resolve, the protocol sweep and a dry lint run, with JAX and
    ``chainermn_tpu`` refused."""
    proc = subprocess.run([sys.executable, "-c", _ANALYSIS], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-2] == "analysis"
