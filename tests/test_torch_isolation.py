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


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    _no_cuda()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd, script in ((REPO, "chip_smoke.py"),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
