"""Spawn a multi-process world of the port for validation and supervision.

Counterpart of ``chainermn_tpu/utils/proc_world.py``: the one copy of the
choreography that starts N ranks of a worker program -- port pairing, the
child environment, harvesting each rank's ``RESULT {json}`` line, and
orphan cleanup (a surviving rank blocked in a collective against a dead
peer would outlive the whole run).  The elastic supervisor
(:mod:`chainermn_tpu_torch.elastic.supervisor`) and the smoke tools
(``chainermn_tpu_torch.tools.attribution_smoke`` / ``elastic_smoke``) use
it.

The child environment (:func:`world_env`) is the contract
:func:`~chainermn_tpu_torch.runtime.bootstrap.init_distributed` and
:func:`~chainermn_tpu_torch.runtime.control_plane.get_control_plane` read:
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``LOCAL_WORLD_SIZE`` with the
process group's store at ``MASTER_ADDR:MASTER_PORT``, the same rank and
size as ``CHAINERMN_TPU_PROCESS_ID``/``CHAINERMN_TPU_NUM_PROCESSES``, and
the socket control plane at ``CHAINERMN_TPU_COORDINATOR``, the port after
``MASTER_PORT`` (hence :func:`free_port_pair`).  The device is
``cuda:LOCAL_RANK`` unless the CPU is asked for, which the child sees as
``CHAINERMN_TPU_DEVICE=cpu`` (:func:`worker_device`).

A child's stdout and stderr go to files, not pipes: a torch or NCCL child
can write more than a pipe's 64 KB while its parent only polls, and would
then block on its own output.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

#: the repository root (the package's parent)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A free TCP port on the loopback."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def free_port_pair() -> int:
    """A free TCP port whose successor is also free: the process group's
    store binds the given port and the socket control plane the next."""
    while True:
        port = free_port()
        t = socket.socket()
        try:
            t.bind(("127.0.0.1", port + 1))
        except OSError:
            continue
        finally:
            t.close()
        return port


def worker_device() -> Optional[str]:
    """The device a spawned worker passes to ``init_distributed``:
    ``"cpu"`` when its parent asked for the CPU, else ``None``
    (``cuda:LOCAL_RANK``)."""
    return os.environ.get("CHAINERMN_TPU_DEVICE") or None


def world_env(rank: int, size: int, port: int,
              device: Optional[str] = None,
              repo: Optional[str] = None,
              extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of rank ``rank`` of a world of ``size`` on this
    host, its store at ``port`` and its control plane at ``port + 1``
    (the module note)."""
    repo = repo or REPO
    env = {k: v for k, v in os.environ.items()
           if k not in ("CHAINERMN_TPU_DEVICE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    path = env.get("PYTHONPATH")
    env.update({
        "RANK": str(rank), "WORLD_SIZE": str(size),
        "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(size),
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
        "CHAINERMN_TPU_PROCESS_ID": str(rank),
        "CHAINERMN_TPU_NUM_PROCESSES": str(size),
        "CHAINERMN_TPU_COORDINATOR": f"127.0.0.1:{port + 1}",
        "CHAINERMN_TPU_REPO": repo,
        "PYTHONPATH": repo + (os.pathsep + path if path else ""),
    })
    if device == "cpu":
        env["CHAINERMN_TPU_DEVICE"] = "cpu"
        env.setdefault("OMP_NUM_THREADS", "1")
    elif device is not None:
        raise ValueError(f"device must be None (cuda:LOCAL_RANK) or 'cpu', "
                         f"got {device!r}")
    env.update(extra or {})
    return env


class Child:
    """One spawned rank: its process and the files its output goes to."""

    def __init__(self, rank: int, src: str, env: Dict[str, str],
                 log_prefix: str):
        self.rank = rank
        self.out_path = log_prefix + ".out"
        self.err_path = log_prefix + ".err"
        with open(self.out_path, "wb") as out, \
                open(self.err_path, "wb") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-c", src], env=env, stdout=out,
                stderr=err, stdin=subprocess.DEVNULL)

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()

    def wait(self, timeout: float) -> Optional[int]:
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def _read(self, path: str) -> str:
        try:
            with open(path, encoding="utf-8", errors="replace") as fh:
                return fh.read()
        except OSError:
            return ""

    def stdout(self) -> str:
        return self._read(self.out_path)

    def stderr(self) -> str:
        return self._read(self.err_path)

    def result(self) -> Optional[dict]:
        """The rank's ``RESULT {json}`` line, parsed (None without one)."""
        for line in self.stdout().splitlines():
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
        return None


def launch_world(worker_src: str, n_procs: int, log_dir: str,
                 device: Optional[str] = None, repo: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 tag: str = "") -> List[Child]:
    """Start ``n_procs`` ranks of ``worker_src`` (``python -c``) on a fresh
    port pair; their output goes to ``{log_dir}/{tag}rank{r}.out|.err``."""
    os.makedirs(log_dir, exist_ok=True)
    port = free_port_pair()
    return [Child(r, worker_src,
                  world_env(r, n_procs, port, device, repo, env),
                  os.path.join(log_dir, f"{tag}rank{r}"))
            for r in range(n_procs)]


def kill_world(children: List[Child], timeout: float = 10.0) -> None:
    """Kill every rank still running and reap them all."""
    for c in children:
        c.kill()
    for c in children:
        c.wait(timeout)


def wait_world(children: List[Child], timeout: float = 600.0
               ) -> Dict[int, dict]:
    """Wait for the ranks of :func:`launch_world` and return ``{rank:
    parsed_result}`` from each rank's ``RESULT {json}`` line.

    Every rank polls together: a crashed rank surfaces as soon as it
    exits, even while its peers are still blocked on it, and then every
    rank still running is killed before the error propagates.  A rank that
    exits 0 without a ``RESULT`` line is an error too.
    """
    try:
        deadline = time.monotonic() + timeout
        while True:
            states = [c.poll() for c in children]
            for c, st in zip(children, states):
                if st is not None and st != 0:
                    raise RuntimeError(
                        f"worker rank {c.rank} failed (rc={st})\n"
                        f"stderr:\n{c.stderr()[-3000:]}\n"
                        f"stdout:\n{c.stdout()[-1000:]}")
            if all(st is not None for st in states):
                break
            if time.monotonic() > deadline:
                alive = [c.rank for c, st in zip(children, states)
                         if st is None]
                raise RuntimeError(f"the world timed out after {timeout}s; "
                                   f"rank(s) {alive} still running")
            time.sleep(0.05)
        results: Dict[int, dict] = {}
        for c in children:
            res = c.result()
            if res is None:
                raise RuntimeError(
                    f"worker rank {c.rank} produced no RESULT line:\n"
                    f"{c.stdout()[-2000:]}\nstderr:\n{c.stderr()[-2000:]}")
            results[c.rank] = res
        return results
    finally:
        kill_world(children)


def spawn_world(worker_src: str, n_procs: int = 2,
                device: Optional[str] = None, timeout: float = 600.0,
                log_dir: Optional[str] = None, repo: Optional[str] = None,
                env: Optional[Dict[str, str]] = None) -> Dict[int, dict]:
    """Run ``worker_src`` in ``n_procs`` processes (:func:`launch_world`)
    and wait for their results (:func:`wait_world`)."""
    import tempfile
    log_dir = log_dir or tempfile.mkdtemp(prefix="proc_world_")
    return wait_world(launch_world(worker_src, n_procs, log_dir, device,
                                   repo, env), timeout)


__all__ = ["Child", "REPO", "free_port", "free_port_pair", "kill_world",
           "launch_world", "spawn_world", "wait_world", "worker_device",
           "world_env"]
