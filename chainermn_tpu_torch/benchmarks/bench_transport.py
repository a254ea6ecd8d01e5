"""Control-plane transport microbench: the native C++ core against the
pure-Python transport.

Counterpart of ``benchmarks/bench_transport.py``.  Two processes on one
host (localhost TCP) ping-pong frames over the framed transport of
:mod:`chainermn_tpu_torch.runtime.transport` (``csrc/dcn_transport.cpp``
through ctypes, or ``PyTransport``): rank 0 sends, rank 1 echoes.  For
each payload size the one-way goodput is ``2 * bytes * reps / elapsed``;
the round-trip latency at ``--latency-bytes`` (1 KiB) is the median of
``--latency-reps`` single round trips.  Loopback has no NIC, so these are
the transport's software floor on this host, not a network's rate.

    python -m chainermn_tpu_torch.benchmarks.bench_transport [--quick]
        [--out FILE]

Prints one JSON line per (backend, payload), the latencies, and a summary
of native against Python at the largest payload; ``--out`` writes the
whole document (with the common envelope).  It fails when the native
core's goodput at the largest payload is below 0.9 of Python's, as JAX's
does (after printing and writing everything).  No CUDA is involved: the
transport is host-only.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_SIZES = [1 << 10, 1 << 13, 1 << 16, 1 << 19, 1 << 22, 1 << 24,
                 1 << 26]  # 1 KiB .. 64 MiB
QUICK_SIZES = [1 << 10, 1 << 16, 1 << 20]

_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, os.environ["CMN_BENCH_REPO"])
from chainermn_tpu_torch.runtime.transport import create_transport

rank = int(os.environ["CHAINERMN_TPU_PROCESS_ID"])
coord = os.environ["CHAINERMN_TPU_COORDINATOR"]
cfg = json.loads(os.environ["CMN_BENCH_CFG"])
t = create_transport(rank, 2, coord)
TAG = 7
out = {"backend": type(t).__name__, "mb_per_s": {}, "rtt_us": None}
try:
    lat = b"\x5a" * cfg["latency_bytes"]
    if rank == 0:
        for _ in range(5):                       # warm the connection
            t.send(1, TAG, lat)
            t.recv(1, TAG)
        rtts = []
        for _ in range(cfg["latency_reps"]):
            t0 = time.perf_counter()
            t.send(1, TAG, lat)
            t.recv(1, TAG)
            rtts.append(time.perf_counter() - t0)
        rtts.sort()
        out["rtt_us"] = rtts[len(rtts) // 2] * 1e6
    else:
        for _ in range(5 + cfg["latency_reps"]):
            t.send(0, TAG, t.recv(0, TAG))
    for sz in cfg["sizes"]:
        reps = max(3, min(cfg["reps_cap"], (1 << 24) // sz))
        payload = b"\x5a" * sz
        if rank == 0:
            t.send(1, TAG, payload)
            assert len(t.recv(1, TAG)) == sz
            t0 = time.perf_counter()
            for _ in range(reps):
                t.send(1, TAG, payload)
                r = t.recv(1, TAG)
            dt = time.perf_counter() - t0
            assert len(r) == sz
            out["mb_per_s"][str(sz)] = 2.0 * sz * reps / dt / 1e6
        else:
            for _ in range(reps + 1):
                t.send(0, TAG, t.recv(0, TAG))
finally:
    t.close()
print("RESULT " + json.dumps(out), flush=True)
"""


_PLANE_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["CMN_BENCH_REPO"])
from chainermn_tpu_torch.runtime.control_plane import SocketControlPlane

rank = int(os.environ["CHAINERMN_TPU_PROCESS_ID"])
size = int(os.environ["CHAINERMN_TPU_NUM_PROCESSES"])
plane = SocketControlPlane(rank, size, os.environ["CHAINERMN_TPU_COORDINATOR"])
try:
    got = {
        "transport": type(plane._tp).__name__,
        "bcast": plane.bcast_obj({"seed": 42} if rank == 0 else None),
        "gather": plane.gather_obj(rank * 10),
        "scatter": plane.scatter_obj([f"s{r}" for r in range(size)]
                                     if rank == 0 else None),
        "allreduce": plane.allreduce_obj({"n": rank + 1, "m": [rank]},
                                         op="max"),
        "allgather": plane.allgather_obj(rank),
    }
    plane.barrier()
    # frames both ways between rank 0 and the last rank
    blob = bytes(range(256)) * 1031
    if rank == 0:
        plane._tp.send(size - 1, 5, blob)
        got["frame"] = plane._tp.recv(size - 1, 6, timeout=60) == blob[::-1]
    elif rank == size - 1:
        got["frame"] = plane._tp.recv(0, 5, timeout=60) == blob
        plane._tp.send(0, 6, blob[::-1])
    plane.barrier()
finally:
    plane.shutdown()
print("RESULT " + json.dumps(got), flush=True)
"""


def _spawn(code: str, envs: List[dict], timeout: float) -> List[str]:
    """Run ``code`` in one process per environment, together; their
    standard outputs.  Every process is stopped before it returns."""
    procs = []
    try:
        for env in envs:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (so, se) in zip(procs, outs):
        if p.returncode:
            raise RuntimeError(f"worker failed (rc {p.returncode}):\n"
                               f"{se[-3000:]}")
    return [so for so, _ in outs]


def _result(stdout: str) -> dict:
    line = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def run_plane_world(backends: List[str], timeout: float = 300.0) -> list:
    """A ``SocketControlPlane`` world of ``len(backends)`` processes, rank
    r on the ``backends[r]`` transport (``"native"`` or ``"python"``):
    each rank's results of bcast, gather, scatter, allreduce (max) and
    allgather, and whether rank 0 and the last rank exchanged a frame both
    ways intact."""
    base = dict(os.environ, CMN_BENCH_REPO=REPO,
                CHAINERMN_TPU_COORDINATOR=f"127.0.0.1:{free_port()}",
                CHAINERMN_TPU_NUM_PROCESSES=str(len(backends)))
    envs = [dict(base, CHAINERMN_TPU_PROCESS_ID=str(r),
                 CHAINERMN_TPU_PURE_PY_TRANSPORT="1" if b == "python"
                 else "0") for r, b in enumerate(backends)]
    return [_result(o) for o in _spawn(_PLANE_WORKER, envs, timeout)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_sweep(sizes: List[int], backend: str, reps_cap: int = 50,
              latency_bytes: int = 1 << 10, latency_reps: int = 200,
              timeout: float = 600.0) -> dict:
    """One two-process run of ``backend`` (``"native"`` or ``"python"``):
    ``{"backend": class name, "mb_per_s": {size: MB/s}, "rtt_us": median
    round trip at latency_bytes}`` from rank 0.  Both processes are
    stopped before it returns, also when one fails."""
    env = dict(os.environ)
    env.update({
        "CMN_BENCH_REPO": REPO,
        "CMN_BENCH_CFG": json.dumps({
            "sizes": list(sizes), "reps_cap": reps_cap,
            "latency_bytes": latency_bytes, "latency_reps": latency_reps}),
        "CHAINERMN_TPU_COORDINATOR": f"127.0.0.1:{free_port()}",
        "CHAINERMN_TPU_PURE_PY_TRANSPORT":
            "1" if backend == "python" else "0",
    })
    outs = _spawn(_WORKER, [dict(env, CHAINERMN_TPU_PROCESS_ID=str(r))
                            for r in range(2)], timeout)
    res = _result(outs[0])
    want = "PyTransport" if backend == "python" else "NativeTransport"
    if res["backend"] != want:
        raise AssertionError(f"asked for {backend}, ran {res['backend']}")
    return res


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--quick", action="store_true",
                    help="3 sizes, few reps (smoke)")
    args = ap.parse_args(argv)
    sizes = QUICK_SIZES if args.quick else DEFAULT_SIZES
    reps_cap = 5 if args.quick else 50
    lat_reps = 50 if args.quick else 200
    runs = {}
    for label in ("native", "python"):
        r = run_sweep(sizes, label, reps_cap, latency_reps=lat_reps)
        runs[label] = r
        for sz in sizes:
            print(json.dumps({
                "metric": "transport_goodput", "backend": r["backend"],
                "payload_bytes": sz,
                "value": r["mb_per_s"][str(sz)], "unit": "MB/s"}),
                flush=True)
        print(json.dumps({"metric": "transport_rtt", "backend": r["backend"],
                          "payload_bytes": 1 << 10,
                          "value": r["rtt_us"], "unit": "us"}), flush=True)
    big = str(sizes[-1])
    nat, py = runs["native"]["mb_per_s"][big], runs["python"]["mb_per_s"][big]
    summary = {"summary": "native_vs_python", "payload_bytes": int(big),
               "native_mb_s": nat, "python_mb_s": py,
               "speedup": nat / py}
    print(json.dumps(summary), flush=True)
    doc = {"schema": "bench_transport/v1", "runs": runs, "summary": summary}
    if args.out:
        from chainermn_tpu_torch.observability import stamp_envelope
        stamp_envelope(doc, n_devices=0, backend="host")
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
    if nat < 0.9 * py:
        raise AssertionError(
            f"native transport slower than Python at {big} B: {nat:.0f} "
            f"vs {py:.0f} MB/s")
    return doc


if __name__ == "__main__":
    main()
