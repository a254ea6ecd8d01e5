"""The data-parallel slice on every card of one host.

    python3 multi_gpu_check.py [--logs DIR]   # needs two CUDA cards or more

1. prints the cards' names and power limits (``nvidia-smi``) and torch's
   versions;
2. runs ``tests/test_torch_nccl_gpu.py`` (marker ``gpu``): the object
   plane, the array collectives, ``non_cuda_aware``'s staging,
   ``split_axes``, the multi-node iterator, the checkpointer and ZeRO-1
   on NCCL worlds of one card and of every card;
3. times ``examples.train_imagenet`` under ``torchrun`` on every card,
   ZeRO-1, plain, ZeRO-1, plain (ResNet-50, batch 32 a card, bfloat16,
   the bfloat16 wire, synthetic data, 30 iterations of which the first 5
   are left out): each run's images/sec over all cards and rank 0's peak
   device memory;
4. drives ``--zero --checkpoint`` with two epoch ends inside the run
   (``Snapshot``, ``AllreducePersistent`` and the evaluator on the NCCL
   world): 12 iterations straight, then 6 and a resume to 12 in another
   directory.  The resumed run's parameters, buffers and every rank's
   optimizer shards must equal the straight run's bit for bit (cuDNN
   deterministic, benchmark off).

Prints one JSON object as its last line; exits 1 if a check failed.  Runs
write under ``build/`` (removed afterwards), their logs under ``--logs``
(default ``build/multi_gpu_logs/``).
"""

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
TIMED = ["--arch", "resnet50", "--communicator", "xla",
         "--allreduce-grad-dtype", "bfloat16", "--batchsize", "32",
         "--dtype", "bfloat16", "--iterations", "30", "--warmup-steps", "5",
         "--train-size", "4096", "--val-size", "0", "--log-interval", "30",
         "--seed", "0"]
# 12 iterations, epochs of 5, snapshots every 6
RESUME = ["--arch", "resnet50", "--communicator", "xla", "--zero",
          "--allreduce-grad-dtype", "bfloat16", "--optimizer", "momentum",
          "--warmup-epochs", "0.5", "--batchsize", "32",
          "--dtype", "bfloat16", "--seed", "0", "--epoch", "3",
          "--val-size", "256", "--checkpoint-freq", "6",
          "--log-interval", "12", "--warmup-steps", "3"]


def _digest(res) -> str:
    """sha256 of this rank's parameters, buffers and optimizer state."""
    import torch
    h = hashlib.sha256()
    tensors = sorted(res["model"].state_dict().items())
    state = res["optimizer"].local_optimizer.state_dict()["state"]
    tensors += [(f"opt/{i}/{k}", v) for i, st in sorted(state.items())
                for k, v in sorted(st.items()) if isinstance(v, torch.Tensor)]
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.detach().reshape(-1).contiguous().cpu()
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def worker(out_prefix, flags):
    """One rank under ``torchrun``: ``train_imagenet.main(flags)``, then
    ``{out_prefix}.rank{r}.json``."""
    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.examples import train_imagenet
    res = train_imagenet.main(flags)
    rank = int(os.environ["RANK"])
    doc = {k: res[k] for k in ("losses", "images_per_sec", "iterations",
                               "world", "resumed_from", "peak_memory_gb",
                               "save_seconds")}
    doc["digest"] = _digest(res)
    doc["epochs"] = len(res["log"])
    with open(f"{out_prefix}.rank{rank}.json", "w") as f:
        json.dump(doc, f)


def torchrun(n, name, flags, work, logs):
    """``n`` ranks of :func:`worker`; every rank's document, by rank; the
    ranks' output in ``{logs}/{name}.log``."""
    prefix = os.path.join(work, name)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), os.path.abspath(__file__), "--worker",
           prefix] + flags
    path = os.path.join(logs, f"{name}.log")
    with open(path, "w") as log:
        rc = subprocess.run(cmd, cwd=HERE, stdout=log,
                            stderr=subprocess.STDOUT, timeout=600).returncode
    if rc:
        raise RuntimeError(f"{name}: torchrun exited {rc} (log: {path})")
    return [json.load(open(f"{prefix}.rank{r}.json")) for r in range(n)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--logs", default=os.path.join(HERE, "build",
                                                  "multi_gpu_logs"),
                   help="directory for the tests' and the runs' output")
    logs = os.path.abspath(p.parse_args(argv).logs)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("multi_gpu_check.py needs two CUDA cards or more",
              file=sys.stderr)
        return 2
    n = torch.cuda.device_count()
    os.makedirs(logs, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print("\n".join(smi))
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, n,
          flush=True)
    out = {"cards": n, "card": sorted(set(smi)), "ok": False}
    failures = []

    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-m", "gpu", "-q",
         "tests/test_torch_nccl_gpu.py"], cwd=HERE, capture_output=True,
        text=True, timeout=900)
    with open(os.path.join(logs, "gpu_tests.log"), "w") as f:
        f.write(tests.stdout + tests.stderr)
    summary = (tests.stdout.strip().splitlines() or [""])[-1]
    out["nccl_tests"] = {"rc": tests.returncode, "summary": summary}
    print(f"tests/test_torch_nccl_gpu.py: rc {tests.returncode}; {summary}",
          flush=True)
    if tests.returncode or "skipped" in summary:
        failures.append("tests/test_torch_nccl_gpu.py")

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="multi_gpu_check_",
                            dir=os.path.join(HERE, "build"))
    try:
        runs = []
        for i, zero in enumerate((True, False, True, False)):
            name = f"timed{i}_{'zero' if zero else 'plain'}"
            docs = torchrun(n, name, TIMED + ["--zero"] * zero, work, logs)
            d = docs[0]
            runs.append({"run": name, "images_per_sec": d["images_per_sec"],
                         "peak_memory_gb_rank0": d["peak_memory_gb"],
                         "final_loss": d["losses"][-1]})
            print(json.dumps(runs[-1]), flush=True)
            if not all(map(math.isfinite, d["losses"])):
                failures.append(f"{name}: losses {d['losses']}")
        out["timed"] = runs

        straight = torchrun(n, "straight", RESUME + [
            "--iterations", "12", "--train-size", str(32 * n * 5),
            "--checkpoint", os.path.join(work, "straight")], work, logs)
        part = os.path.join(work, "part")
        first = torchrun(n, "first", RESUME + [
            "--iterations", "6", "--train-size", str(32 * n * 5),
            "--checkpoint", part], work, logs)
        resumed = torchrun(n, "resumed", RESUME + [
            "--iterations", "12", "--train-size", str(32 * n * 5),
            "--checkpoint", part], work, logs)
        equal = [a["digest"] == b["digest"]
                 for a, b in zip(straight, resumed)]
        out["resume"] = {
            "resumed_from": resumed[0]["resumed_from"],
            "iterations": resumed[0]["iterations"],
            "epochs_logged": straight[0]["epochs"],
            "equal_by_rank": equal,
            "same_losses": resumed[0]["losses"] == straight[0]["losses"][6:],
            "images_per_sec": straight[0]["images_per_sec"],
            "save_ms_rank0": [round(1e3 * t, 1)
                              for t in straight[0]["save_seconds"]],
            "peak_memory_gb_rank0": straight[0]["peak_memory_gb"]}
        print(json.dumps(out["resume"]), flush=True)
        if not all(equal) or resumed[0]["resumed_from"] != 6 or \
                first[0]["iterations"] != 6 or straight[0]["epochs"] != 2:
            failures.append("resume")
        if not all(math.isfinite(v) for d in straight + resumed
                   for v in d["losses"]):
            failures.append("resume: losses not finite")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["failures"] = failures
    out["ok"] = not failures
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3:])
    else:
        sys.exit(main())
