"""The data-parallel and sequence-parallel slices on every card of one host.

    python3 multi_gpu_check.py [--logs DIR] [--parts dp,sp]
    # needs two CUDA cards or more

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
   deterministic, benchmark off);
5. (part ``sp``) ``examples.train_lm`` at the LM's width (vocab 32768,
   d_model 2048, 8 layers, 16 heads, batch 1, float32, TF32 off, seed 0,
   ``SP_STEPS`` Adam steps) at T 8192: ``--attention flash`` on one card,
   then ``ring_flash``, ``ring`` and ``ulysses`` under ``torchrun`` on
   every card (T/P tokens a card): each run's losses within 1e-4 relative
   of the one-card run's, and rank 0's gradients of step 0 (summed over
   the ranks) within a relative L2 error of 1e-3 of its gradients; then
   ``ring_flash`` at T 32768 (8192 tokens a card on four); each run's
   tokens/sec of the whole sequence (over every step, and over the steps
   after the first) and every card's peak memory; then
   ``benchmarks.bench_ring_attention`` on every card at T 8192 and 16384.

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
SP_BENCH = ["--seq-lens", "8192,16384", "--json"]
# 12 iterations, epochs of 5, snapshots every 6
RESUME = ["--arch", "resnet50", "--communicator", "xla", "--zero",
          "--allreduce-grad-dtype", "bfloat16", "--optimizer", "momentum",
          "--warmup-epochs", "0.5", "--batchsize", "32",
          "--dtype", "bfloat16", "--seed", "0", "--epoch", "3",
          "--val-size", "256", "--checkpoint-freq", "6",
          "--log-interval", "12", "--warmup-steps", "3"]

SP_STEPS = 3
SP = ["--batchsize", "1", "--steps", str(SP_STEPS), "--vocab", "32768",
      "--d-model", "2048", "--layers", "8", "--heads", "16", "--lr", "1e-3",
      "--seed", "0"]


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


def lm_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``train_lm.main(flags)`` in float32
    with TF32 off, then ``{out_prefix}.rank{r}.json``; rank 0 also saves
    its gradients of step 0 (summed over the ranks) to
    ``{out_prefix}.grads.pt``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.examples import train_lm
    rank = int(os.environ["RANK"])

    def keep(i, model):
        if i == 0 and rank == 0:
            torch.save({k: p.grad.detach().cpu()
                        for k, p in model.named_parameters()},
                       f"{out_prefix}.grads.pt")

    res = train_lm.main(flags, on_grads=keep)
    doc = {k: res[k] for k in ("losses", "tokens_per_sec", "world",
                               "peak_memory_gb", "seconds", "step_seconds")}
    # tokens/sec after the first step, which pays the first calls' costs
    # (the kernels' build among them)
    args = train_lm.parse_args(flags)
    steady = res["step_seconds"][1:]
    doc["steady_tokens_per_sec"] = (args.batchsize * args.seq_len
                                    * len(steady) / sum(steady))
    with open(f"{out_prefix}.rank{rank}.json", "w") as f:
        json.dump(doc, f)


def bench_worker(out_prefix, flags):
    """One rank under ``torchrun``: ``bench_ring_attention.main(flags)``,
    its rows in ``{out_prefix}.rank{r}.json``."""
    sys.path.insert(0, HERE)
    from chainermn_tpu_torch.benchmarks import bench_ring_attention
    rows = bench_ring_attention.main(flags)
    with open(f"{out_prefix}.rank{os.environ['RANK']}.json", "w") as f:
        json.dump(rows, f)


WORKERS = {"imagenet": worker, "lm": lm_worker, "bench": bench_worker}


def torchrun(n, name, flags, work, logs, kind="imagenet"):
    """``n`` ranks of the ``kind`` worker of ``WORKERS``; every rank's
    document, by rank; the ranks' output in ``{logs}/{name}.log``."""
    prefix = os.path.join(work, name)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), os.path.abspath(__file__), "--worker",
           kind, prefix] + flags
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
    p.add_argument("--parts", default="dp,sp",
                   help="which slices to run: dp (steps 2-4), sp (step 5)")
    args = p.parse_args(argv)
    logs = os.path.abspath(args.logs)
    parts = set(args.parts.split(","))
    if not parts or parts - {"dp", "sp"}:
        p.error(f"--parts: {args.parts!r} is not a subset of dp,sp")
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
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="multi_gpu_check_",
                            dir=os.path.join(HERE, "build"))
    try:
        if "dp" in parts:
            data_parallel(n, out, failures, work, logs)
        if "sp" in parts:
            sequence_parallel(n, out, failures, work, logs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["failures"] = failures
    out["ok"] = not failures
    print(json.dumps(out))
    return 0 if out["ok"] else 1


def sequence_parallel(n, out, failures, work, logs):
    """Step 5 (see the module docstring)."""
    import torch
    from chainermn_tpu_torch.utils.compare import step_agrees, step_errors
    ref = torchrun(1, "sp_flash", ["--attention", "flash", "--seq-len",
                                   "8192"] + SP, work, logs, kind="lm")[0]
    want_grads = torch.load(os.path.join(work, "sp_flash.grads.pt"))
    out["sp"] = {"flash_1card": ref}
    print(json.dumps({"flash_1card": ref}), flush=True)
    for att in ("ring_flash", "ring", "ulysses"):
        docs = torchrun(n, f"sp_{att}", ["--attention", att, "--seq-len",
                                         "8192"] + SP, work, logs,
                        kind="lm")
        d = docs[0]
        path = os.path.join(work, f"sp_{att}.grads.pt")
        loss_rel, grad_rel, worst = step_errors(
            d["losses"], ref["losses"], torch.load(path), want_grads)
        os.remove(path)
        row = {"losses": d["losses"], "loss_rel": loss_rel,
               "grad_rel": grad_rel, "grad_worst": worst,
               "tokens_per_sec": d["tokens_per_sec"],
               "steady_tokens_per_sec": d["steady_tokens_per_sec"],
               "step_seconds": d["step_seconds"], "world": d["world"],
               "peak_memory_gb": [x["peak_memory_gb"] for x in docs]}
        out["sp"][att] = row
        print(json.dumps({att: row}), flush=True)
        if not (d["world"] == n and step_agrees(loss_rel, grad_rel)):
            failures.append(f"sp {att}: loss rel {loss_rel:.2e}, gradient "
                            f"rel {grad_rel:.2e}")
    del want_grads
    docs = torchrun(n, "sp_ring_flash_32k", [
        "--attention", "ring_flash", "--seq-len", "32768"] + SP, work,
        logs, kind="lm")
    row = {"tokens_per_sec": docs[0]["tokens_per_sec"],
           "steady_tokens_per_sec": docs[0]["steady_tokens_per_sec"],
           "step_seconds": docs[0]["step_seconds"],
           "losses": docs[0]["losses"],
           "peak_memory_gb": [x["peak_memory_gb"] for x in docs]}
    out["sp"]["ring_flash_32k"] = row
    print(json.dumps({"ring_flash_32k": row}), flush=True)
    if not all(map(math.isfinite, row["losses"])):
        failures.append(f"sp ring_flash T 32768: losses {row['losses']}")
    rows = torchrun(n, "bench_ring", SP_BENCH, work, logs, kind="bench")[0]
    out["sp"]["bench_ring_attention"] = rows
    for r in rows:
        print(json.dumps(r), flush=True)


def data_parallel(n, out, failures, work, logs):
    """Steps 2-4 (see the module docstring)."""
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


if __name__ == "__main__":
    if len(sys.argv) > 3 and sys.argv[1] == "--worker":
        WORKERS[sys.argv[2]](sys.argv[3], sys.argv[4:])
    else:
        sys.exit(main())
