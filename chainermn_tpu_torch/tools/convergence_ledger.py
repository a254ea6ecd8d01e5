"""Convergence-quality ledger: held-out accuracy and BLEU against floors.

Counterpart of ``tools/convergence_ledger.py``.  It runs the port's
examples on their synthetic offline paths with JAX's arguments, seeds and
floors, and records the held-out quality each reaches:

* ``mnist_mlp``: the MNIST MLP (100 units), naive communicator, 5 epochs,
  batch 100 -> validation accuracy, floor 0.97;
* ``seq2seq_copy_reverse``: the seq2seq example at its defaults, 30 epochs
  -> held-out BLEU-4, floor 0.62;
* ``tiny_resnet_synthetic_imagenet``: ResNet-50 at 32 pixels, 8 classes,
  2048 train / 256 validation images, batch 16, lr 0.02, 3 epochs, ``xla``
  communicator -> validation accuracy, floor 0.60 (on a card the BatchNorm
  kernels run every boundary);
* ``tiny_vit_synthetic_imagenet``: ViT-S/16 on the same path, Adam 1e-3 ->
  validation accuracy, floor 0.60.

The examples run in this process through their ``main(argv)`` (JAX's
tool runs each script with ``runpy``), with ``--device`` passed on (and
the MNIST example's log file written to a temporary directory).  A row
under its floor fails; the floors are JAX's and are never lowered.  The
document (``convergence_ledger/v1``) records the backend and the card; it
is printed as one line and written to ``--out``; exit 0 only when every
selected row passed.

    python -m chainermn_tpu_torch.tools.convergence_ledger --out CONV.json
    python -m chainermn_tpu_torch.tools.convergence_ledger --device cpu \\
        --only mnist_mlp
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import torch

MNIST_ACC_FLOOR = 0.97
SEQ2SEQ_BLEU_FLOOR = 0.62
RESNET_ACC_FLOOR = 0.60
VIT_ACC_FLOOR = 0.60


def _device_argv(device):
    return ["--device", str(device)] if device is not None else []


def check_mnist(device=None, seed=0):
    from chainermn_tpu_torch.examples import train_mnist
    with tempfile.TemporaryDirectory() as tmp:  # the example's log file
        res = train_mnist.main(
            ["--communicator", "naive", "--epoch", "5", "--batchsize", "100",
             "--unit", "100", "--seed", str(seed)] + _device_argv(device)
            + ["--out", tmp])
    acc = float(res["log"][-1]["validation/accuracy"])
    if not acc >= MNIST_ACC_FLOOR:
        raise AssertionError(f"MNIST validation accuracy {acc} below floor "
                             f"{MNIST_ACC_FLOOR}")
    return {"seed": seed, "epochs": 5, "communicator": "naive",
            "val_accuracy": acc, "floor": MNIST_ACC_FLOOR}


def check_seq2seq(device=None, seed=0):
    from chainermn_tpu_torch.examples import seq2seq
    res = seq2seq.main(["--epoch", "30", "--seed", str(seed)]
                       + _device_argv(device))
    bleu = float(res["final"]["val_bleu"])
    if not bleu >= SEQ2SEQ_BLEU_FLOOR:
        raise AssertionError(f"seq2seq BLEU {bleu} below floor "
                             f"{SEQ2SEQ_BLEU_FLOOR}")
    return {"seed": seed, "epochs": 30, "task": "copy-reverse",
            "shapes": "example defaults", "val_bleu": bleu,
            "floor": SEQ2SEQ_BLEU_FLOOR}


def _check_imagenet(arch, extra_argv, floor, row, device=None, seed=0):
    """The synthetic-ImageNet rows: the example at 32 pixels and 8
    classes, validation accuracy of the last epoch against ``floor``."""
    from chainermn_tpu_torch.examples import train_imagenet
    res = train_imagenet.main(
        ["--arch", arch, "--image-size", "32", "--n-classes", "8",
         "--train-size", "2048", "--val-size", "256", "--batchsize", "16",
         "--epoch", "3", "--communicator", "xla", "--seed", str(seed)]
        + extra_argv + _device_argv(device))
    acc = float(res["log"][-1]["validation/accuracy"])
    if not acc >= floor:
        raise AssertionError(f"{arch} validation accuracy {acc} below floor "
                             f"{floor}")
    return {"seed": seed, "epochs": 3, "communicator": "xla",
            "val_accuracy": acc, "floor": floor, **row}


def check_tiny_resnet(device=None, seed=0):
    return _check_imagenet(
        "resnet50", ["--lr", "0.02"], RESNET_ACC_FLOOR,
        {"arch": "resnet50@32px/8cls", "lr": 0.02}, device, seed)


def check_tiny_vit(device=None, seed=0):
    return _check_imagenet(
        "vit_s16", ["--optimizer", "adam", "--lr", "1e-3"], VIT_ACC_FLOOR,
        {"arch": "vit_s16@32px/8cls", "optimizer": "adam", "lr": 1e-3},
        device, seed)


CHECKS = (("mnist_mlp", check_mnist),
          ("seq2seq_copy_reverse", check_seq2seq),
          ("tiny_resnet_synthetic_imagenet", check_tiny_resnet),
          ("tiny_vit_synthetic_imagenet", check_tiny_vit))


def select(only) -> list:
    """The names ``--only`` selects (all without it); an unknown name
    exits naming the known ones."""
    known = [n for n, _ in CHECKS]
    if only is None:
        return known
    chosen = {n for n in only.split(",") if n}
    unknown = chosen - set(known)
    if unknown:
        raise SystemExit(f"unknown check(s) {sorted(unknown)}; available: "
                         f"{sorted(known)}")
    return [n for n in known if n in chosen]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None)
    p.add_argument("--only", default=None,
                   help="comma-separated subset of check names")
    p.add_argument("--device", default=None,
                   help="default: cuda:LOCAL_RANK (pass 'cpu' for the CPU)")
    return p.parse_args(argv)


def run(names, device=None) -> dict:
    """The rows ``names`` in turn; returns the (unstamped) document."""
    from chainermn_tpu_torch.parallel.topology import env_int, resolve_device
    dev = resolve_device(device, env_int("LOCAL_RANK") or 0)
    on_gpu = dev.type == "cuda"
    doc = {"suite": "convergence_ledger", "backend": dev.type,
           "device_kind": torch.cuda.get_device_name(dev) if on_gpu
           else "cpu", "n_devices": 1,
           "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "checks": {}}
    fns = dict(CHECKS)
    for name in names:
        print(f"convergence: running {name} ...", file=sys.stderr,
              flush=True)
        t0 = time.perf_counter()
        try:
            row = fns[name](device)
            doc["checks"][name] = {"ok": True,
                                   "wall_s": time.perf_counter() - t0, **row}
        except Exception as e:  # noqa: BLE001 -- recorded, the rest run
            doc["checks"][name] = {"ok": False,
                                   "wall_s": time.perf_counter() - t0,
                                   "error": f"{type(e).__name__}: {e}"}
        print(f"convergence: {name}: {doc['checks'][name]}",
              file=sys.stderr, flush=True)
        if on_gpu:
            torch.cuda.empty_cache()
    if torch.distributed.is_initialized():
        doc["n_devices"] = torch.distributed.get_world_size()
    doc["ok"] = bool(doc["checks"]) and all(
        c["ok"] for c in doc["checks"].values())
    return doc


def main(argv=None) -> int:
    from chainermn_tpu_torch.observability.ledger import stamp_envelope
    args = parse_args(argv)
    doc = stamp_envelope(run(select(args.only), args.device),
                         "convergence_ledger/v1")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
    print(json.dumps(doc), flush=True)
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    rc = main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    sys.exit(rc)
