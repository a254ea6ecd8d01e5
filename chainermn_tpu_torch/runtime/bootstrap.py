"""Process-group bootstrap from arguments or the launcher's environment.

Counterpart of ``chainermn_tpu/runtime/bootstrap.py`` (``init_distributed``).
The JAX package starts its multi-controller runtime from the
``CHAINERMN_TPU_*`` variables; here ``torch.distributed`` starts from the
names ``torchrun`` exports (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), with the JAX
contract's names accepted in their place:

==============================  ==================================
torch.distributed               JAX contract
==============================  ==================================
``RANK``                        ``CHAINERMN_TPU_PROCESS_ID``
``WORLD_SIZE``                  ``CHAINERMN_TPU_NUM_PROCESSES``
``MASTER_ADDR:MASTER_PORT``     ``CHAINERMN_TPU_COORDINATOR``
==============================  ==================================

NCCL is the backend on a GPU and gloo on the CPU.  A single process with
none of these set is a world of one, with an in-process store.

:func:`install_crash_dumps` wires the flight recorder's dump to the
process-fatal events (JAX's); ``init_distributed`` calls it, and it does
nothing while observability is off.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from chainermn_tpu_torch.parallel.topology import (
    Topology, env_int, init_topology)


def _coordinator() -> Optional[str]:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if addr and port:
        return f"{addr}:{port}"
    return os.environ.get("CHAINERMN_TPU_COORDINATOR") or None


def install_crash_dumps(out_dir: Optional[str] = None,
                        rank: Optional[int] = None,
                        recorder=None, watchdog=None,
                        signals=None, force: bool = False):
    """Wire the flight-recorder dump path to process-fatal events:

    * unhandled exceptions (``sys.excepthook`` — dump, then chain to the
      previous hook so the traceback still prints);
    * fatal signals (default: ``SIGTERM``, the preemption/kill signal —
      dump, restore the prior disposition, re-deliver);
    * native crashes (``faulthandler.enable`` into
      ``flight_<rank>.stacks.txt`` — when the interpreter cannot run the
      JSON dump, the C-level stack writer still can).

    ``out_dir`` defaults to ``CHAINERMN_TPU_FLIGHT_DIR`` (else ``.``),
    ``rank`` to ``RANK`` (``CHAINERMN_TPU_PROCESS_ID`` in its place).
    Returns an ``uninstall()`` callable, or ``None`` (installing nothing)
    when observability is disabled and ``force`` is not set.  When a
    ``watchdog`` handle is passed, dumps go through its cross-rank state
    exchange; otherwise the dump is local-only.

    A Python signal handler runs only when the main thread next executes
    Python: a main thread blocked in ``torch.cuda.synchronize`` or a
    collective takes the ``SIGTERM`` dump after the call returns.  The
    watchdog's own thread dumps a hang without waiting for it.
    """
    import faulthandler
    import signal as _signal

    from chainermn_tpu_torch.observability import flight_recorder as _flight

    rec = recorder if recorder is not None else _flight.get_flight_recorder()
    if rec is None:
        if not force:
            return None
        rec = _flight.install_flight_recorder()
    if out_dir is None:
        out_dir = os.environ.get("CHAINERMN_TPU_FLIGHT_DIR", ".")
    if rank is None:
        rank = env_int("RANK", "CHAINERMN_TPU_PROCESS_ID") or 0

    def _dump(reason: str) -> None:
        try:
            if watchdog is not None:
                watchdog.dump_now(reason)
            else:
                # crash-time evidence stamp: ring capacity + overwrite
                # count travel in the dump so a reader can flag a
                # truncated evidence window
                rec.dump(out_dir=out_dir, rank=rank, reason=reason,
                         extra={"crash_dump": True,
                                "ring_capacity": int(rec.capacity),
                                "dropped_events": int(rec.dropped_events)})
        except Exception:
            pass  # the dump path must never mask the original failure

    prev_hook = sys.excepthook

    def _excepthook(tp, val, tb):
        _dump(f"unhandled_exception:{tp.__name__}: {val}")
        prev_hook(tp, val, tb)

    sys.excepthook = _excepthook

    fh_file = None
    try:
        os.makedirs(out_dir or ".", exist_ok=True)
        fh_file = open(os.path.join(out_dir or ".",
                                    f"flight_{rank}.stacks.txt"), "w")
        faulthandler.enable(file=fh_file)
    except OSError:
        fh_file = None

    prev_handlers = {}
    sigs = signals if signals is not None else (_signal.SIGTERM,)
    for sig in sigs:
        try:
            prev = _signal.getsignal(sig)

            def _handler(signum, frame, _prev=prev):
                _dump(f"signal:{_signal.Signals(signum).name}")
                restore = _prev if (callable(_prev) or _prev in (
                    _signal.SIG_IGN, _signal.SIG_DFL)) else _signal.SIG_DFL
                _signal.signal(signum, restore)
                os.kill(os.getpid(), signum)  # re-deliver to prior handler

            _signal.signal(sig, _handler)
            prev_handlers[sig] = prev
        except (ValueError, OSError):
            pass  # not the main thread, or unsupported signal

    def uninstall():
        sys.excepthook = prev_hook
        for sig, prev in prev_handlers.items():
            try:
                _signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        if fh_file is not None:
            try:
                faulthandler.disable()
                fh_file.close()
            except (OSError, ValueError):
                pass

    return uninstall


def init_distributed(device=None, coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Topology:
    """Initialize the default process group and return this process's
    :class:`Topology`.

    Args and environment as in the module docstring; ``device`` as in
    :func:`~chainermn_tpu_torch.parallel.topology.resolve_device` (CUDA
    unless ``"cpu"`` is asked for).  If the group is already initialized
    it is kept and only the topology is returned.  With observability on,
    the crash dumps are installed (:func:`install_crash_dumps`).
    """
    if dist.is_initialized():
        return init_topology(device)
    size = num_processes or env_int("WORLD_SIZE",
                                    "CHAINERMN_TPU_NUM_PROCESSES") or 1
    rank = process_id
    if rank is None:
        rank = env_int("RANK", "CHAINERMN_TPU_PROCESS_ID") or 0
    coordinator = coordinator or _coordinator()
    topo = init_topology(device, rank=rank, size=size)
    backend = "nccl" if topo.device.type == "cuda" else "gloo"
    if topo.device.type == "cuda":
        torch.cuda.set_device(topo.device)
    if coordinator is None:
        if size != 1:
            raise ValueError(
                "a multi-process world needs a coordinator: set MASTER_ADDR "
                "and MASTER_PORT (or CHAINERMN_TPU_COORDINATOR=host:port) "
                "or pass coordinator=")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                rank=rank, world_size=size)
    install_crash_dumps(rank=rank)  # nothing while observability is off
    return topo


__all__ = ["init_distributed", "install_crash_dumps"]
