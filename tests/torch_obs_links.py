"""Link names and seeded flight-event streams for the port's observability
parity tests.

JAX's link classes are ``"ici"`` and ``"dcn"``, the port's ``"nvlink"``
and ``"ib"``; the attribution buckets keep JAX's names (``ici_comm``,
``dcn_comm``) on both sides.  :func:`to_port` renames a JAX document's
link names so it can be held equal to the port's: exact string keys and
values, and the ``:<link>`` suffix of a plan-stage key
(``flat:0:all_reduce:inter:dcn``).  Field names, bucket names and floats
are left as they are.

:func:`seeded_events` makes one rank's flight-event stream from a numpy
seed: steps with their phases, plan stages on both link classes (some of
them inside a ``collective`` wrapper), FSDP gathers overlapping them,
object ops and a checkpoint, and an ``attribution_regression`` marker.

:func:`socket_world` starts a ``SocketControlPlane`` world in threads of
this process, on the Python or the native transport, and :func:`on_ranks`
runs a function on every rank of it at once.
"""

import socket
import threading

import numpy as np

JOIN_S = 60

LINKS = {"ici": "nvlink", "dcn": "ib"}


def to_port(obj):
    if isinstance(obj, dict):
        return {to_port(k): to_port(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(v) for v in obj)
    if isinstance(obj, str):
        if obj in LINKS:
            return LINKS[obj]
        head, sep, tail = obj.rpartition(":")
        if sep and tail in LINKS:
            return f"{head}:{LINKS[tail]}"
    return obj


def port_events(events):
    """The same events with the port's link names in their ``link``
    field (what the port's executor records)."""
    return [dict(e, link=LINKS.get(e["link"], e["link"]))
            if "link" in e else dict(e) for e in events]


def seeded_events(seed, rank=0, steps=4, base=1000.0):
    """One rank's event stream (see the module note); timestamps in
    seconds from ``base``, edges strictly inside their step."""
    rng = np.random.RandomState(seed + 7919 * rank)
    evs, seq = [], [0]

    def ev(kind, ts, **f):
        evs.append({"kind": kind, "ts": float(ts), "seq": seq[0], **f})
        seq[0] += 1

    t = base
    op_seq = 0
    for it in range(1, steps + 1):
        step_s = float(rng.uniform(0.08, 0.12))
        t0 = t
        marks = np.sort(rng.uniform(0.0, 0.2, size=3)) * step_s
        for ph, m in zip(("data_load", "host_put", "dispatch"), marks):
            ev("phase", t0 + m, phase=ph, iteration=it)
        ev("phase", t0 + 0.25 * step_s, phase="device_block", iteration=it)
        # a collective wrapper over its plan's stages (the guard's pair)
        w0 = t0 + float(rng.uniform(0.26, 0.3)) * step_s
        op_seq += 1
        ev("collective_begin", w0, op="allreduce_grad", op_seq=op_seq,
           comm="world", nbytes=1 << 22)
        cur = w0
        for i, (scope, link) in enumerate((("intra", "ici"),
                                           ("inter", "dcn"),
                                           ("intra", "ici"))):
            dur = float(rng.uniform(0.02, 0.06)) * step_s
            nb = int(rng.randint(1 << 16, 1 << 22))
            st = dict(plan="hierarchical", stage=i, op="all_reduce",
                      scope=scope, link=link, nbytes=nb)
            ev("plan_stage_begin", cur + 1e-5, **st)
            ev("plan_stage_end", cur + dur, **st)
            cur += dur + 2e-5
        ev("collective_end", cur, op="allreduce_grad", op_seq=op_seq,
           comm="world")
        # an FSDP gather and a MoE hop overlapping it (contention)
        g0 = cur + float(rng.uniform(0.0, 0.05)) * step_s
        g1 = g0 + float(rng.uniform(0.05, 0.1)) * step_s
        fs = dict(bucket=int(rng.randint(4)), link="ici",
                  nbytes=int(rng.randint(1 << 18, 1 << 22)))
        ev("fsdp_gather_begin", g0, **fs)
        m0 = g0 + 0.5 * (g1 - g0)
        moe = dict(plan="alltoall_hier", stage=0, op="all_to_all",
                   scope="intra", link="ici",
                   nbytes=int(rng.randint(1 << 16, 1 << 20)))
        ev("plan_stage_begin", m0, **moe)
        ev("fsdp_gather_end", g1, **fs)
        ev("plan_stage_end", g1 + 0.03 * step_s, **moe)
        # an object op, a checkpoint overlapping the inter-node hop's
        # time window on odd steps
        o0 = g1 + 0.05 * step_s
        op_seq += 1
        ev("object_begin", o0, op="bcast_obj", op_seq=op_seq)
        ev("object_end", o0 + 0.02 * step_s, op="bcast_obj", op_seq=op_seq)
        if it % 2:
            c0 = o0 + 0.01 * step_s
            ev("checkpoint_begin", c0, op="save", op_seq=op_seq)
            ev("checkpoint_end", c0 + 0.1 * step_s, op="save",
               op_seq=op_seq)
        ev("step", t0 + step_s, dur_s=step_s, iteration=it)
        t = t0 + step_s + float(rng.uniform(0.0, 0.01))
    ev("attribution_regression", t, bucket="dcn_comm", ratio=3.0,
       iteration=steps)
    return evs


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def socket_world(size, backend="python"):
    """``size`` socket control planes of the port (one thread boots each
    rank); close them with ``plane.shutdown()``."""
    from chainermn_tpu_torch.runtime.control_plane import SocketControlPlane
    from chainermn_tpu_torch.runtime.native import NativeTransport
    from chainermn_tpu_torch.runtime.transport import PyTransport
    tp_cls = PyTransport if backend == "python" else NativeTransport
    coord = f"127.0.0.1:{_free_port()}"
    out = [None] * size

    def boot(r):
        out[r] = SocketControlPlane(r, size, coord,
                                    transport=tp_cls(r, size, coord))

    ts = [threading.Thread(target=boot, args=(r,), daemon=True)
          for r in range(size)]
    [t.start() for t in ts]
    [t.join(JOIN_S) for t in ts]
    assert all(o is not None for o in out), "socket world did not start"
    return out


def on_ranks(fn, n):
    """``[fn(r) for r in range(n)]``, each call in its own thread."""
    res, errs = [None] * n, []

    def body(r):
        try:
            res[r] = fn(r)
        except Exception as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=body, args=(r,), daemon=True)
          for r in range(n)]
    [t.start() for t in ts]
    [t.join(JOIN_S) for t in ts]
    assert not any(t.is_alive() for t in ts), "a rank hung"
    if errs:
        raise errs[0]
    return res
