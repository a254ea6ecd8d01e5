"""Point-to-point byte transport of the control plane.

Counterpart of ``chainermn_tpu/runtime/transport.py``: the wire layer
under :mod:`chainermn_tpu_torch.runtime.control_plane`.  Two backends:

* the native C++ framing core (``csrc/dcn_transport.cpp``, built with
  ``g++`` at first use and loaded via ctypes -- ``native.py``); and
* :class:`PyTransport`, pure Python.

Wire format (identical for both backends, and JAX's, so they interoperate):
  frame := u32 src | u32 tag | u64 len | len bytes payload
Handshake: every rank connects to the coordinator (rank 0) and sends its
listen address; rank 0 replies with the full peer table.  This mirrors the
reference's hostname-allgather bootstrap.

:func:`create_transport` builds the native backend and raises if it
cannot: unlike JAX's, it never drops to Python quietly.
``CHAINERMN_TPU_PURE_PY_TRANSPORT=1`` asks for :class:`PyTransport`.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import struct
import threading
import time
from typing import Dict, Tuple

_HDR = struct.Struct("<IIQ")

# Inbox high-water mark (bytes).  When a reader thread would push the inbox
# past this, it blocks until a consumer drains — TCP flow control then
# backpressures the sender, so memory stays bounded at roughly
# HWM + one message no matter how far ahead a peer runs.  The u64 framing
# has no message-size limit; this budget bounds the buffering.
_DEFAULT_HWM = 1 << 30


def _inbox_hwm() -> int:
    # Mirrors the C++ transport's guard: non-numeric or <= 0 values fall
    # back to the default rather than making the reader-park predicate
    # (inbox_bytes >= hwm) permanently true and deadlocking every recv.
    raw = os.environ.get("CHAINERMN_TPU_INBOX_HWM")
    if raw is None:
        return _DEFAULT_HWM
    try:
        val = int(raw)
    except ValueError:
        return _DEFAULT_HWM
    return val if val > 0 else _DEFAULT_HWM


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    # recv_into a preallocated buffer: GiB-scale frames must not allocate a
    # fresh buffer per recv() call (socket.recv allocates its bufsize
    # argument up front) and must not round-trip through bytearray.extend.
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed connection")
        got += k
    return bytes(buf)


class PyTransport:
    """Pure-Python full-mesh TCP transport with a listener thread per rank."""

    def __init__(self, rank: int, size: int, coordinator: str):
        self.rank = rank
        self.size = size
        # Flight-recorder seam, bound once at construction (None when
        # observability is off — the disabled wire path records nothing).
        from chainermn_tpu_torch.observability import (
            flight_recorder as _flight)
        self._flight = _flight.get_flight_recorder()
        self._inbox: Dict[Tuple[int, int], queue.Queue] = {}
        self._inbox_lock = threading.Lock()
        # Inbox byte budget (backpressure) — see _DEFAULT_HWM above.
        self._hwm = _inbox_hwm()
        self._inbox_bytes = 0
        self.peak_inbox_bytes = 0
        self._budget_cv = threading.Condition(self._inbox_lock)
        self._out: Dict[int, socket.socket] = {}
        # Per-destination locks: one slow peer must not serialize the whole
        # outbound plane (bcast from rank 0 fans out concurrently).
        self._out_locks: Dict[int, threading.Lock] = {}
        self._out_locks_guard = threading.Lock()
        self._closed = False

        # Listen on an ephemeral port; learn everyone's address via rank 0.
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", 0))
        self._listener.listen(size + 8)
        my_port = self._listener.getsockname()[1]
        my_host = os.environ.get("CHAINERMN_TPU_HOST", "127.0.0.1")

        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept_thread.start()

        chost, cport = coordinator.rsplit(":", 1)
        self.peers = self._handshake(chost, int(cport), f"{my_host}:{my_port}")

    # -- bootstrap -----------------------------------------------------------
    def _handshake(self, chost: str, cport: int, my_addr: str):
        if self.rank == 0:
            table = {0: my_addr}
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((chost if chost not in ("127.0.0.1", "localhost") else "0.0.0.0", cport))
            srv.listen(self.size + 8)
            conns = []
            while len(table) < self.size:
                c, _ = srv.accept()
                r, _, payload = self._read_frame(c)
                table[r] = payload.decode()
                conns.append((r, c))
            blob = json.dumps(sorted(table.items())).encode()
            for r, c in conns:
                self._write_frame(c, 0, 0, blob)
                c.close()
            srv.close()
            return dict(sorted(table.items()))
        # Non-root: register with coordinator, get the table back.
        deadline = time.time() + 60
        while True:
            try:
                c = socket.create_connection((chost, cport), timeout=5)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
        self._write_frame(c, self.rank, 0, my_addr.encode())
        _, _, blob = self._read_frame(c)
        c.close()
        # JSON, not pickle/eval: the handshake reads from an unauthenticated
        # socket and must not be able to execute anything.
        return {int(r): addr for r, addr in json.loads(blob.decode())}

    # -- framing -------------------------------------------------------------
    @staticmethod
    def _write_frame(sock, src, tag, payload: bytes):
        if len(payload) <= 64 * 1024:
            # One write for small frames (avoids a partial-header interleave
            # risk under TCP_NODELAY and halves syscalls on the hot
            # control-plane path).
            sock.sendall(_HDR.pack(src, tag, len(payload)) + payload)
        else:
            # Large frames: header then the payload itself — concatenating
            # would copy the whole (possibly multi-GiB) buffer.  sendall
            # streams from the original object; the kernel chunks it.
            sock.sendall(_HDR.pack(src, tag, len(payload)))
            sock.sendall(payload)

    @staticmethod
    def _read_frame(sock):
        src, tag, n = _HDR.unpack(_recv_exact(sock, _HDR.size))
        return src, tag, _recv_exact(sock, n)

    # -- receive path --------------------------------------------------------
    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._reader_loop, args=(conn,), daemon=True).start()

    def _reader_loop(self, conn):
        try:
            while True:
                src, tag, payload = self._read_frame(conn)
                self._enqueue(src, tag, payload, wait_budget=True)
        except (ConnectionError, OSError):
            conn.close()

    def _q(self, src, tag):
        with self._inbox_lock:
            return self._inbox.setdefault((src, tag), queue.Queue())

    def _enqueue(self, src, tag, payload, wait_budget: bool):
        with self._budget_cv:
            if wait_budget:
                # Reader threads block while the inbox is over budget; the
                # unread bytes then sit in the kernel socket buffers and TCP
                # flow control stalls the sender.  One message is always
                # admitted once the inbox is under the mark, so a single
                # payload larger than the budget still passes (peak usage
                # <= HWM + largest message).  Self-sends (wait_budget=False)
                # never block: the sender would be waiting on itself.
                while self._inbox_bytes >= self._hwm and not self._closed:
                    self._budget_cv.wait()
                if self._closed:
                    return
            self._inbox_bytes += len(payload)
            self.peak_inbox_bytes = max(self.peak_inbox_bytes,
                                        self._inbox_bytes)
            q = self._inbox.setdefault((src, tag), queue.Queue())
        q.put(payload)

    # -- public API ----------------------------------------------------------
    def send(self, dest: int, tag: int, payload: bytes):
        if self._flight is not None and tag < (1 << 28):
            self._flight.record("transport_send", dest=dest, tag=tag,
                                nbytes=len(payload))
        if dest == self.rank:
            self._enqueue(self.rank, tag, payload, wait_budget=False)
            return
        with self._out_locks_guard:
            lock = self._out_locks.setdefault(dest, threading.Lock())
        with lock:
            sock = self._out.get(dest)
            if sock is None:
                host, port = self.peers[dest].rsplit(":", 1)
                sock = socket.create_connection((host, int(port)), timeout=30)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._out[dest] = sock
            self._write_frame(sock, self.rank, tag, payload)

    def recv(self, source: int, tag: int, timeout: float = 300.0) -> bytes:
        # A wedged recv is the DCN face of a hang: track it as an open
        # span so the watchdog's deadline predicate sees it.  Watchdog
        # traffic itself (short-poll recvs on its own tag) stays out of
        # the ring.
        fl = self._flight
        if fl is not None and tag >= (1 << 28):
            fl = None
        tok = None
        if fl is not None:
            tok = fl.span_begin("transport_recv", f"recv[src={source}]",
                                tag=tag)
        try:
            payload = self._q(source, tag).get(timeout=timeout)
        except queue.Empty:
            if tok is not None:
                fl.span_end(tok, timed_out=True)
            raise TimeoutError(
                f"recv from rank {source} (tag {tag}) timed out after {timeout}s"
            ) from None
        if tok is not None:
            fl.span_end(tok, nbytes=len(payload))
        with self._budget_cv:
            self._inbox_bytes -= len(payload)
            self._budget_cv.notify_all()
        return payload

    def close(self):
        self._closed = True
        with self._budget_cv:
            self._budget_cv.notify_all()  # wake readers parked on the budget
        try:
            self._listener.close()
        except OSError:
            pass
        for s in list(self._out.values()):
            try:
                s.close()
            except OSError:
                pass
        self._out.clear()


def create_transport(rank: int, size: int, coordinator: str):
    """The native C++ core, or :class:`PyTransport` when
    ``CHAINERMN_TPU_PURE_PY_TRANSPORT=1`` asks for it (same protocol).

    A native backend that cannot be built or loaded raises (``ImportError``
    or ``OSError``, naming ``CHAINERMN_TPU_PURE_PY_TRANSPORT``): the port
    never falls back to Python quietly.  ``CHAINERMN_TPU_NATIVE_BUILD=0``
    disables the build, so the transport then raises unless Python is
    asked for."""
    if os.environ.get("CHAINERMN_TPU_PURE_PY_TRANSPORT") == "1":
        return PyTransport(rank, size, coordinator)
    from chainermn_tpu_torch.runtime.native import NativeTransport
    try:
        return NativeTransport(rank, size, coordinator)
    except ImportError as e:
        raise ImportError(
            f"the native control-plane transport is unavailable ({e}); set "
            "CHAINERMN_TPU_PURE_PY_TRANSPORT=1 to use the pure-Python one"
        ) from e


__all__ = ["PyTransport", "create_transport"]
