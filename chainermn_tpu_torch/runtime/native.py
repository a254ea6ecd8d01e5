"""ctypes binding for the native C++ transport core.

Counterpart of ``chainermn_tpu/runtime/native.py``.  Loads
``csrc/dcn_transport.cpp``, building it with ``g++ -O2 -std=c++17 -fPIC
-shared -pthread`` at first use.  Wire-compatible with
:class:`chainermn_tpu_torch.runtime.transport.PyTransport` (and JAX's
transports).

The library goes to ``build/native/`` of the checkout (never into the
package), under a name that carries a hash of the source and the flags, so
an edited source is rebuilt and a stale library is never loaded.  Several
processes may ask at once: the build runs under a file lock into a
temporary name that is then renamed into place (``ops/_build``'s
pattern).  ``CHAINERMN_TPU_NATIVE_BUILD=0`` disables the native backend,
as in JAX: loading then raises ``ImportError``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parents[1] / "csrc" / "dcn_transport.cpp"
BUILD = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
_BUILD_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library built from ``csrc/dcn_transport.cpp`` goes."""
    key = hashlib.sha256(SRC.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"libdcn-{key}.so"


def _build() -> str:
    if os.environ.get("CHAINERMN_TPU_NATIVE_BUILD") == "0":
        raise ImportError("native build disabled (CHAINERMN_TPU_NATIVE_BUILD=0)")
    out = library_path()
    if out.exists():
        return str(out)
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "dcn_transport.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it meanwhile
            return str(out)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            stderr = getattr(e, "stderr", b"") or b""
            raise ImportError(
                f"building dcn_transport failed: {e}\n{stderr.decode()}"
            ) from e
        os.replace(tmp, out)  # atomic under concurrent builders
    return str(out)


def _load() -> ctypes.CDLL:
    global _lib
    with _BUILD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.dcn_create.restype = ctypes.c_void_p
            lib.dcn_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_char_p, ctypes.c_char_p]
            lib.dcn_send.restype = ctypes.c_int
            lib.dcn_send.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_uint32, ctypes.c_char_p,
                                     ctypes.c_uint64]
            lib.dcn_recv.restype = ctypes.c_int64
            lib.dcn_recv.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_uint32, ctypes.c_double,
                                     ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
            lib.dcn_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            lib.dcn_peers.restype = ctypes.c_int64
            lib.dcn_peers.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int64]
            lib.dcn_stats.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.POINTER(ctypes.c_uint64)]
            lib.dcn_close.argtypes = [ctypes.c_void_p]
            lib.dcn_shutdown.argtypes = [ctypes.c_void_p]
            lib.dcn_destroy.argtypes = [ctypes.c_void_p]
            lib.dcn_last_error.restype = ctypes.c_char_p
            _lib = lib
    return _lib


class NativeTransport:
    """Same surface as ``PyTransport`` (send/recv/close/peers), C++ core.

    Lifetime safety: every FFI call into the handle is bracketed by an
    in-flight counter.  ``close()`` (a) marks the transport closed so new
    callers fail fast with OSError, (b) runs the native shutdown — which
    is what unblocks callers already inside ``dcn_send``/``dcn_recv`` —
    (c) waits for the in-flight count to reach zero, and only then (d)
    frees the native object.  Without (c)/(d) split a concurrent caller
    could touch freed memory (use-after-free).
    """

    def __init__(self, rank: int, size: int, coordinator: str):
        lib = _load()
        self._lib = lib
        self.rank = rank
        self.size = size
        my_host = os.environ.get("CHAINERMN_TPU_HOST", "127.0.0.1")
        handle = lib.dcn_create(rank, size, coordinator.encode(),
                                my_host.encode())
        if not handle:
            raise OSError(
                f"native transport init failed: "
                f"{lib.dcn_last_error().decode()}")
        self._handle = handle
        self._closed = False
        self._inflight = 0
        self._cv = threading.Condition()
        self._destroyed = threading.Event()

    def _enter(self):
        with self._cv:
            if self._closed:
                raise OSError("transport closed")
            self._inflight += 1

    def _exit(self):
        with self._cv:
            self._inflight -= 1
            if self._inflight == 0:
                self._cv.notify_all()

    @property
    def peers(self):
        import json

        self._enter()
        try:
            buf = ctypes.create_string_buffer(65536)
            n = self._lib.dcn_peers(self._handle, buf, len(buf))
            if n < 0:
                raise OSError("peer table too large")
            return {int(r): a for r, a in json.loads(buf.value.decode())}
        finally:
            self._exit()

    @property
    def peak_inbox_bytes(self) -> int:
        """High-water mark of inbox buffering (backpressure evidence)."""
        self._enter()
        try:
            cur = ctypes.c_uint64()
            peak = ctypes.c_uint64()
            self._lib.dcn_stats(self._handle, ctypes.byref(cur),
                                ctypes.byref(peak))
            return int(peak.value)
        finally:
            self._exit()

    def send(self, dest: int, tag: int, payload: bytes):
        self._enter()
        try:
            rc = self._lib.dcn_send(self._handle, dest, tag, payload,
                                    len(payload))
            if rc != 0:
                raise OSError(f"native send failed: "
                              f"{self._lib.dcn_last_error().decode()}")
        finally:
            self._exit()

    def recv(self, source: int, tag: int, timeout: float = 300.0) -> bytes:
        self._enter()
        try:
            out = ctypes.POINTER(ctypes.c_uint8)()
            n = self._lib.dcn_recv(self._handle, source, tag, timeout,
                                   ctypes.byref(out))
            if n < 0:
                raise TimeoutError(
                    f"native recv from rank {source} (tag {tag}): "
                    f"{self._lib.dcn_last_error().decode()}")
            try:
                if n < (1 << 31):
                    return ctypes.string_at(out, n)
                # ctypes._string_at takes a C int internally; >=2 GiB sizes
                # wrap negative.  Cast to a fixed-size array instead (array
                # lengths are ssize_t) and copy out.
                return bytes(
                    ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8 * n))
                    .contents)
            finally:
                self._lib.dcn_free(out)
        finally:
            self._exit()

    def close(self):
        with self._cv:
            already_closing = self._closed
            self._closed = True  # new callers now fail fast in _enter
        if already_closing:
            # A concurrent closer won the race; close() returning must
            # still mean "the winner's teardown finished", so wait for it.
            self._destroyed.wait()
            return
        try:
            # Shutdown unblocks in-flight callers (fd shutdown + cv
            # wakeups); it must run BEFORE waiting on them, or a blocked
            # recv would pin close() for its full timeout.
            self._lib.dcn_shutdown(self._handle)
            with self._cv:
                while self._inflight:
                    self._cv.wait()
            self._lib.dcn_destroy(self._handle)
        finally:
            # Set even on failure: a raised close() must not convert every
            # later close() into a permanent _destroyed.wait() hang.
            self._destroyed.set()
