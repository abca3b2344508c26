"""TCPStore python surface (phi TCPStore parity: set/get/wait/add +
barrier built on add/wait, tcp_store.h:121).

Counterpart of ``paddle_tpu/native/tcp_store.py`` over the port's own
``csrc/tcp_store.cpp``: the same wire protocol, so this client talks to
the JAX package's server and the other way round.

One difference (ROADMAP.md section 3, entry 42): the JAX client polls in
``wait`` with short native waits on its one connection; this client gives
every thread that waits a connection of its own, opened at its first
wait, and hands the server's blocking ``WAIT`` the whole remaining
timeout in one call. ``set``, ``get``, ``add`` and ``delete_key`` share
the store's main connection and never queue behind a wait."""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Optional

__all__ = ["TCPStore"]


class _Conn:
    """One client connection, closed when it is dropped: a thread's wait
    connection lives in a ``threading.local`` and goes with its thread."""

    def __init__(self, lib, fd: int):
        self.lib, self.fd = lib, fd

    def __del__(self):
        try:
            self.lib.ts_close(self.fd)
        except Exception:
            pass


class TCPStore:
    """KV store + barrier over the native server.

    ``TCPStore(host, port, is_master=True)`` starts the in-process server
    (master rank) and connects a client; workers connect only.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 30.0):
        from paddle_tpu_torch.native import load_library
        self._lib = load_library()
        self._server = None
        self.world_size = world_size
        self.timeout = timeout
        if is_master:
            handle = ctypes.c_void_p()
            rc = self._lib.ts_server_start(host.encode(), port,
                                           ctypes.byref(handle))
            if rc < 0:
                raise OSError(f"TCPStore server failed to start (errno {-rc})")
            self._server = handle
            port = rc
        self.host, self.port = host, port
        self._fd = self._connect()
        # One request/response in flight per connection: serialise the
        # calls on the main connection so a store shared across threads
        # (elastic heartbeats, RPC threads) cannot interleave frames on
        # the socket. Waits go over each thread's own connection.
        self._lock = threading.Lock()
        self._local = threading.local()

    def _connect(self) -> int:
        deadline = time.time() + self.timeout
        fd = -1
        while time.time() < deadline:
            fd = self._lib.ts_client_connect(self.host.encode(), self.port)
            if fd >= 0:
                return fd
            time.sleep(0.05)
        raise ConnectionError(f"TCPStore connect {self.host}:{self.port} "
                              f"failed")

    def _wait_fd(self) -> int:
        """This thread's wait connection, opened at its first wait."""
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = _Conn(self._lib, self._connect())
        return conn.fd

    # -- kv -----------------------------------------------------------------
    def set(self, key: str, value) -> None:
        data = value if isinstance(value, bytes) else str(value).encode()
        with self._lock:
            rc = self._lib.ts_set(self._fd, key.encode(), data, len(data))
        if rc != 0:
            raise IOError("TCPStore set failed")

    def get(self, key: str) -> Optional[bytes]:
        buf = ctypes.create_string_buffer(1 << 20)
        with self._lock:
            n = self._lib.ts_get(self._fd, key.encode(), buf, len(buf))
        if n == -1:
            return None
        if n < 0:
            raise IOError("TCPStore get io error")
        if n > len(buf):
            raise IOError(f"TCPStore get({key!r}): value of {n} bytes "
                          f"exceeds {len(buf)}-byte client buffer")
        return buf.raw[:n]

    def wait(self, key: str, timeout: Optional[float] = None) -> bytes:
        """Block until ``key`` exists and return its value.

        One blocking native wait for the whole timeout, over this thread's
        own connection: the server's condition variable wakes it as soon
        as the key is set (no polling window), and other threads'
        set/get/add on the main connection stay live meanwhile."""
        t = self.timeout if timeout is None else timeout
        buf = ctypes.create_string_buffer(1 << 20)
        n = self._lib.ts_wait(self._wait_fd(), key.encode(),
                              max(0, int(t * 1000)), buf, len(buf))
        if n >= 0:
            if n > len(buf):
                raise IOError(f"TCPStore wait({key!r}): value of {n} bytes "
                              f"exceeds {len(buf)}-byte client buffer")
            return buf.raw[:n]
        if n != -1:
            raise IOError("TCPStore wait io error")
        raise TimeoutError(f"TCPStore wait({key!r}) timed out")

    def add(self, key: str, delta: int = 1) -> int:
        with self._lock:
            r = self._lib.ts_add(self._fd, key.encode(), delta)
        if r == -(2 ** 63):
            raise IOError("TCPStore add io error")
        return int(r)

    def delete_key(self, key: str) -> None:
        with self._lock:
            rc = self._lib.ts_delete(self._fd, key.encode())
        if rc != 0:
            raise IOError("TCPStore delete failed")

    # -- barrier (store-based, parallel.py init barrier analog) -------------
    def barrier(self, name: str = "default", timeout: Optional[float] = None):
        n = self.add(f"__barrier__/{name}/count", 1)
        if n == self.world_size:
            self.set(f"__barrier__/{name}/go", b"1")
        self.wait(f"__barrier__/{name}/go", timeout)

    def __del__(self):
        try:
            if getattr(self, "_fd", -1) >= 0:
                self._lib.ts_close(self._fd)
            if getattr(self, "_server", None):
                self._lib.ts_server_stop(self._server)
        except Exception:
            pass
