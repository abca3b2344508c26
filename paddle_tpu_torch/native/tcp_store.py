"""TCPStore python surface (phi TCPStore parity: set/get/wait/add +
barrier built on add/wait, tcp_store.h:121).

Counterpart of ``paddle_tpu/native/tcp_store.py`` over the port's own
``csrc/tcp_store.cpp``: the same wire protocol, so this client talks to
the JAX package's server and the other way round."""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Optional

__all__ = ["TCPStore"]


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
        deadline = time.time() + timeout
        fd = -1
        while time.time() < deadline:
            fd = self._lib.ts_client_connect(host.encode(), port)
            if fd >= 0:
                break
            time.sleep(0.05)
        if fd < 0:
            raise ConnectionError(f"TCPStore connect {host}:{port} failed")
        self._fd = fd
        # One request/response in flight per connection: serialise all client
        # calls so a store shared across threads (elastic heartbeats, comm
        # watchdog) cannot interleave frames on the socket.
        self._lock = threading.Lock()

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

        Polls with short native waits rather than one long blocking wait so
        the connection lock is never held long (other threads' set/get/add
        stay live while we wait). Poll interval backs off 50ms -> 250ms to
        cut steady-state chatter during long waits.

        Caveat: polling leaves windows with no server-side waiter
        registered, so a key that is set and then deleted *between polls*
        is missed. Keys waited on must persist until every waiter has seen
        them (the barrier's 'go' key does).
        """
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.timeout)
        buf = ctypes.create_string_buffer(1 << 20)
        poll_ms = 50
        while True:
            remaining = deadline - time.monotonic()
            native_ms = max(0, min(poll_ms, int(remaining * 1000)))
            with self._lock:
                n = self._lib.ts_wait(self._fd, key.encode(), native_ms,
                                      buf, len(buf))
            if n >= 0:
                if n > len(buf):
                    raise IOError(f"TCPStore wait({key!r}): value of {n} bytes "
                                  f"exceeds {len(buf)}-byte client buffer")
                return buf.raw[:n]
            if n != -1:
                raise IOError("TCPStore wait io error")
            if time.monotonic() >= deadline:
                raise TimeoutError(f"TCPStore wait({key!r}) timed out")
            poll_ms = min(poll_ms * 2, 250)

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
