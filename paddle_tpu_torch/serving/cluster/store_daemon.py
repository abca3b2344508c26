"""Standalone TCPStore rendezvous daemon — the control plane's anchor.

Counterpart of ``paddle_tpu/serving/cluster/store_daemon.py``.

Before this daemon the frontend hosted the cluster's TCPStore
in-process (rank 0's master ``RpcAgent``): SIGKILL the frontend and
the rendezvous died with it, taking every worker's RPC stream and
heartbeat along — the last single point of failure. ``launch_cluster``
now spawns THIS tiny process first; the frontend and every worker
connect to it as plain clients, so a frontend death leaves the store
(and therefore the workers, their registrations, and the frontend
epoch counter used for zombie fencing) fully intact for the respawned
incarnation to re-adopt.

The daemon is deliberately minimal: it runs as a plain SCRIPT (spawned
by file path, not ``-m``) and stubs the ``paddle_tpu_torch`` package in
``sys.modules`` before importing ``tcp_store``, so it never pays
``import torch`` — it must come up in milliseconds and
hold nothing but sockets. Config rides the ``PADDLE_TPU_TORCH_STORE_CFG``
env JSON (``{"port_file": ..., "host": ...}``); once the store is
listening the daemon writes ``{"host", "port", "pid"}`` to
``port_file`` atomically (tmp + fsync + rename) — the parent polls
that file instead of parsing stdout. SIGTERM/SIGINT shut it down.
"""

import json
import os
import signal
import sys
import threading
import types

ENV_CFG = "PADDLE_TPU_TORCH_STORE_CFG"


def _import_tcp_store():
    """Import TCPStore WITHOUT importing the paddle_tpu_torch package proper
    (whose submodules pull torch — seconds of startup the rendezvous
    must not pay). ``native/__init__`` is ctypes/subprocess only, so a
    bare package stub with the right ``__path__`` is enough."""
    if "paddle_tpu_torch" not in sys.modules:
        pkg_dir = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        root = os.path.dirname(pkg_dir)
        if root not in sys.path:
            sys.path.insert(0, root)
        pkg = types.ModuleType("paddle_tpu_torch")
        pkg.__path__ = [pkg_dir]
        sys.modules["paddle_tpu_torch"] = pkg
    from paddle_tpu_torch.native.tcp_store import TCPStore
    return TCPStore


def main() -> int:
    cfg = json.loads(os.environ[ENV_CFG])
    host = cfg.get("host", "127.0.0.1")
    port_file = cfg["port_file"]

    TCPStore = _import_tcp_store()
    store = TCPStore(host=host, port=0, is_master=True)

    stop = threading.Event()

    def _on_signal(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    tmp = port_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"host": store.host, "port": store.port,
                   "pid": os.getpid()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, port_file)

    while not stop.is_set():
        stop.wait(0.2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
