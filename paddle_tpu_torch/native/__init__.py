"""Native (C++) host code of the port: the control plane's TCPStore.

Counterpart of ``paddle_tpu/native/__init__.py``: ``csrc/tcp_store.cpp``
(the port's own copy, the same wire protocol byte for byte, so either
package's client talks to either package's server) is host code, not a
kernel. It is compiled by ``g++`` (or ``c++``) at first use into a shared
library under ``build/torch_native/`` at the repository root, named by a
hash of the source and flags, and loaded with ``ctypes``; the build writes
a temporary file and moves it into place with ``os.replace``, so
concurrent first uses in several processes stay correct. Nothing here
imports torch: the store daemon loads this package alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load_library", "build", "TCPStore"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
OUT_DIR = _PKG.parent / "build" / "torch_native"
SOURCES = ("tcp_store.cpp",)
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_LIB = None
_LOCK = threading.Lock()


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no C++ compiler (g++ or c++) found: the control "
                       "plane's TCPStore cannot be built here")


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return OUT_DIR / f"libpaddle_tpu_torch_rt_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already there; returns its path.
    Raises ``RuntimeError`` with the compiler's output on failure."""
    so = _target()
    if so.exists():
        return so
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([_cxx(), *CXX_FLAGS,
                        *(str(CSRC / n) for n in SOURCES), "-o", str(tmp)],
                       capture_output=True, text=True)
    if r.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {so.name} failed:\n{r.stdout}"
                           f"{r.stderr}")
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    """The loaded store library (built on first use), with ``argtypes``
    and ``restype`` set for every entry point."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.ts_server_start.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_void_p)]
            lib.ts_server_start.restype = ctypes.c_int
            lib.ts_server_stop.argtypes = [ctypes.c_void_p]
            lib.ts_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.ts_client_connect.restype = ctypes.c_int
            lib.ts_set.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_int]
            lib.ts_set.restype = ctypes.c_int
            lib.ts_get.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_int]
            lib.ts_get.restype = ctypes.c_int
            lib.ts_wait.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_int64, ctypes.c_char_p,
                                    ctypes.c_int]
            lib.ts_wait.restype = ctypes.c_int
            lib.ts_add.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_int64]
            lib.ts_add.restype = ctypes.c_int64
            lib.ts_delete.argtypes = [ctypes.c_int, ctypes.c_char_p]
            lib.ts_delete.restype = ctypes.c_int
            lib.ts_close.argtypes = [ctypes.c_int]
            _LIB = lib
    return _LIB


from paddle_tpu_torch.native.tcp_store import TCPStore  # noqa: E402,F401
