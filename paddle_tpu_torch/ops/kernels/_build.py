"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects
into one shared library with a plain ``extern "C"`` interface, which is
loaded with ``ctypes``.
No PyTorch headers are included, so a build takes seconds. The library
lands in ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``) under a name that hashes the sources and flags, so an
edited source rebuilds and an unchanged one loads at once. Nothing is
built when this module is imported: the first wrapper call on a CUDA
tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["SOURCES", "HEADERS", "library", "build", "build_log",
           "error_string"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
OUT_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("decode_attention.cu", "int8_matmul.cu", "flash_fwd.cu",
           "flash_bwd.cu", "rms_norm.cu", "group_norm.cu", "rope.cu",
           "adam.cu", "threefry.cu")
# headers the sources include: part of the library's hash
HEADERS = ("flash_common.cuh", "flash_f32.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every pointer and the stream as c_void_p: without argtypes ctypes would
# pass Python ints as 32-bit C ints and cut 64-bit device pointers
_SIGNATURES = {
    "decode_attention_launch": [_P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "int8_matmul_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "flash_attention_fwd_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _F, _I, _I, _P],
    "flash_attention_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                                   _P],
    "flash_attention_fwd_smem": [_I],
    "flash_attention_bwd_smem": [_I],
    "rms_norm_fwd_launch": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    "rms_norm_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P],
    "group_norm_fwd_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                              _I, _I, _I, _I, _I, _P],
    "group_norm_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rope_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "adam_launch": [_P, _I, _I, _I, _I, _I, _P, _F, _F, _F, _F, _F, _F,
                    _P],
    "adam_max_tensors": [],
    "threefry_launch": [_P, _I, _I, ctypes.c_uint, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took in this process (None: loaded, not built)
build_seconds: Optional[float] = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA "
                           "kernels cannot be built here")
    return found


def _target() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return OUT_DIR / f"libpaddle_tpu_torch_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> Path:
    """The compiler's output of the last build (``-Xptxas -v``: each
    kernel's registers, shared memory and spills)."""
    return OUT_DIR / "build.log"


def build() -> Path:
    """Compile and link the library unless it is already there; returns
    its path. Raises ``RuntimeError`` with the compiler's output when a
    source does not compile."""
    global build_seconds
    so = _target()
    if so.exists():
        return so
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    tmp_so = so.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [OUT_DIR / f"{tag}.{Path(n).stem}.o" for n in SOURCES]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(CSRC / n), "-o", str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, o in zip(SOURCES, objs)]
    logs = [(n, *p.communicate()) for n, p in zip(SOURCES, procs)]
    failed = [n for n, p in zip(SOURCES, procs) if p.returncode]
    text = "".join(f"== {n}\n{out}" for n, out, _ in logs)
    if not failed:
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_so)], capture_output=True, text=True)
        text += f"== link\n{link.stdout}{link.stderr}"
        if link.returncode:
            failed = ["link"]
    for o in objs:
        o.unlink(missing_ok=True)
    build_log().write_text(text)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{text}")
    os.replace(tmp_so, so)
    build_seconds = time.perf_counter() - t0
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with ``argtypes``
    and ``restype`` set for every entry point."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, args in _SIGNATURES.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = _I
            lib.ptt_error_string.argtypes = [_I]
            lib.ptt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def error_string(code: int) -> str:
    """``cudaGetErrorString`` of a code an entry point returned."""
    return library().ptt_error_string(int(code)).decode()
