"""AOT export and load of programs: ``torch.export`` archives.

Counterpart of ``paddle_tpu/inference/aot.py``. Where the JAX package
writes ``jax.export``'s serialized StableHLO, the port writes a
``torch.export.save`` archive of an ``ExportedProgram`` (its graph as JSON,
its weights as raw tensor bytes). ``load_compiled`` rebuilds a callable
without running any model Python: a fresh process never imports the model
code, it calls the deserialized program, whose kernel calls are the
port's registered custom ops (``torch.ops.paddle_tpu_torch.*``, registered
when ``ops/kernels`` is imported, which this module does).

The file framing is the JAX package's, byte for byte, so each package's
``read_meta`` reads the other's files:

- ``PTPU-AOT1``: magic + the program bytes;
- ``PTPU-AOT2``: magic + 4-byte big-endian length + that many bytes of
  sorted-key JSON entry metadata + the program bytes.

The port writes format 2 only, its metadata always naming the program
format (``"program_format": "torch.export"``). A file whose program is not
a ``torch.export`` archive (a JAX package entry: StableHLO) is refused
typed (``ForeignProgramError``), and so is an archive that would unpickle
anything at load (``PickledArchiveError``): ``torch.export.load`` reads a
weight or constant marked as pickled, a custom object, or non-empty sample
inputs with ``pickle``, so the archive's layout is checked first and only
raw tensor bytes and JSON pass.
"""

from __future__ import annotations

import hashlib
import io
import json
import threading
import typing
import zipfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.fx.config

# registers the kernels' custom ops, which the loaded programs call
import paddle_tpu_torch.ops.kernels.decode_attention  # noqa: F401
import paddle_tpu_torch.ops.kernels.int8_matmul  # noqa: F401
import paddle_tpu_torch.ops.kernels.threefry  # noqa: F401
from paddle_tpu_torch.runtime.resilience import (CorruptBundleError,
                                                 atomic_write_bytes)

__all__ = ["save_compiled", "load_compiled", "read_meta", "read_entry",
           "load_program", "PROGRAM_FORMAT", "ForeignProgramError",
           "PickledArchiveError"]

_MAGIC = b"PTPU-AOT1\n"
_MAGIC2 = b"PTPU-AOT2\n"
_ZIP = b"PK\x03\x04"
#: the program format the port writes (its metadata's ``program_format``)
PROGRAM_FORMAT = "torch.export"


class ForeignProgramError(ValueError):
    """An AOT entry holds a program of another format than the port's
    ``torch.export`` archives (the JAX package's StableHLO modules)."""


class PickledArchiveError(ValueError):
    """A ``torch.export`` archive that ``torch.export.load`` would read
    with ``pickle`` (a pickled weight or constant, a custom object, sample
    inputs, a file outside the raw-tensor layout): refused unloaded."""


class _Program(torch.nn.Module):
    """A plain callable as a module, for ``torch.export``."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn, example_args: Sequence):
    """``torch.export.export`` of ``fn`` (a module, or a callable whose
    tensors become the program's constants) at the example args' shapes
    and dtypes, under ``no_grad``. The shapes are static: each bucket is
    its own program, the deployment contract of the JAX package."""
    module = fn if isinstance(fn, torch.nn.Module) else _Program(fn)
    # a node's Python stack trace is debugging metadata: collecting and
    # symbolizing it for every node is a quarter of a decoder step's trace
    # time, and serializing it bloats the archive's graph
    fx_config = torch.fx.config
    quiet = getattr(fx_config, "do_not_emit_stack_traces", None)
    if quiet is not None:
        fx_config.do_not_emit_stack_traces = True
    try:
        with torch.no_grad():
            ep = torch.export.export(module, tuple(example_args))
    finally:
        if quiet is not None:
            fx_config.do_not_emit_stack_traces = quiet
    # torch.export.save would pickle the example inputs into the archive
    ep.example_inputs = None
    return ep


def save_compiled(fn, example_args: Sequence, path: str,
                  meta: Optional[Dict[str, Any]] = None) -> str:
    """Export ``fn`` at the example args (``export_program``) and write the
    framed archive to ``path`` (format 2, ``meta`` plus
    ``program_format``), crash-safe (temp + atomic rename). Returns the
    sha256 of the intended file bytes, computed before the write, for the
    bundle manifest."""
    return save_program(export_program(fn, example_args), path, meta)


def archive_bytes(ep) -> bytes:
    """An ``ExportedProgram`` as ``torch.export.save`` archive bytes."""
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def write_entry(path: str, blob: bytes,
                meta: Optional[Dict[str, Any]] = None) -> str:
    """Write archive bytes framed (format 2, ``meta`` plus
    ``program_format``), crash-safe; returns the sha256 of the intended
    file bytes. Entries that share a program share its ``blob``."""
    mj = json.dumps(dict(meta or {}, program_format=PROGRAM_FORMAT),
                    sort_keys=True).encode()
    payload = _MAGIC2 + len(mj).to_bytes(4, "big") + mj + blob
    digest = hashlib.sha256(payload).hexdigest()
    atomic_write_bytes(path, payload)
    return digest


def save_program(ep, path: str,
                 meta: Optional[Dict[str, Any]] = None) -> str:
    """Write an ``ExportedProgram`` framed, as ``save_compiled`` does."""
    return write_entry(path, archive_bytes(ep), meta)


def _split(raw: bytes, path: str
           ) -> Tuple[Optional[Dict[str, Any]], bytes]:
    """(embedded meta or None, program bytes) for either format."""
    if raw[:len(_MAGIC2)] == _MAGIC2:
        off = len(_MAGIC2)
        n = int.from_bytes(raw[off:off + 4], "big")
        head, blob = raw[off + 4:off + 4 + n], raw[off + 4 + n:]
        if len(head) != n:
            raise ValueError(
                f"{path}: truncated AOT entry metadata ({len(head)} of "
                f"{n} declared bytes)")
        return json.loads(head.decode()), blob
    if raw[:len(_MAGIC)] == _MAGIC:
        return None, raw[len(_MAGIC):]
    raise ValueError(f"{path}: not a paddle_tpu AOT export")


def read_meta(path: str) -> Optional[Dict[str, Any]]:
    """The embedded entry metadata of an AOT export (either package's),
    without reading the program bytes. ``None`` for a format-1 file;
    ``ValueError`` for a file that is not an AOT export at all."""
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC2) + 4)
        if head[:len(_MAGIC2)] == _MAGIC2:
            n = int.from_bytes(head[len(_MAGIC2):], "big")
            raw = f.read(n)
            if len(raw) != n:
                raise ValueError(
                    f"{path}: truncated AOT entry metadata ({len(raw)} "
                    f"of {n} declared bytes)")
            return json.loads(raw.decode())
    if head[:len(_MAGIC)] == _MAGIC:
        return None
    raise ValueError(f"{path}: not a paddle_tpu AOT export")


def _check_archive(blob: bytes, path: str) -> None:
    """Refuse an archive that ``torch.export.load`` would unpickle from:
    every file must be a JSON record, a raw weight or tensor constant, or
    an empty sample-inputs record, and no payload may be marked pickled."""
    try:
        zf = zipfile.ZipFile(io.BytesIO(blob))
    except zipfile.BadZipFile as e:
        raise ForeignProgramError(
            f"{path}: the program is not a torch.export archive ({e})") \
            from e
    names = zf.namelist()
    root = names[0].split("/", 1)[0] + "/" if names else ""
    for name in names:
        rel = name[len(root):] if name.startswith(root) else name
        if rel in ("archive_format", "archive_version", ".data/version",
                   "byteorder", ".data/serialization_id") \
                or (rel.startswith("models/") and rel.endswith(".json")):
            continue
        if rel.startswith("data/sample_inputs/"):
            if zf.getinfo(name).file_size:
                raise PickledArchiveError(
                    f"{path}: {rel} holds pickled sample inputs")
            continue
        if rel.endswith("_config.json") and rel.startswith(
                ("data/weights/", "data/constants/")):
            for key, pm in json.loads(zf.read(name)).get(
                    "config", {}).items():
                if pm.get("use_pickle") or not str(
                        pm.get("path_name", "")).startswith(
                            ("weight_", "tensor_")):
                    raise PickledArchiveError(
                        f"{path}: {rel} marks {key!r} as a pickled "
                        f"payload ({pm.get('path_name')})")
            continue
        if rel.startswith("data/weights/weight_") or rel.startswith(
                "data/constants/tensor_"):
            continue
        raise PickledArchiveError(
            f"{path}: {rel} is outside the raw-tensor archive layout")


def read_entry(path: str, expected_sha256: Optional[str] = None
               ) -> Tuple[Optional[Dict[str, Any]], bytes]:
    """An entry's (metadata, archive bytes), verified: with
    ``expected_sha256`` (a bundle-manifest digest) the file bytes first
    (``CorruptBundleError``), then the program format
    (``ForeignProgramError``) and the archive layout
    (``PickledArchiveError``). Nothing is deserialized."""
    with open(path, "rb") as f:
        raw = f.read()
    if expected_sha256 is not None:
        got = hashlib.sha256(raw).hexdigest()
        if got != expected_sha256:
            raise CorruptBundleError(
                f"{path}: sha256 {got[:16]}… does not match the bundle "
                f"manifest's {expected_sha256[:16]}… — refusing to serve "
                f"a corrupt program ({len(raw)} bytes on disk)")
    meta, blob = _split(raw, path)
    fmt = (meta or {}).get("program_format")
    if blob[:len(_ZIP)] != _ZIP or fmt not in (None, PROGRAM_FORMAT):
        raise ForeignProgramError(
            f"{path}: holds a {fmt or 'StableHLO (jax.export)'} program, "
            f"not a {PROGRAM_FORMAT} archive: it was exported by the JAX "
            f"package; re-export it with paddle_tpu_torch.inference")
    _check_archive(blob, path)
    return meta, blob


class _CachedTyping:
    """``typing`` with ``get_type_hints`` memoized by class. torch's
    archive reader resolves the type hints of its schema dataclasses
    anew for every record of the graph it reads; the hints never change,
    and resolving them is most of a program's load time."""

    def __init__(self):
        self._hints: Dict[Any, Any] = {}

    def __getattr__(self, name):
        return getattr(typing, name)

    def get_type_hints(self, obj, globalns=None, localns=None,
                       include_extras=False):
        key = (obj, include_extras)
        hints = self._hints.get(key)
        if hints is None:
            hints = self._hints[key] = typing.get_type_hints(
                obj, globalns, localns, include_extras)
        return hints


_TYPING = _CachedTyping()
_LOAD_LOCK = threading.Lock()


def load_program(blob: bytes) -> Callable:
    """Archive bytes (``read_entry``'s) as a callable module. The reader
    resolves its schema's type hints through ``_CachedTyping`` while it
    runs (where the installed torch reads them through its module's
    ``typing``)."""
    from torch._export.serde import serialize as serde
    with _LOAD_LOCK:
        patch = getattr(serde, "typing", None) is typing
        if patch:
            serde.typing = _TYPING
        try:
            return torch.export.load(io.BytesIO(blob)).module()
        finally:
            if patch:
                serde.typing = typing


def load_compiled(path: str, expected_sha256: Optional[str] = None
                  ) -> Callable:
    """Load an AOT-exported program; returns it as a callable module (its
    input writes, a cache update, land in the tensors passed in). No model
    Python runs. The file is verified (``read_entry``) before anything is
    deserialized."""
    return load_program(read_entry(path, expected_sha256)[1])
