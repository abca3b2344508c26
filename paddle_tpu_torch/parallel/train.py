"""The training step: model + optimizer -> one step on the card.

Counterpart of ``paddle_tpu/parallel/train.py`` on one device. The JAX
package lifts the model to a pure function and compiles forward,
``jax.grad`` and the optimizer's functional update into one jitted program
with donated buffers. The port runs the loss forward, takes the gradients
with ``torch.autograd`` and applies the update with
``optimizer.update_many`` (one multi-tensor kernel for ``Adam``/``AdamW``
on the card), writing parameters and optimizer state in place. On a CUDA
model that whole step becomes one CUDA graph, replayed once a step:

- the first ``train_step`` of a key (the batch's shapes and dtypes, the
  weight decay and every flag's value, ``flags.snapshot()``) runs the
  step eagerly on a side stream; this warm-up is a real step;
- the second captures forward, ``loss.backward()`` and ``update_many``
  into one ``torch.cuda.CUDAGraph`` over static batch buffers and
  replays it once; the gradients are the graph's own tensors from then
  on;
- later calls copy the batch into the static buffers and replay.

A key not seen before captures again, so turning a flag on in mid-run
takes effect (the JAX trainer keeps its first trace: ROADMAP.md section
3). The trainer keeps the ``_STEP_GRAPHS`` most recently used keys and
drops the oldest past that, with its graph and the graph's memory pool
(a whole step's activations and gradients). A failed capture raises; the
step never falls back to eager on the card. The kernel writes the
parameters through raw pointers, so the update and each replay bump the
parameters' version counters, as an in-place op would (a ``LlamaDecoder``
that ``model.generate`` cached rebuilds after it). The learning rate lives in an f32 device tensor that is refilled
when ``optimizer.get_lr()`` changes (the JAX trainer's ``_scalars``), so a
replay reads the current rate. Kernel launch counters keep counting
through replays (``ops.kernels.add_launches``). On the CPU every step runs
eagerly.

The optimizer state lives on the trainer, keyed by parameter name, as in
the JAX trainer; every trainable parameter takes
``optimizer._weight_decay``. The optimizer's ``grad_clip`` clips the
gradients between the backward and the update, inside the captured step
(``nn.clip.clip_grads``, the JAX trainer's ``_apply_grad_clip``).
``amp_dtype`` runs the loss under ``amp.auto_cast`` (parameters stay as
they are, f32 master weights with an f32 model), as the JAX trainer does.
Each step pushes a threefry key for the model's random ops (dropout),
``(0, seed)`` with ``seed`` an int32 counter on the device that starts at
``optimizer._step_count`` and is bumped by every step, inside the captured
step on a card, so every replay draws fresh masks; the JAX trainer's key
of a device counter (``flags.train_rng_impl``, of which the port has
``"threefry2x32"`` only: ROADMAP.md section 1, item 14.1).
``save`` / ``load`` write and read the JAX package's distributed
checkpoint format (``distributed/checkpoint.py``) under the keys of
``state_dict``, so a JAX trainer's checkpoint resumes here and the other
way round. Meshes of more than one device are not ported yet (ROADMAP.md
section 1, item 13); ``compile_lowered`` waits for item 16's ``jit/``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.autograd.graph import increment_version

from paddle_tpu_torch.amp.auto_cast import auto_cast
from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.framework import random as _rng
from paddle_tpu_torch.nn.clip import clip_grads
from paddle_tpu_torch.ops import kernels as _kernels

__all__ = ["ShardedTrainer"]

# step keys a trainer keeps (a captured step holds its own memory pool)
_STEP_GRAPHS = 2


def _not_ported(what: str, items: str = "item 13") -> \
        NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md section "
        f"1, {items})")


def _mesh_size(mesh) -> int:
    if isinstance(mesh, int):
        return mesh
    size = getattr(mesh, "size", None)
    if size is None:
        raise TypeError(f"mesh must be None, a device count or have a "
                        f"size, got {type(mesh).__name__}")
    return int(size() if callable(size) else size)


@dataclasses.dataclass
class _StepGraph:
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]   # static batch buffers
    loss: torch.Tensor           # static loss
    grads: Dict[str, torch.Tensor]   # static gradients, by parameter name
    launches: dict               # kernel launches one replay makes


class ShardedTrainer:
    """One-device trainer with the JAX ``ShardedTrainer``'s surface.

    ``loss_fn(model, *batch) -> scalar tensor`` drives the forward; the
    batch may be tensors or numpy arrays (ml_dtypes bfloat16 included).
    ``train_step(*batch)`` runs one step and returns the loss;
    ``train_steps(*stacked)`` runs K steps over (K, ...) inputs and
    returns the (K,) losses. Both advance ``optimizer._step_count``. The
    step runs on the model's device, as one replayed CUDA graph on a card
    (module docstring); batches are moved there. ``mesh`` may be None or
    one device; ``plan`` (placements per parameter name) is then a no-op,
    as the JAX trainer's is on a one-device mesh."""

    def __init__(self, model: torch.nn.Module, optimizer, loss_fn: Callable,
                 mesh=None, plan: Optional[Dict[str, Sequence]] = None,
                 amp_dtype: Optional[str] = None):
        if mesh is not None and _mesh_size(mesh) > 1:
            raise _not_ported("a mesh of more than one device")
        self.model = model
        self.amp_dtype = amp_dtype
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.params = {n: p for n, p in model.named_parameters()
                       if p.requires_grad}
        self.opt_state = {n: optimizer.init_state(p)
                          for n, p in self.params.items()}
        self._lr: Optional[tuple] = None     # (host value, f32 tensor)
        # the step key's counter, int32 on the device (the bits of the
        # JAX trainer's uint32), made at the first step
        self._seed_dev: Optional[torch.Tensor] = None
        # step key -> its _StepGraph, or None after the key's eager
        # warm-up step; the oldest keys go first past _STEP_GRAPHS
        self._graphs: "collections.OrderedDict[tuple, Optional[_StepGraph]]" \
            = collections.OrderedDict()
        #: host seconds the last step spent issuing its update: on a card,
        #: the whole step's graph replay (the device may still be running
        #: it when the step returns); on the CPU, the eager update
        self.update_host_s = 0.0

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def _put(self, b):
        if isinstance(b, torch.Tensor):
            return b.to(self.device)
        a = np.ascontiguousarray(b)
        if a.dtype.name == "bfloat16":
            # ml_dtypes' bfloat16, which torch.as_tensor does not take:
            # carry the bits over
            return torch.from_numpy(a.view(np.uint16)).view(
                torch.bfloat16).to(self.device)
        return torch.as_tensor(a, device=self.device)

    def _lr_tensor(self) -> torch.Tensor:
        """The learning rate as an f32 0-dim tensor on the device, refilled
        in place when ``optimizer.get_lr()`` changes (a captured step reads
        it from there)."""
        lr = float(self.optimizer.get_lr())
        if self._lr is None:
            self._lr = (lr, torch.full((), lr, dtype=torch.float32,
                                       device=self.device))
        elif self._lr[0] != lr:
            self._lr[1].fill_(lr)
            self._lr = (lr, self._lr[1])
        return self._lr[1]

    def _seed(self) -> torch.Tensor:
        """The step key's counter, made from ``optimizer._step_count`` at
        its first use."""
        if flags.train_rng_impl != "threefry2x32":
            raise _not_ported(f"train_rng_impl={flags.train_rng_impl!r} "
                              f"(the port's step key is threefry2x32)",
                              "item 14.1")
        if self._seed_dev is None:
            c = int(self.optimizer._step_count) & 0xFFFFFFFF
            self._seed_dev = torch.tensor(c - (c >> 31 << 32),
                                          dtype=torch.int32,
                                          device=self.device)
        return self._seed_dev

    def _loss(self, batch) -> torch.Tensor:
        """The loss under the step key ``(0, seed)``."""
        seed = self._seed()
        _rng.push_trace_key(torch.stack([torch.zeros_like(seed), seed]))
        try:
            if self.amp_dtype:
                with auto_cast(dtype=self.amp_dtype):
                    return self.loss_fn(self.model, *batch)
            return self.loss_fn(self.model, *batch)
        finally:
            _rng.pop_trace_key()

    def _update(self, lr: torch.Tensor) -> None:
        opt = self.optimizer
        names = list(self.params)
        for p in self.params.values():
            if p.grad is None:
                # a parameter the loss does not reach (BERT's token types
                # without token_type_ids): a zero gradient, as jax.grad
                # gives it
                p.grad = torch.zeros_like(p)
        grads = clip_grads(getattr(opt, "_grad_clip", None),
                           [self.params[n].grad for n in names])
        opt.update_many(grads,
                        [self.opt_state[n] for n in names],
                        [self.params[n] for n in names], lr,
                        getattr(opt, "_weight_decay", 0.0) or 0.0)

    def _eager(self, batch, lr) -> torch.Tensor:
        for p in self.params.values():
            p.grad = None
        loss = self._loss(batch)
        loss.backward()
        t0 = time.perf_counter()
        self._update(lr)
        self._seed_dev.add_(1)
        self.update_host_s = time.perf_counter() - t0
        for p in self.params.values():
            p.grad = None
        self.optimizer._step_count += 1
        return loss.detach()

    def _eager_step(self, *batch) -> torch.Tensor:
        """One step run eagerly on the current stream, on any device: the
        route the captured step is held against (no graph is made or
        used). Returns the loss."""
        return self._eager([self._put(b) for b in batch], self._lr_tensor())

    def _key(self, batch) -> tuple:
        return (tuple((tuple(b.shape), b.dtype) for b in batch),
                getattr(self.optimizer, "_weight_decay", 0.0),
                self.amp_dtype, flags.snapshot())

    def _capture(self, batch, lr) -> _StepGraph:
        inputs = [b.clone() for b in batch]
        for p in self.params.values():
            p.grad = None       # backward allocates them inside the graph
        graph = torch.cuda.CUDAGraph()
        before = _kernels.launch_counts()
        with _kernels.capture(graph):
            loss = self._loss(inputs)
            loss.backward()
            self._update(lr)
            self._seed_dev.add_(1)
        return _StepGraph(graph, inputs, loss.detach(),
                          {n: p.grad for n, p in self.params.items()},
                          _kernels.captured_launches(before))

    def _step(self, batch) -> torch.Tensor:
        """One step; returns the loss, which on a card may be the graph's
        static loss (the caller copies it out)."""
        lr = self._lr_tensor()
        if self.device.type != "cuda":
            return self._eager(batch, lr)
        key = self._key(batch)
        graphs = self._graphs
        if key not in graphs:
            # warm-up: the first step of this key, eager on a side stream
            graphs[key] = None
            while len(graphs) > _STEP_GRAPHS:
                graphs.popitem(last=False)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                loss = self._eager(batch, lr)
            torch.cuda.current_stream(self.device).wait_stream(side)
            return loss
        graphs.move_to_end(key)
        g = graphs[key]
        if g is None:
            g = graphs[key] = self._capture(batch, lr)
        else:
            for dst, src in zip(g.inputs, batch):
                dst.copy_(src)
        t0 = time.perf_counter()
        g.graph.replay()
        _kernels.add_launches(g.launches)
        for p in self.params.values():
            increment_version(p)    # the replay wrote them in place
        self.update_host_s = time.perf_counter() - t0
        self.optimizer._step_count += 1
        return g.loss

    def train_step(self, *batch) -> torch.Tensor:
        """One step; updates the parameters and optimizer state in place.
        Returns the loss (a 0-dim tensor on the device)."""
        return self._step([self._put(b) for b in batch]).clone()

    def train_steps(self, *stacked_batch) -> torch.Tensor:
        """K steps; input i of step k is ``stacked_batch[i][k]``. Returns
        the (K,) losses. On a card each step replays the step's graph (from
        the third step of a new key on), with no host sync between
        steps."""
        vals = [self._put(b) for b in stacked_batch]
        out = None
        for k in range(vals[0].shape[0]):
            loss = self._step([v[k] for v in vals])
            if out is None:
                out = loss.new_empty((vals[0].shape[0],))
            out[k] = loss
        return out

    # -- checkpoint ---------------------------------------------------------
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The JAX trainer's keys: ``model.<name>`` for every tensor of the
        model's state dict, ``opt.<name>.<state>`` for every optimizer
        state of a trainable parameter. The tensors are copies, on the
        model's device: a later step leaves them as they were, as the JAX
        trainer's immutable arrays are."""
        out = {f"model.{n}": t.clone()
               for n, t in self.model.state_dict().items()}
        for n, st in self.opt_state.items():
            for k, v in st.items():
                out[f"opt.{n}.{k}"] = v.clone()
        return out

    def save(self, path: str) -> None:
        """``state_dict()`` as a distributed checkpoint at ``path`` (the
        JAX format: one process, rank 0, each tensor whole)."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt
        ckpt.save_state_dict(self.state_dict(), path)

    @torch.no_grad()
    def load(self, path: str) -> None:
        """Read a checkpoint of ``state_dict()``'s keys into the model's
        tensors and the optimizer state, in place (a captured step keeps
        reading them where they are); each tensor keeps its dtype."""
        from paddle_tpu_torch.distributed import checkpoint as ckpt
        sd = self.state_dict()
        ckpt.load_state_dict(sd, path)
        for n, t in self.model.state_dict().items():
            t.copy_(sd[f"model.{n}"])
        for n, p in self.params.items():
            increment_version(p)
        for n, st in self.opt_state.items():
            for k, v in st.items():
                v.copy_(sd[f"opt.{n}.{k}"])

    def compile_lowered(self, *batch_shapes_dtypes):
        raise _not_ported("ShardedTrainer.compile_lowered (a lowered "
                          "program of the step: jit/)", "item 16")
