"""Multi-tensor Adam / AdamW: CUDA kernel and plain version.

The JAX package has no Pallas kernel for the optimizer update (XLA fuses
``optimizer.update`` inside the jitted training step); the kernel is
``paddle_tpu_torch/csrc/adam.cu`` and does the update of
``optimizer/adam.py`` for a list of parameters in one pass over memory.
``adam_ref`` is the update of one parameter, pure; ``adam_update`` updates
lists of parameters and their state tensors in place, by the kernel for
CUDA tensors and by ``adam_ref`` parameter by parameter for CPU tensors.
Both give the same bits on the card when ``lr`` is an f32 tensor (the
kernel reads it from device memory; a Python float is put into one).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.graph import increment_version

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["adam_ref", "adam_update", "adam_update_ref", "launches"]

#: update-kernel launches made by ``adam_update``, one per group of at
#: most ``adam_max_tensors()`` parameters of one (parameter dtype, moment
#: dtype, master weight) kind (plain-version calls do not count)
launches = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def adam_ref(p, g, m1, m2, master, b1p, b2p, lr, beta1: float,
             beta2: float, eps: float, wd: float, decoupled: bool):
    """One parameter's update: f32 math, then one cast to each output's
    dtype. ``master`` is the f32 master weight or None; ``decoupled``
    selects AdamW's decay (else Adam's L2 term on the gradient). ``lr`` is
    a float or an f32 0-dim tensor. Returns ``(p, m1, m2, master, b1p,
    b2p)`` new tensors (``master`` None without one)."""
    p32 = master if master is not None else p.float()
    g = g.float()
    if not decoupled:
        g = g + wd * p32
    b1p = b1p * beta1
    b2p = b2p * beta2
    m1n = beta1 * m1.float() + (1 - beta1) * g
    m2n = beta2 * m2.float() + (1 - beta2) * g.square()
    m1_hat = m1n / (1 - b1p)
    m2_hat = m2n / (1 - b2p)
    if decoupled:
        p32 = p32 * (1.0 - lr * wd)
    new_p32 = p32 - lr * m1_hat / (m2_hat.sqrt() + eps)
    return (new_p32.to(p.dtype), m1n.to(m1.dtype), m2n.to(m2.dtype),
            new_p32 if master is not None else None, b1p, b2p)


@torch.no_grad()
def adam_update_ref(params, grads, m1s, m2s, masters, b1ps, b2ps, lr,
                    beta1, beta2, eps, wd, decoupled) -> None:
    """Plain version of ``adam_update``: ``adam_ref`` parameter by
    parameter, the results copied into the tensors given."""
    for t in zip(params, grads, m1s, m2s, masters, b1ps, b2ps, strict=True):
        new = adam_ref(*t, lr, beta1, beta2, eps, wd, decoupled)
        for dst, src in zip((t[0], t[2], t[3], t[4], t[5], t[6]), new):
            if dst is not None:
                dst.copy_(src)


def _check(params, grads, m1s, m2s, masters, b1ps, b2ps, lr):
    dev = params[0].device
    for i, (p, g, m1, m2, w, b1p, b2p) in enumerate(zip(
            params, grads, m1s, m2s, masters, b1ps, b2ps, strict=True)):
        ts = [p, g, m1, m2, b1p, b2p] + ([w] if w is not None else [])
        if any(t.device != dev for t in ts):
            raise ValueError(f"adam_update: tensor {i} is not on {dev}")
        if not all(t.is_contiguous() for t in ts):
            raise ValueError(f"adam_update: tensor {i} is not contiguous")
        if (p.dtype not in _CODES or g.dtype != p.dtype
                or m1.dtype not in _CODES or m2.dtype != m1.dtype):
            raise ValueError(
                f"adam_update kernel does not take parameter {i} of "
                f"{p.dtype} with gradient {g.dtype} and moments "
                f"{m1.dtype}/{m2.dtype}")
        if not (g.shape == m1.shape == m2.shape == p.shape):
            raise ValueError(f"adam_update: shapes of tensor {i} differ")
        if w is not None and (w.dtype != torch.float32
                              or w.shape != p.shape):
            raise ValueError(f"adam_update: master weight {i} must be f32 "
                             f"of the parameter's shape")
        if (b1p.dtype != torch.float32 or b2p.dtype != torch.float32
                or b1p.numel() != 1 or b2p.numel() != 1):
            raise ValueError(f"adam_update: beta pows of {i} must be f32 "
                             f"scalars")
    if (not isinstance(lr, torch.Tensor) or lr.dtype != torch.float32
            or lr.numel() != 1 or lr.device != dev):
        raise ValueError(f"adam_update: lr must be a float or one f32 on "
                         f"{dev}")


def adam_update(params, grads, m1s, m2s, masters, b1ps, b2ps, lr,
                beta1: float, beta2: float, eps: float, wd: float,
                decoupled: bool) -> None:
    """Update the parameters, their moments, master weights (a list entry
    None where there is none) and beta pows in place. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise: one launch per
    group of at most ``adam_max_tensors()`` parameters of one kind, on the
    current stream, each followed by a one-block launch that advances the
    group's beta pows. The kernel writes through raw pointers, so the
    parameters' version counters are bumped here, as an in-place op would
    bump them."""
    global launches
    if not params:
        return
    dev = params[0].device
    if dev.type == "cpu":
        return adam_update_ref(params, grads, m1s, m2s, masters, b1ps, b2ps,
                               lr, beta1, beta2, eps, wd, decoupled)
    if dev.type != "cuda":
        raise ValueError(f"adam_update runs on cuda or cpu, got {dev}")
    if not isinstance(lr, torch.Tensor):
        lr = torch.full((), float(lr), dtype=torch.float32, device=dev)
    _check(params, grads, m1s, m2s, masters, b1ps, b2ps, lr)
    lib = _build.library()
    cap = lib.adam_max_tensors()
    groups = {}
    for i, (p, m1, w) in enumerate(zip(params, m1s, masters)):
        groups.setdefault((p.dtype, m1.dtype, w is not None), []).append(i)
    stream = torch.cuda.current_stream(dev).cuda_stream
    consts = (float(beta1), float(beta2), float(1.0 - beta1),
              float(1.0 - beta2), float(eps), float(wd))
    for (pdt, mdt, has_w), idx in groups.items():
        for s in range(0, len(idx), cap):
            part = idx[s:s + cap]
            table = np.array(
                [[params[i].data_ptr() for i in part],
                 [grads[i].data_ptr() for i in part],
                 [m1s[i].data_ptr() for i in part],
                 [m2s[i].data_ptr() for i in part],
                 [masters[i].data_ptr() if has_w else 0 for i in part],
                 [b1ps[i].data_ptr() for i in part],
                 [b2ps[i].data_ptr() for i in part],
                 [params[i].numel() for i in part]], dtype=np.int64)
            rc = lib.adam_launch(
                table.ctypes.data, len(part), _CODES[pdt], _CODES[mdt],
                int(has_w), int(decoupled), lr.data_ptr(), *consts, stream)
            if rc:
                raise RuntimeError(f"adam launch failed: "
                                   f"{_build.error_string(rc)} ({rc})")
            launches += 1
    for p in params:
        increment_version(p)
