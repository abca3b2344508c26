"""Fused lm-head + softmax cross-entropy, chunked over the vocab.

Counterpart of ``paddle_tpu/ops/fused_ce.py``. The JAX package writes it
in XLA (no Pallas kernel), so it ports as a torch composition. The (T, V)
logits are formed one vocab chunk at a time:

- forward: per chunk, an online max / sum-exp merge (the flash-attention
  recurrence applied to the softmax denominator) and the gold-label
  logit; the saved residuals are (hidden, head, labels, lse);
- backward: per chunk, the logits again, ``softmax - onehot`` scaled by
  the upstream gradient over the mean's denominator, then the dhidden and
  dhead products.

Logits are f32 sums of exact products of the io-dtype inputs (XLA's
``preferred_element_type=f32``): low-precision operands are widened to f32
and, on the card, multiplied with TF32 allowed for that product only. bf16
values are exact in TF32, so the products are exact and the sums f32.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.flags import flags

__all__ = ["fused_linear_cross_entropy", "fused_linear_ce_op",
           "fused_lm_loss", "fused_ce_lax", "auto_chunk"]


def _f32_matmul(a, b):
    """a @ b as exact products of a's and b's values summed in f32."""
    if a.dtype == b.dtype == torch.float32:
        return a @ b
    a, b = a.float(), b.float()
    if not a.is_cuda:
        return a @ b
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _fwd_impl(hidden, head, labels, chunk: int, ignore_index: int):
    T = hidden.shape[0]
    V = head.shape[1]
    chunk = min(chunk, V)
    dev = hidden.device
    m = torch.full((T,), float("-inf"), device=dev)
    s = torch.zeros((T,), device=dev)
    gold = torch.zeros((T,), device=dev)
    for base in range(0, V, chunk):
        logits = _f32_matmul(hidden, head[:, base:base + chunk])  # (T, c)
        c = logits.shape[1]
        m_new = torch.maximum(m, logits.amax(1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(1)
        m = m_new
        in_chunk = (labels >= base) & (labels < base + c)
        local = (labels - base).clamp(0, c - 1)
        gold = torch.where(in_chunk, logits.gather(1, local[:, None])[:, 0],
                           gold)
    lse = m + torch.log(s)
    not_ignored = labels != ignore_index
    in_range = (labels >= 0) & (labels < V)
    denom = not_ignored.sum().clamp_min(1)
    loss = torch.where(not_ignored & in_range, lse - gold, 0.0).sum() / denom
    return loss, lse


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, head, labels, chunk, ignore_index):
        labels = labels.long()
        loss, lse = _fwd_impl(hidden, head, labels, chunk, ignore_index)
        ctx.save_for_backward(hidden, head, labels, lse)
        ctx.chunk, ctx.ignore_index = chunk, ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, head, labels, lse = ctx.saved_tensors
        V = head.shape[1]
        chunk = min(ctx.chunk, V)
        not_ignored = (labels != ctx.ignore_index).float()
        active = not_ignored * ((labels >= 0) & (labels < V)).float()
        # mean over non-ignored tokens; ignored and out-of-range rows get
        # no gradient
        scale = (g / not_ignored.sum().clamp_min(1.0)) * active
        dh = torch.zeros(hidden.shape, device=hidden.device)
        dws = []
        for base in range(0, V, chunk):
            w = head[:, base:base + chunk]
            p = _f32_matmul(hidden, w).sub_(lse[:, None]).exp_()
            c = p.shape[1]
            hit = (labels >= base) & (labels < base + c)
            # softmax - onehot: -1 at each row's label in this chunk, -0
            # (no change) elsewhere; no data-dependent shapes, so a CUDA
            # graph can capture it
            p.scatter_add_(1, (labels - base).clamp(0, c - 1)[:, None],
                           hit.float().neg()[:, None])
            dlogits = p.mul_(scale[:, None]).to(hidden.dtype)
            dh += _f32_matmul(dlogits, w.t())
            dws.append(_f32_matmul(hidden.t(), dlogits))
        dhead = torch.cat(dws, 1)
        return dh.to(hidden.dtype), dhead.to(head.dtype), None, None, None


def fused_linear_cross_entropy(hidden, head, labels, chunk: int = 4096,
                               ignore_index: int = -100):
    """Mean over non-ignored tokens of CE(softmax(hidden @ head), labels).

    hidden (T, H), head (H, V), labels (T,) ints; returns an f32 scalar.
    The exact ``cross_entropy(ignore_index=...)`` semantics of the JAX
    package: only labels equal to ``ignore_index`` leave the mean's
    denominator; labels outside [0, V) that are not ``ignore_index`` add
    zero loss and zero gradient but count in the denominator."""
    return _FusedLinearCE.apply(hidden, head, labels, int(chunk),
                                int(ignore_index))


def auto_chunk(T: int, V: int) -> int:
    """Vocab chunk bounding the transient f32 logits block by
    ``flags.fused_ce_logits_budget_mb``: the whole vocab when (T, V) f32
    fits, else the largest multiple of 128 that does (at least 128)."""
    budget = flags.fused_ce_logits_budget_mb * 1e6
    if T * V * 4 <= budget:
        return V
    per = int(budget // (T * 4))
    return min(V, max(128, (per // 128) * 128))


def fused_ce_lax(hidden, head, labels, ignore_index: int = -100):
    """Unfused decomposition: materialized f32 logits and a stable
    logsumexp, the same semantics as the chunked op."""
    labels = labels.long()
    logits = _f32_matmul(hidden, head)
    m = logits.amax(1, keepdim=True)
    lse = m[:, 0] + torch.log(torch.exp(logits - m).sum(1))
    V = head.shape[1]
    gold = logits.gather(1, labels.clamp(0, V - 1)[:, None])[:, 0]
    not_ignored = labels != ignore_index
    in_range = (labels >= 0) & (labels < V)
    denom = not_ignored.sum().clamp_min(1)
    return torch.where(not_ignored & in_range, lse - gold, 0.0).sum() / denom


def fused_linear_ce_op(hidden, head, labels, chunk=None,
                       ignore_index: int = -100):
    """The JAX package's registered ``fused_linear_ce`` op: the unfused
    decomposition under ``flags.decompose_fused_ops``, else the chunked
    op (chunk from ``auto_chunk`` when not given)."""
    if flags.decompose_fused_ops:
        return fused_ce_lax(hidden, head, labels, ignore_index)
    if chunk is None:
        chunk = auto_chunk(hidden.shape[0], head.shape[1])
    return fused_linear_cross_entropy(hidden, head, labels, chunk,
                                      ignore_index)


def fused_lm_loss(hidden, head, labels, ignore_index: int = -100):
    """The model-side entry (Llama's ``loss``): flattens (..., H) hidden
    against an (H, V) head and picks the vocab chunk."""
    H = hidden.shape[-1]
    h2 = hidden.reshape(-1, H)
    return fused_linear_ce_op(h2, head, labels.reshape(-1),
                              chunk=auto_chunk(h2.shape[0], head.shape[1]),
                              ignore_index=ignore_index)
