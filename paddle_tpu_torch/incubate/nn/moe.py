"""Mixture-of-Experts layers on one device.

Counterpart of ``paddle_tpu/incubate/nn/moe.py``. ``MoEMLP`` holds the
experts' FFN weights stacked, ``(E, H, F)`` and ``(E, F, H)``, and
dispatches one of two ways:

- ``dispatch="capacity"``: the top-k assignments (k-major, so top-1
  assignments take capacity first) are scattered into a capacity-padded
  ``(E * C, H)`` buffer in one index-add, the experts run as one batched
  product, and the outputs are gathered back to token order and mixed by
  their gates; assignments past an expert's capacity are dropped;
- ``dispatch="ragged"``: dropless. The assignments are sorted by expert
  (a stable sort, as ``jnp.argsort``) and the grouped product runs over
  per-expert row counts (``lax.ragged_dot``): on a card
  ``torch._grouped_mm`` over the counts' int32 cumulative offsets, on the
  CPU one product an expert.

Every op of both routes is safe under CUDA-graph capture (the trainer
captures the step): no host sync, no data-dependent shape; the counts are
a ``scatter_add_`` of ones, as ``jnp.bincount(length=E)``. ``MoELayer``
keeps paddle's list-of-experts API over the capacity dispatch. Both set
``aux_loss`` (the GShard load-balancing loss) at every forward. Expert
parallelism (``ep_plan``, the JAX package's ragged shard_map route) waits
for meshes (ROADMAP.md section 1, item 13).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from paddle_tpu_torch.amp.auto_cast import amp_cast
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import LayerList, Linear, _param
from paddle_tpu_torch.device import resolve_device

__all__ = ["MoEMLP", "MoELayer"]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md section "
        f"1, item 13)")


def _capacity(factor: float, n_tokens: int, top_k: int,
              n_experts: int) -> int:
    """Slots an expert: ``factor * T * k / E``, at least k."""
    return max(int(factor * n_tokens * top_k / n_experts), top_k)


def _topk_gates(probs, top_k: int, normalize_topk: bool):
    """The top-k experts of each token and their gates, ties to the lower
    expert index (``lax.top_k``); renormalized to sum 1 with
    ``normalize_topk`` and k > 1."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gatev, topi = vals[..., :top_k], idx[..., :top_k]
    if normalize_topk and top_k > 1:
        gatev = gatev / gatev.sum(-1, keepdim=True)
    return gatev, topi


def _one_shot_dispatch(tokens, probs, n_experts: int, top_k: int,
                       capacity: int, normalize_topk: bool):
    """The capacity dispatch: ``(buf (E*C, H), slot (K*T,), keep (K*T,),
    gate (K*T, 1))``, the assignments k-major, each one's 0-based arrival
    position inside its expert from a cumulative sum of the one-hot rows
    (in integers), ``keep`` whether it fits the capacity."""
    gatev, topi = _topk_gates(probs, top_k, normalize_topk)
    e_flat = topi.t().reshape(-1)                                  # (KT,)
    gate_flat = gatev.t().reshape(-1)
    onehot = F.one_hot(e_flat, n_experts).long()                  # (KT, E)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
    keep = (pos < capacity).to(tokens.dtype)
    slot = e_flat * capacity + pos.clamp(0, capacity - 1)
    tokens_rep = tokens.repeat(top_k, 1)                           # (KT, H)
    buf = tokens.new_zeros((n_experts * capacity, tokens.shape[1]))
    buf = buf.index_add(0, slot, tokens_rep * keep[:, None])
    return buf, slot, keep, gate_flat[:, None]


def _one_shot_combine(y_flat, slot, keep, gate, top_k: int, T: int):
    """Each assignment's output gathered back to token order, masked,
    scaled by its gate and summed over the k assignments of a token."""
    picked = y_flat.index_select(0, slot) * keep[:, None] * gate
    return picked.reshape(top_k, T, y_flat.shape[-1]).sum(0)


def _aux_loss(probs, top1, n_experts: int):
    """GShard load balancing: E * sum_e mean(p_e) * frac(top1 == e)."""
    me = probs.mean(0)
    ce = F.one_hot(top1, n_experts).mean(0)
    return (me * ce).sum() * n_experts


#: forward calls of ``torch._grouped_mm`` made from Python (an eager call
#: or a capture; a graph replay makes them without Python)
grouped_mm_calls = 0


def _ragged_dot(x, w, group_sizes):
    """``lax.ragged_dot``: rows ``[o_e, o_e + n_e)`` of x (sorted by
    expert, ``n_e = group_sizes[e]``) times ``w[e]``."""
    global grouped_mm_calls
    if x.is_cuda:
        offs = torch.cumsum(group_sizes, 0).to(torch.int32)
        grouped_mm_calls += 1
        return torch._grouped_mm(x, w, offs=offs)
    out, start = [], 0
    for e, n in enumerate(group_sizes.tolist()):
        out.append(x[start:start + n] @ w[e])
        start += n
    return torch.cat(out)


def _ragged_ffn(activation: str, top_k: int, n_experts: int, tokens, gatev,
                topi, w1, b1, w2, b2):
    """The dropless expert FFN: every assignment through its expert, no
    capacity, no drop."""
    act = getattr(F, activation)
    T, H = tokens.shape
    e_flat = topi.t().reshape(-1)                                  # (KT,)
    g_flat = gatev.t().reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    inv = torch.argsort(order)
    rep = tokens.repeat(top_k, 1).index_select(0, order)
    gs = torch.zeros(n_experts, dtype=torch.long, device=tokens.device) \
        .scatter_add_(0, e_flat, torch.ones_like(e_flat))
    e_sorted = e_flat.index_select(0, order)
    dt = torch.promote_types(rep.dtype, w1.dtype)

    # each row's expert bias as a one-hot product: the same values as a
    # gather, and a backward that sums each expert's rows in one GEMM
    # (f32 accumulation, a fixed order) where a gather's backward would
    # add them atomically, rounding at every add in bf16
    onehot = F.one_hot(e_sorted, n_experts).to(dt)

    def bias_rows(b):
        return onehot @ b.reshape(n_experts, -1).to(dt)

    h = act(_ragged_dot(rep.to(dt), w1.to(dt), gs) + bias_rows(b1))
    y = _ragged_dot(h, w2.to(dt), gs) + bias_rows(b2)
    y = y.index_select(0, inv) * g_flat[:, None]
    return y.reshape(top_k, T, H).sum(0)


class MoEMLP(nn.Module):
    """Stacked-expert FFN ``y = act(x @ w1[e] + b1[e]) @ w2[e] + b2[e]``:
    weights ``w1`` (E, H, F) and ``w2`` (E, F, H) uniform in
    ±``d_model ** -0.5``, biases (E, 1, F) / (E, 1, H) zeros, a bias-free
    ``gate`` Linear(H, E) unless one is given; parameters on ``device``
    (the card unless the caller asks for the CPU) in ``dtype``."""

    def __init__(self, d_model: int, d_hidden: int, n_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 activation: str = "gelu", normalize_topk: bool = True,
                 gate: Optional[nn.Module] = None,
                 dispatch: str = "capacity", ep_axis: str = "ep", *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if dispatch not in ("capacity", "ragged"):
            raise ValueError("dispatch must be 'capacity' or 'ragged'")
        dev = resolve_device(device)
        self.ep_axis = ep_axis
        self.d_model, self.d_hidden = d_model, d_hidden
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.normalize_topk = normalize_topk
        self.dispatch = dispatch
        self.gate = gate or Linear(d_model, n_experts, bias_attr=False,
                                   device=dev, dtype=dtype,
                                   generator=generator)
        bound = d_model ** -0.5
        self.w1 = _param((n_experts, d_model, d_hidden), dev, dtype,
                         bound=bound, generator=generator)
        self.b1 = _param((n_experts, 1, d_hidden), dev, dtype, fill=0.0)
        self.w2 = _param((n_experts, d_hidden, d_model), dev, dtype,
                         bound=bound, generator=generator)
        self.b2 = _param((n_experts, 1, d_model), dev, dtype, fill=0.0)
        self.aux_loss = None

    def ep_plan(self, mesh, axis: str = None) -> dict:
        raise _not_ported("expert parallelism (MoEMLP.ep_plan, the ragged "
                          "expert-parallel route)")

    def capacity(self, n_tokens: int) -> int:
        return _capacity(self.capacity_factor, n_tokens, self.top_k,
                         self.n_experts)

    def forward(self, x):
        B, S, H = x.shape
        T = B * S
        tokens = x.reshape(T, H)
        probs = F.softmax(self.gate(tokens), axis=-1)
        self.aux_loss = _aux_loss(probs, probs.argmax(-1), self.n_experts)
        if self.dispatch == "ragged":
            gatev, topi = _topk_gates(probs, self.top_k, self.normalize_topk)
            out = _ragged_ffn(self.activation, self.top_k, self.n_experts,
                              tokens, gatev, topi, self.w1, self.b1,
                              self.w2, self.b2)
            return out.reshape(B, S, H)
        C = self.capacity(T)
        buf, slot, keep, gate = _one_shot_dispatch(
            tokens, probs, self.n_experts, self.top_k, C,
            self.normalize_topk)
        # the two products are the JAX layer's einsums (an AMP-listed op);
        # the bias adds promote as jnp does
        act = getattr(F, self.activation)
        ebuf, w1 = amp_cast("einsum", buf.reshape(self.n_experts, C, H),
                            self.w1)
        h = act(torch.bmm(ebuf, w1) + self.b1)
        h, w2 = amp_cast("einsum", h, self.w2)
        y = torch.bmm(h, w2) + self.b2                             # (E,C,H)
        out = _one_shot_combine(y.reshape(self.n_experts * C, H), slot,
                                keep, gate, self.top_k, T)
        return out.reshape(B, S, H)


class MoELayer(nn.Module):
    """paddle's list-of-experts MoE over the capacity dispatch: expert e
    runs on its (C, H) slab of the buffer."""

    def __init__(self, d_model: int, experts: List[nn.Module],
                 gate: Optional[nn.Module] = None, top_k: int = 2,
                 capacity_factor: float = 1.25, group=None,
                 recompute_interval: int = 0, normalize_topk: bool = False,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if group is not None:
            raise _not_ported("MoELayer(group=) (an expert-parallel group)")
        self.d_model = d_model
        self.experts = LayerList(experts)
        self.n_experts = len(experts)
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.normalize_topk = normalize_topk
        self.gate = gate or Linear(d_model, self.n_experts, bias_attr=False,
                                   device=device, dtype=dtype,
                                   generator=generator)
        self.aux_loss = None

    def forward(self, x):
        B, S, H = x.shape
        T = B * S
        tokens = x.reshape(T, H)
        probs = F.softmax(self.gate(tokens), axis=-1)
        self.aux_loss = _aux_loss(probs, probs.argmax(-1), self.n_experts)
        C = _capacity(self.capacity_factor, T, self.top_k, self.n_experts)
        buf, slot, keep, gate = _one_shot_dispatch(
            tokens, probs, self.n_experts, self.top_k, C,
            self.normalize_topk)
        ebuf = buf.reshape(self.n_experts, C, H)
        y = torch.stack([self.experts[e](ebuf[e])
                         for e in range(self.n_experts)])
        out = _one_shot_combine(y.reshape(self.n_experts * C, -1), slot,
                                keep, gate, self.top_k, T)
        return out.reshape(B, S, out.shape[-1])
