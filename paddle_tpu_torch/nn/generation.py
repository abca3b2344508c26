"""No-cache decoding and the train/eval mode snapshot.

Counterpart of ``paddle_tpu/nn/generation.py`` (``generate_tokens``,
``beam_search``, ``mode_snapshot``, ``mode_restore``) and of the
``gather_tree`` op (``paddle_tpu/ops/schema_defs.py`` ``_gather_tree``).
Both decoders run the model's full forward with no cache at every step,
as the reference does: they work on any causal LM whose ``forward(ids)``
returns (B, S, V) logits (GPT's ``generate``; the Llama has its cached
decoder).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["generate_tokens", "beam_search", "gather_tree",
           "mode_snapshot", "mode_restore"]


def mode_snapshot(model):
    """Per-module (module, training) pairs: restoring them (instead of a
    blanket ``.train()``) keeps submodules the caller froze with
    ``.eval()``."""
    if not isinstance(model, torch.nn.Module):
        return []
    return [(m, m.training) for m in model.modules()]


def mode_restore(snap) -> None:
    for m, was in snap:
        m.training = was


def generate_tokens(model, input_ids, max_new_tokens: int = 32,
                    eos_token_id: Optional[int] = None,
                    do_sample: bool = False, temperature: float = 1.0,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    seed: int = 0) -> np.ndarray:
    """Greedy or sampled decode by re-running the full forward over the
    growing ids for every token, which stops once every row has emitted
    ``eos_token_id`` (a negative id means none); returns (B, S + new) int
    ids. The JAX package compiles a module's decode into one scan over a
    padded (B, S + N) buffer; eager, that buffer would only make every
    forward longer, so every model takes this loop, which gives the same
    tokens. A sampled token is drawn as the JAX function draws it: the
    key of ``seed`` split once a token, a categorical over the whole
    (B, V) filtered logits under the second half."""
    from paddle_tpu_torch import random as rnd
    from paddle_tpu_torch.inference.eos import _normalize_eos
    from paddle_tpu_torch.inference.generate import _sample_batch

    eos = _normalize_eos(eos_token_id)
    ids = np.asarray(input_ids)
    max_pos = getattr(getattr(model, "config", None),
                      "max_position_embeddings", None)
    if max_pos is not None and ids.shape[1] + max_new_tokens > max_pos:
        raise ValueError(
            f"prompt {ids.shape[1]} + {max_new_tokens} new tokens exceeds "
            f"max_position_embeddings {max_pos}")
    if max_new_tokens <= 0:
        return ids
    snap = mode_snapshot(model)
    if hasattr(model, "eval"):
        model.eval()
    try:
        with torch.inference_mode():
            dev = _device_of(model)
            cur = torch.as_tensor(ids, dtype=torch.long, device=dev)
            key = rnd.PRNGKey(seed, device=dev)
            done = torch.zeros((ids.shape[0],), dtype=torch.bool, device=dev)
            for _ in range(max_new_tokens):
                logits = torch.as_tensor(model(cur))[:, -1].float()
                # a draw under the second half of the key's split, whose
                # first half is the next key; a finished row emits eos
                if do_sample:
                    key, tok = _sample_batch(logits, key, temperature,
                                             top_k, top_p)
                else:
                    tok = torch.argmax(logits, dim=-1)
                if eos is not None:
                    tok = torch.where(done, eos, tok)
                    done = done | (tok == eos)
                cur = torch.cat([cur, tok[:, None]], dim=1)
                if eos is not None and bool(done.all()):
                    break
            return cur.cpu().numpy().astype(ids.dtype)
    finally:
        mode_restore(snap)


def _device_of(model) -> torch.device:
    if isinstance(model, torch.nn.Module):
        return next(model.parameters()).device
    return torch.device(getattr(model, "device", "cpu"))


def gather_tree(ids: torch.Tensor, parents: torch.Tensor) -> torch.Tensor:
    """Beam-search backtrace: (T, B, beam) step tokens and parent beam
    indices -> the full sequence ending in each final beam, (T, B, beam)."""
    T, B, K = ids.shape
    beam = torch.arange(K, device=ids.device).expand(B, K)
    out = torch.empty_like(ids)
    for t in range(T - 1, -1, -1):
        out[t] = ids[t].gather(1, beam)
        beam = parents[t].gather(1, beam)
    return out


def _top_k_lower_index(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values, ties
    broken by the lower index (a stable descending sort; ``torch.topk``
    promises no order among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search(model, input_ids, beam_size: int = 4,
                max_new_tokens: int = 32,
                eos_token_id: Optional[int] = None,
                length_penalty: float = 1.0) -> np.ndarray:
    """Beam-search decode: keeps (B, beam) running hypotheses scored by
    summed log-probabilities; a beam that emitted ``eos_token_id`` is
    frozen with its score (its only continuation is eos); the backtrace
    runs through ``gather_tree``; the best beam by length-penalized score
    is returned, (B, S + new) int ids."""
    ids = np.asarray(input_ids)
    B, S = ids.shape
    K = int(beam_size)
    if max_new_tokens <= 0:
        return ids
    max_pos = getattr(getattr(model, "config", None),
                      "max_position_embeddings", None)
    if max_pos is not None and S + max_new_tokens > max_pos:
        raise ValueError(
            f"prompt {S} + {max_new_tokens} new tokens exceeds "
            f"max_position_embeddings {max_pos}")

    snap = mode_snapshot(model)
    model.eval()
    try:
        with torch.inference_mode():
            dev = next(model.parameters()).device
            # prompts repeated to (B*K, S); beam 0 starts live, the others
            # at -inf, so the first step seeds K distinct continuations
            flat = torch.as_tensor(np.repeat(ids, K, axis=0),
                                   dtype=torch.long, device=dev)
            scores = torch.full((B, K), float("-inf"), device=dev)
            scores[:, 0] = 0.0
            done = torch.zeros((B, K), dtype=torch.bool, device=dev)
            step_tokens, step_parents = [], []
            for _ in range(max_new_tokens):
                logits = model(flat)[:, -1].float()
                V = logits.shape[-1]
                logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
                if eos_token_id is not None:
                    frozen = torch.full((V,), float("-inf"), device=dev)
                    frozen[eos_token_id] = 0.0
                    logp = torch.where(done[..., None], frozen, logp)
                cand = (scores[..., None] + logp).reshape(B, K * V)
                scores, top = _top_k_lower_index(cand, K)
                parent, token = top // V, top % V
                step_tokens.append(token)
                step_parents.append(parent)
                done = done.gather(1, parent)
                if eos_token_id is not None:
                    done = done | (token == eos_token_id)
                seqs = flat.reshape(B, K, -1).gather(
                    1, parent[..., None].expand(-1, -1, flat.shape[1]))
                flat = torch.cat([seqs, token[..., None]],
                                 dim=-1).reshape(B * K, -1)
                if eos_token_id is not None and bool(done.all()):
                    break
            full = gather_tree(torch.stack(step_tokens),
                               torch.stack(step_parents))      # (T, B, K)
            T = full.shape[0]
            lengths = torch.full((B, K), float(T), device=dev)
            if eos_token_id is not None:
                is_eos = full == eos_token_id
                first_eos = is_eos.to(torch.int32).argmax(0)
                lengths = torch.where(is_eos.any(0), first_eos + 1.0,
                                      lengths)
            best = torch.argmax(scores / lengths ** length_penalty, dim=1)
            chosen = full.permute(1, 2, 0)[torch.arange(B, device=dev),
                                            best]               # (B, T)
            return np.concatenate(
                [ids, chosen.cpu().numpy().astype(ids.dtype)], axis=1)
    finally:
        mode_restore(snap)
