"""The programs of a decoder bundle, as modules that ``torch.export`` traces.

Each entry of ``export_decoder_bundle`` (``inference/bundle.py``) is one of
these ``nn.Module``s: it holds the decoder's parameters as buffers (so the
exported program carries them as its weights) and its ``forward`` is one
pure piece of the decoder's work, written with ``inference/generate.py``'s
own functions, so that what the export records is what the in-process
decoder runs:

- ``Prefill``: the prompt forward at cache position 0 (the target's, or a
  speculative draft's over its own parameters and caches);
- ``AdmitPrefill``: the serving engine's admission prefill, a right-padded
  prompt with per-row true lengths and cache offsets;
- ``FusedStep``: one step of the fused decode loop (pick with one batch
  key, eos freeze, forward, advance);
- ``ChunkStep``: one step of the chunked serving loop (pick with each row's
  own key, eos freeze, forward, advance);
- ``SpecRound``: one draft-propose / target-verify / accept round of the
  fused speculative loop, with the loop's first pick folded in.

Loop counts are not part of a program: the predictor runs a step ``steps``
or ``chunk`` times (the entry's metadata) as one counted dispatch. The
caches are inputs that the forward writes in place; ``torch.export``
records those writes as functional updates that its module copies back.
Only the exporting process imports this module.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_tpu_torch.inference.generate import (LlamaDecoder,
                                                 _forward_cached,
                                                 _sample_batch, _sample_rows)

__all__ = ["Prefill", "AdmitPrefill", "FusedStep", "ChunkStep", "SpecRound"]


class _Entry(torch.nn.Module):
    """A program over a decoder's parameters (and a draft's, when it has
    its own), held as buffers ``w<i>`` / ``d<i>`` in name order."""

    def __init__(self, params: dict, cfg, max_len: int,
                 draft_params: Optional[dict] = None, draft_cfg=None):
        super().__init__()
        self.cfg, self.max_len = cfg, int(max_len)
        self._names = sorted(params)
        for i, n in enumerate(self._names):
            self.register_buffer(f"w{i}", params[n])
        self.draft_cfg = draft_cfg
        self._dnames = None
        if draft_params is not None and draft_params is not params:
            self._dnames = sorted(draft_params)
            for i, n in enumerate(self._dnames):
                self.register_buffer(f"d{i}", draft_params[n])

    def params(self) -> dict:
        return {n: getattr(self, f"w{i}") for i, n in enumerate(self._names)}

    def draft_params(self) -> dict:
        if self._dnames is None:      # a "skip:N" draft: the target's own
            return self.params()
        return {n: getattr(self, f"d{i}")
                for i, n in enumerate(self._dnames)}

    def fwd(self, ids, kc, vc, pos, return_all=False):
        return _forward_cached(self.params(), self.cfg, ids, kc, vc, pos,
                               self.max_len, return_all)


class Prefill(_Entry):
    """``(ids (B, S), kc, vc) -> logits (B, V)``: the prompt at position 0
    into the caches; with ``draft=True`` the draft's forward."""

    def __init__(self, *a, draft: bool = False, **k):
        super().__init__(*a, **k)
        self.draft = draft

    def forward(self, ids, kc, vc):
        if self.draft:
            return _forward_cached(self.draft_params(), self.draft_cfg, ids,
                                   kc, vc, 0, self.max_len)
        return self.fwd(ids, kc, vc, 0)


class AdmitPrefill(_Entry):
    """``(ids (N, S), kc, vc, true_len (N,), pos0 (N,)) -> logits (N, V)``
    at each row's position ``true_len - 1``: ``LlamaDecoder``'s admission
    prefill (``pos0 > 0``: the caches hold a cached prefix)."""

    def forward(self, ids, kc, vc, true_len, pos0):
        logits = self.fwd(ids, kc, vc, pos0, return_all=True)
        return logits[torch.arange(ids.shape[0], device=ids.device),
                      true_len - 1]


class FusedStep(_Entry):
    """One step of ``LlamaDecoder``'s fused loop: ``(logits, kc, vc, pos
    (B,), key (2,), done (B,), eos (), temp ()) -> (tok, logits, pos, key,
    done)``. ``sample``: ``(top_k, top_p)`` or None (greedy). eos -1 is
    none: no token equals it. Positions advance clamped to the last cache
    slot."""

    def __init__(self, *a, sample=None, **k):
        super().__init__(*a, **k)
        self.sample = sample

    def forward(self, logits, kc, vc, pos, key, done, eos, temp):
        if self.sample is None:
            tok = torch.argmax(logits, -1)
        else:
            key, tok = _sample_batch(logits, key, temp, *self.sample)
        tok = torch.where(done, eos, tok)
        done = done | (tok == eos)
        logits = self.fwd(tok[:, None], kc, vc, pos)
        return (tok, logits, torch.clamp(pos + 1, max=self.max_len - 1),
                key + 0, done)


class ChunkStep(_Entry):
    """One step of ``LlamaDecoder``'s chunk: ``(logits, kc, vc, pos (B,),
    keys (B, 2), done (B,), eos (B,), temp (B,)) -> (tok, logits, pos,
    keys, done)``; each row draws with its own key, done rows emit their
    eos (0 without one)."""

    def __init__(self, *a, sample=None, **k):
        super().__init__(*a, **k)
        self.sample = sample

    def forward(self, logits, kc, vc, pos, keys, done, eos, temp):
        if self.sample is None:
            tok = torch.argmax(logits, -1)
        else:
            keys, tok = _sample_rows(logits, keys, temp, *self.sample)
        tok = torch.where(done, torch.where(eos >= 0, eos, 0), tok)
        done = done | (tok == eos)
        logits = self.fwd(tok[:, None], kc, vc, pos)
        return (tok, logits, torch.clamp(pos + 1, max=self.max_len - 1),
                keys + 0, done)


class SpecRound(_Entry):
    """One round of ``LlamaDecoder``'s fused speculative loop:
    ``(logits, kc, vc, dkc, dvc, tok (B,), pos (B,), key (2,), done (B,),
    eos (), temp ()) -> (tok0, done0, emit (B, K + 1), a, tok_next, key,
    done)``, the round of ``LlamaDecoder._spec_round`` itself. A row whose
    pending ``tok`` is -1 (the first round) picks it from ``logits``
    first, with the loop's first key split; ``tok0`` / ``done0`` are the
    pending token and done mask the round ran from. ``pos`` is each row's
    next cache slot, clamped here so that a round fits the cache."""

    def __init__(self, *a, K: int, sample=None, **k):
        super().__init__(*a, **k)
        self.K, self.sample = int(K), sample

    def _fwd(self, ids, kc, vc, pos, return_all=False, aidx=None):
        return self.fwd(ids, kc, vc, pos, return_all)

    def forward(self, logits, kc, vc, dkc, dvc, tok, pos, key, done, eos,
                temp):
        need = tok < 0
        if self.sample is None:
            cand = torch.argmax(logits, -1)
            key = None
        else:
            key2, cand = _sample_batch(logits, key, temp, *self.sample)
            key = torch.where(need.any(), key2, key)
        tok = torch.where(need, cand, tok)
        eos = eos.expand(logits.shape[0])
        done = torch.where(need, cand == eos, done)
        eng = {"cfg": self.draft_cfg, "params": self.draft_params()}
        # the decoder's own round, with this entry in the decoder's place
        # (the round reads only ``_fwd`` and ``max_len`` of it)
        emit, a, tok2, _, key, done2 = LlamaDecoder._spec_round(
            self, eng, tok, torch.clamp(pos, max=self.max_len - self.K - 1),
            key, done, kc, vc, dkc, dvc, eos, temp, self.K, self.sample)
        return (tok, done, emit, a, tok2,
                torch.zeros(2, dtype=torch.int32, device=tok.device)
                if key is None else key, done2)
