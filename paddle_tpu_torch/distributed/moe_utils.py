"""The expert-parallel token exchange of ``paddle_tpu/distributed/
moe_utils.py`` (``global_scatter`` / ``global_gather``, the capacity
``dispatch_tokens`` / ``combine_tokens`` over an ep mesh). It waits for
meshes (ROADMAP.md section 1, item 13): each function raises. One-device
MoE is ``incubate.nn.MoEMLP`` / ``MoELayer``."""

from __future__ import annotations

__all__ = ["global_scatter", "global_gather", "dispatch_tokens",
           "combine_tokens"]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md section "
        f"1, item 13)")


def global_scatter(x, local_count, global_count, group=None):
    raise _not_ported("distributed.moe_utils.global_scatter")


def global_gather(x, local_count, global_count, group=None):
    raise _not_ported("distributed.moe_utils.global_gather")


def dispatch_tokens(tokens, expert_ids, n_experts: int, capacity: int):
    raise _not_ported("distributed.moe_utils.dispatch_tokens")


def combine_tokens(expert_out, combine_index, valid_mask):
    raise _not_ported("distributed.moe_utils.combine_tokens")
