"""AMP debugging tools: not ported yet.

The JAX package's ``amp/debugging.py`` checks numerics and collects
operator statistics by hooking its op registry (``ops.registry.apply_op``)
and the ``check_nan_inf`` flag of its Tensor surface; the port has
neither yet (ROADMAP.md section 1, item 14.1). Each name raises a typed
refusal that names the item."""

from __future__ import annotations

__all__ = ["enable_operator_stats_collection", "check_numerics",
           "TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "collect_operator_stats"]


def _refuse(name: str):
    def refused(*args, **kwargs):
        raise NotImplementedError(
            f"amp.debugging.{name} is not ported to paddle_tpu_torch yet "
            f"(ROADMAP.md section 1, item 14.1: it hooks the op registry "
            f"of the paddle Tensor surface)")
    refused.__name__ = name
    return refused


check_numerics = _refuse("check_numerics")
TensorCheckerConfig = _refuse("TensorCheckerConfig")
enable_tensor_checker = _refuse("enable_tensor_checker")
disable_tensor_checker = _refuse("disable_tensor_checker")
collect_operator_stats = _refuse("collect_operator_stats")
enable_operator_stats_collection = _refuse(
    "enable_operator_stats_collection")
