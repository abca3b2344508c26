"""Mesh contracts of decode and serving.

Counterpart of ``paddle_tpu/inference/sharding.py``. The port serves on
one device: meshes come with ROADMAP.md queue 1, item [13]. Until then the
module holds the typed error that snapshot/restore and row migration
raise when a payload recorded a mesh this engine does not serve.
"""

from __future__ import annotations

__all__ = ["MeshMismatchError"]


class MeshMismatchError(ValueError):
    """A mesh/sharding contract violation: a snapshot or migration payload
    recorded for one mesh loaded under another, or an engine mesh that
    contradicts its backend's."""
