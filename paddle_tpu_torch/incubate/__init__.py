"""Fused-op surface of the port (``incubate.nn.functional``)."""
