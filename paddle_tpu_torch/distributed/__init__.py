"""Distributed support of the port: the storage format of checkpoints and
serving payloads (``checkpoint``)."""
