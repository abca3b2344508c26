"""Distributed support of the port: the storage format of checkpoints and
serving payloads (``checkpoint``), and the control plane's RPC (``rpc``)
and heartbeat membership (``elastic``) over the port's TCPStore."""
