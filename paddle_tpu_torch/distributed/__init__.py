"""Distributed support of the port: checkpoints in the JAX package's
distributed format and the storage of tensors in them and in serving
payloads (``checkpoint``), and the control plane's RPC (``rpc``)
and heartbeat membership (``elastic``) over the port's TCPStore."""
