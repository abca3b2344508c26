"""Runtime support of the port (result carriers)."""
