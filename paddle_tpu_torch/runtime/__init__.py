"""Runtime support of the port: typed failures, write-fault injection and
result carriers."""
