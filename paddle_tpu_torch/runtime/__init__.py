"""Runtime support of the port: typed failures and events, the retry
loop, fault injection and result carriers."""
