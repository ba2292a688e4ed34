"""Stand-in registry module: calls into here from a device program must
be flagged as host-subsystem escapes."""


def count() -> None:
    pass
