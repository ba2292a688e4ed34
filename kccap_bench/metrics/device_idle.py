"""Device: the share of the traced window in which no kernel, copy or
memset ran, in percent."""


def read(artifacts):
    trace = artifacts.get("trace") or {}
    if not trace.get("window_s"):
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0
