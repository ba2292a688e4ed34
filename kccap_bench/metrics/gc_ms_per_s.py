"""Server process runtime (the Python collector): milliseconds a second
of the window that collections held the server process's GIL, which
stalls every handler thread and the dispatch."""


def read(artifacts):
    a, b = artifacts["marks"]["start"], artifacts["marks"]["end"]
    if "gc" not in a or b["t"] <= a["t"]:
        return None
    took = sum(b["gc"]["total_s"]) - sum(a["gc"]["total_s"])
    return took / (b["t"] - a["t"]) * 1e3
