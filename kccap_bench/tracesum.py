"""A ``torch.profiler`` chrome trace reduced to what the benchmark reads.

Device activity is every event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; the seconds in which one ran are the union of their
intervals.  The longest idle gaps between them are named by the host
event (an operator, a runtime call) that covers most of the gap.
Imports the standard library only.
"""

from __future__ import annotations

import json

__all__ = ["reduce", "union_s"]

_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_HOST = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
TOP = 10
NAME_CHARS = 160  # a kernel's full C++ name runs to a thousand characters


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def union_s(intervals) -> float:
    """Seconds covered by ``(start_us, end_us)`` intervals."""
    return sum(b - a for a, b in _merged(intervals)) / 1e6


def reduce(path: str, window_s: float) -> dict:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, kernels, host = [], [], []
    by_name: dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat", "")
        if cat in _DEVICE:
            device.append((a, b))
            if cat == "kernel":
                kernels.append((a, b))
            name = e.get("name", "?")[:NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        elif cat in _HOST:
            host.append((a, b, e.get("name", "?")[:NAME_CHARS]))
    busy = _merged(device)
    gaps = sorted(((busy[k + 1][0] - busy[k][1], busy[k][1], busy[k + 1][0])
                   for k in range(len(busy) - 1)), reverse=True)[:TOP]
    named = []
    for length, a, b in gaps:
        best, best_cover = "host, no event recorded", 0.0
        for ha, hb, name in host:
            cover = min(b, hb) - max(a, ha)
            if cover > best_cover:
                best, best_cover = name, cover
        named.append([best, length / 1e6])
    return {
        "window_s": window_s,
        "busy_s": union_s(device),
        "kernel_s": union_s(kernels),
        "device_events": len(device),
        "device_ops": sorted(([k, v] for k, v in by_name.items()),
                             key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": named,
    }
