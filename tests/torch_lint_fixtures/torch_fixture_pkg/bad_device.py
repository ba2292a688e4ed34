"""Every device-purity category, one per marked line.

The ``# expect:`` markers are parsed by ``tests/test_torch_lint_rules.py``:
each names the rule that must fire AT THAT LINE.  This module is
analyzed, never imported.
"""

import os
import random
import threading
import time

import torch

from torch_fixture_pkg.telemetry.metrics import count

_lock = threading.Lock()


def subsystem_root(x):
    count()  # expect: device-purity
    return x + 1


def lock_root(x):
    with _lock:  # expect: device-purity
        y = x * 2
    inner = threading.Lock()  # expect: device-purity
    del inner
    return y


def io_root(x):
    print("staging", x.shape)  # expect: device-purity
    flag = os.environ.get("FIXTURE_SWITCH", "0")  # expect: device-purity
    return x if flag else -x


def clock_root(x):
    return x * time.perf_counter()  # expect: device-purity


def random_root(x):
    return x * random.random()  # expect: device-purity


def sync_root(x, steps: int):
    total = torch.zeros_like(x)
    for _ in range(steps):
        total = total + x
        if total.max().item() > 100:  # expect: device-purity
            break
    return total


def coercion_root(x: torch.Tensor, limit, steps: int):
    out = x
    for _ in range(steps):
        out = out * 2
        if float(limit) < 0:  # expect: device-purity
            out = -out
    return out


def while_root(x):
    while x.sum().cpu() > 0:  # expect: device-purity
        x = x - 1
    return x


def _peek(t):
    return t.tolist()


def _twice(t):
    return _peek(t) + _peek(t)


def detour_root(x, steps: int):
    seen = []
    for _ in range(steps):
        seen.append(_twice(x))  # expect: device-purity
    return seen


def _cached_build():
    with open("kernel.so", "rb") as fh:
        return fh.read()


def boundary_root(x):
    # kccap: lint-ok[device-purity] fixture: a declared boundary is reported and admitted here
    lib = _cached_build()
    return x, lib
