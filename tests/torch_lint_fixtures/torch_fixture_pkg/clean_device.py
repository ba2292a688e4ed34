"""The clean control: device programs the rule must never flag — one
wait per call after the loop, scalar options coerced, a host wait before
the loop, and a loop over host values."""

import torch


def _steps(hi) -> int:
    return int(hi.max()).bit_length() + 1


def clean_root(x, hi, *, iters: int, scale: float = 1.0):
    acc = torch.zeros_like(x)
    n = int(iters)
    for _ in range(_steps(hi)):
        acc = acc + x * float(scale)
    for k in [1, 2, 3][:n]:
        acc = acc * k
    return acc


def one_sync_per_call(x, steps: int):
    out = x
    for _ in range(steps):
        out = torch.where(out > 0, out - 1, out)
    return out.cpu().numpy(), out.tolist()
