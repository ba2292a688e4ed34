"""How far the obvious PyTorch calls would move the seeded draws.

Run from the repository root, on the CPU, with both packages importable::

    JAX_PLATFORMS=cpu python tools/sampler_drift.py [--seeds 16]

For ``--seeds`` keys (seed k, stream 1) and 65,536 draws each, it compares
with the JAX package's ``jax.random`` draws:

* ``z``: ``sqrt(2)·torch.special.erfinv(u)`` on the port's own uniforms
  against ``jax.random.normal`` (f64 values that differ, and the largest
  difference);
* the int64 samples of a normal (mean 500, std 200) and a lognormal
  (mean 4 GiB, sigma 1) distribution drawn five ways: the port's sampler;
  the port's with ``torch.log1p`` in place of XLA's ``log1p``; with
  ``torch.exp`` in place of XLA's ``exp``; with plain multiply-adds in
  place of the fused ones; and with ``torch.special.erfinv`` and
  ``torch.exp`` throughout.

It prints one JSON object: the draw count and, per variant, how many int64
samples differ from JAX's.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

import kubernetesclustercapacity_tpu.stochastic as js
import jax
from kubernetesclustercapacity_tpu_torch.stochastic import distributions as td

N = 1 << 16
CPU = torch.device("cpu")
DISTS = {
    "normal": {"mean": 500.0, "std": 200.0},
    "lognormal": {"mean": float(4 << 30), "sigma": 1.0},
}


def _naive(kind: str, kw: dict, key) -> np.ndarray:
    lo = math.nextafter(-1.0, 0.0)
    u = torch.clamp(td._uniform01(key, N, CPU) * 2.0 + lo, min=lo)
    z = math.sqrt(2) * torch.special.erfinv(u)
    if kind == "normal":
        v = kw["mean"] + kw["std"] * z
    else:
        v = torch.exp(math.log(kw["mean"]) + kw["sigma"] * z)
    return torch.clamp(torch.round(v), 1.0, float(1 << 62)).to(
        torch.int64).numpy()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=16)
    args = p.parse_args()

    variants = {
        "port": {},
        "torch.log1p": {"_log1p": torch.log1p},
        "torch.exp": {"_exp": torch.exp},
        "unfused multiply-add": {"_fma": lambda a, b, c: a * b + c},
    }
    moved = {k: {v: 0 for v in [*variants, "torch erfinv and exp"]}
             for k in DISTS}
    z_differ, z_max = 0, 0.0
    for seed in range(args.seeds):
        key = td.sample_key(seed, 1)
        jkey = js.sample_key(seed, 1)
        lo = math.nextafter(-1.0, 0.0)
        u = torch.clamp(td._uniform01(key, N, CPU) * 2.0 + lo, min=lo)
        z_torch = (math.sqrt(2) * torch.special.erfinv(u)).numpy()
        z_jax = np.asarray(jax.random.normal(jkey, (N,), dtype=np.float64))
        z_differ += int((z_torch != z_jax).sum())
        z_max = max(z_max, float(np.abs(z_torch - z_jax).max()))
        for kind, kw in DISTS.items():
            want = js.sample_usage(js.UsageDistribution(kind=kind, **kw), N,
                                   jkey)
            dist = td.UsageDistribution(kind=kind, **kw)
            for name, patch in variants.items():
                saved = {f: getattr(td, f) for f in patch}
                for f, fn in patch.items():
                    setattr(td, f, fn)
                try:
                    got = td.sample_usage(dist, N, key, device="cpu")
                finally:
                    for f, fn in saved.items():
                        setattr(td, f, fn)
                moved[kind][name] += int((got != want).sum())
            moved[kind]["torch erfinv and exp"] += int(
                (_naive(kind, kw, key) != want).sum())
    print(json.dumps({
        "draws": args.seeds * N,
        "z_differ": z_differ,
        "z_max_abs_diff": z_max,
        "int64_samples_moved": moved,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
