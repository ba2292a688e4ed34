"""Optimization-based packing: certified LP bounds and shadow prices.

The first-fit packer answers "how many fit"; the optimizer answers it
with a *proof* — every solve carries a duality certificate (or says
``uncertified``, never a silently-wrong bound) — and with *prices*:
per-resource dual variables that name the priced-out resource and feed
admission control.

Five stops:

1. offline ``optimize_snapshot`` — the LP over (shape, count) groups,
   solved by the scenario-batched PDHG iteration, with
   the certificate and the closed-form oracle cross-check;
2. the integral chain — rounded packing ≤ certified bound, equal to
   the first-fit walk in strict mode, verified feasible against the
   sequential oracle;
3. shadow prices — "memory is the priced-out resource on X% of
   capacity" and the demand price;
4. the ``optimize`` service op / ``CapacityClient.optimize()`` — the
   same answer over the wire, plus the ``ffd`` baseline backend;
5. shed-by-shadow-price — a certified capacity-bound solve pushes the
   admission controller's price over budget, compute requests shed
   retryable-elsewhere, a demand-bound solve reopens the gate.

PyTorch port: the PDHG iteration (f64, its label ``opt_pdhg``) and the
certificate's fit sweep run on ``device`` (the card by default), and
so do the server's ``optimize`` and sweeps.  The closed-form oracle and
the first-fit walk are host code.  The float artifacts (bound, gap,
prices) may differ from the JAX package's in the last bits, because the
f64 sums over groups run in another order; the integers and the
certificate are equal.

Run:  python examples_torch/17_optimized_packing.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import numpy as np

from kubernetesclustercapacity_tpu_torch.optimize import (
    lp_bound_oracle,
    optimize_snapshot,
)
from kubernetesclustercapacity_tpu_torch.report import optimize_table_report
from kubernetesclustercapacity_tpu_torch.resilience import OverloadedError
from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid
from kubernetesclustercapacity_tpu_torch.service import (
    CapacityClient,
    CapacityServer,
)
from kubernetesclustercapacity_tpu_torch.service.plane import AdmissionController
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot

MIB = 1 << 20
GIB = 1 << 30


def main(device: str = "cuda") -> None:
    # A degenerate fleet (5 machine shapes x 2000 nodes) — the shape
    # the (shape, count) compression turns into ~5 LP variables.
    snap = synthetic_snapshot(2000, seed=5, shapes=5)

    # --- 1. the certified solve: one [S]-scenario batch, one program.
    grid = ScenarioGrid(
        cpu_request_milli=np.array([500, 2000, 100], dtype=np.int64),
        mem_request_bytes=np.array(
            [2 * GIB, 200 * MIB, 4 * GIB], dtype=np.int64
        ),
        replicas=np.array([10**7, 10**7, 50], dtype=np.int64),
    )
    res = optimize_snapshot(snap, grid, mode="strict", device=device)
    assert res.all_certified, "the self-check solve must certify"
    assert (res.duality_gap <= res.tol).all()
    # The structured program has a closed-form optimum; the generic
    # iteration must land on it (the tests pin scipy.linprog too).
    oracle = lp_bound_oracle(snap, grid, mode="strict")
    assert np.allclose(res.lp_bound, oracle, rtol=1e-5)

    # --- 2. the integral chain.
    assert (res.rounded.astype(float) <= res.lp_bound * (1 + res.tol)).all()
    np.testing.assert_array_equal(res.rounded, res.ffd)  # strict mode
    assert res.verified.all()  # fit_arrays_python re-check

    print(optimize_table_report(res.to_wire()))
    print()

    # --- 3. shadow prices name the scarce resource.
    for s, shadow in enumerate(res.shadow):
        priced = shadow["priced_out"]
        top = max(priced, key=priced.get)
        print(
            f"scenario {s}: demand_price={shadow['demand_price']} "
            f"capacity_share={shadow['capacity_share']} "
            f"priced-out leader: {top} ({priced[top] * 100:.0f}%)"
        )
    assert res.shadow[2]["demand_price"] == 1.0  # 50 replicas: demand-bound

    # --- 4/5. the wire surface + shed-by-shadow-price.
    adm = AdmissionController(price_budget=0.8)
    server = CapacityServer(snap, port=0, admission=adm, device=device)
    server.start()
    try:
        with CapacityClient(*server.address) as client:
            wire = client.optimize(
                cpu_request_milli=grid.cpu_request_milli,
                mem_request_bytes=grid.mem_request_bytes,
                replicas=grid.replicas,
            )
            assert wire["certified"]
            assert wire["rounded"] == res.rounded.tolist()
            baseline = client.optimize(
                backend="ffd",
                cpu_request_milli=grid.cpu_request_milli,
                mem_request_bytes=grid.mem_request_bytes,
                replicas=grid.replicas,
            )
            assert baseline["ffd"] == res.ffd.tolist()

            # The capacity-bound scenarios priced 100% of capacity —
            # over the 0.8 budget, so compute requests now shed.
            assert adm.shadow_price() > 0.8
            try:
                client.sweep(
                    cpu_request_milli=[100],
                    mem_request_bytes=[MIB],
                    replicas=[1],
                )
                raise AssertionError("expected the price gate to shed")
            except OverloadedError as e:
                print(f"\nshed by shadow price: {e}")

            # A certified demand-bound solve reopens the gate.
            client.optimize(
                cpuRequests="100m", memRequests="100mb", replicas="1"
            )
            assert adm.shadow_price() == 0.0
            client.sweep(
                cpu_request_milli=[100],
                mem_request_bytes=[MIB],
                replicas=[1],
            )
            print("gate reopened after a demand-bound certified solve")
    finally:
        server.shutdown()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
