"""The reference's sample run, offline — where a switching user starts.

The reference CLI answers one question per invocation against a live
cluster (``README.md:38-47`` shows its sample run).  Here the same
question runs against a saved fixture, bit-exact to the Go semantics,
with no cluster and no network.

PyTorch port: the per-node fit runs on ``device`` (the card by default,
``--device cpu`` for the host) as the exact int64 program over the
snapshot's staged columns; the sequential oracle and the transcript are
host code.

Run:  python examples_torch/01_reference_run.py [--device cpu]
"""

import os

import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import kubernetesclustercapacity_tpu_torch as kcc
from kubernetesclustercapacity_tpu_torch.fixtures import load_fixture
from kubernetesclustercapacity_tpu_torch.ops.fit import snapshot_device_arrays
from kubernetesclustercapacity_tpu_torch.oracle import reference_run
from kubernetesclustercapacity_tpu_torch.report import reference_report

FIXTURE = os.path.join(
    os.path.dirname(__file__), "..", "tests", "fixtures", "kind-3node.json"
)


def main(device: str = "cuda") -> None:
    fixture = load_fixture(FIXTURE)
    scenario = kcc.scenario_from_flags(
        cpuRequests="200m", cpuLimits="400m",
        memRequests="250mb", memLimits="500mb", replicas="10",
    )

    # The device path: pack once, stage the columns on ``device``, and
    # evaluate per-node fits with the exact int64 program.
    snap = kcc.snapshot_from_fixture(fixture, semantics="reference")
    cols = snapshot_device_arrays(snap, device)
    dev = cols[0].device
    fits = (
        kcc.fit_per_node(
            *cols,
            torch.tensor(scenario.cpu_request_milli, device=dev),
            torch.tensor(scenario.mem_request_bytes, device=dev),
            mode="reference",
        )
        .cpu()
        .numpy()
    )

    # The sequential oracle (the stand-in for the Go binary) agrees bit
    # for bit — that equality is the framework's core contract.
    oracle = reference_run(fixture, scenario)
    assert fits.tolist() == oracle.fits
    assert int(fits.sum()) == oracle.total_possible_replicas

    # The byte-parity transcript the reference would have printed:
    print(reference_report(snap, fits, scenario))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
