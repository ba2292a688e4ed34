"""Constraints + placement: WHERE replicas land, not just how many.

The reference schedules anywhere resources allow.  Real scheduling
carries taints/tolerations, selectors, affinity, and spread — and a
capacity answer is more useful with a concrete placement plan.

PyTorch port: every ``CapacityModel`` here runs on ``device`` (the card
by default).  The masked fits and the preemption tables are the exact
int64 program there; a placement whose engine prints as ``scan`` is
the device scan, and the closed-form ``trace`` engine is host numpy.

Run:  python examples_torch/03_constraints_and_placement.py [--device cpu]
"""

import os

import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import kubernetesclustercapacity_tpu_torch as kcc
from kubernetesclustercapacity_tpu_torch.fixtures import load_fixture
from kubernetesclustercapacity_tpu_torch.models import CapacityModel, PodSpec

FIXTURE = os.path.join(
    os.path.dirname(__file__), "..", "tests", "fixtures", "kind-3node.json"
)


def main(device: str = "cuda") -> None:
    fixture = load_fixture(FIXTURE)
    snap = kcc.snapshot_from_fixture(fixture, semantics="strict")
    model = CapacityModel(
        snap, mode="strict", fixture=fixture, device=device
    )

    spec = PodSpec(
        cpu_request_milli=250,
        mem_request_bytes=512 << 20,
        replicas=6,
    )
    result = model.evaluate(spec)
    print(f"fits per node: {result.fits.tolist()}  "
          f"(total {result.total}, schedulable={result.schedulable})")
    # Strict mode auto-applies the control-plane hard taint: untolerating
    # pods never count capacity there.  Tolerate it and capacity grows:
    tolerant = model.evaluate(
        PodSpec(cpu_request_milli=250, mem_request_bytes=512 << 20,
                replicas=6, tolerations=({"operator": "Exists"},))
    )
    print(f"with a tolerate-everything pod: total {tolerant.total}")

    placement = model.place(spec, policy="spread")
    print(f"\nspread placement of {spec.replicas} replicas "
          f"(engine={placement.engine}):")
    for node, count in sorted(placement.by_node().items()):
        print(f"  {node:<24} {count}")
    assert placement.all_placed

    # At scale, "auto" switches to the closed-form trace engine: the
    # scan's exact per-replica order without running R dependent steps.
    big = model.place(
        PodSpec(cpu_request_milli=50, mem_request_bytes=32 << 20,
                replicas=500),
        policy="best-fit",
    )
    print(f"\n500 replicas via engine={big.engine}: "
          f"first five land on {[int(i) for i in big.assignments[:5]]}")

    # Placement understands extended resources too: pack GPU columns and
    # the R-resource engines place only where GPUs exist.
    for i, node in enumerate(fixture["nodes"]):
        node["allocatable"]["nvidia.com/gpu"] = str(i)  # 0, 1, 2 GPUs
    gsnap = kcc.snapshot_from_fixture(
        fixture, semantics="strict",
        extended_resources=("nvidia.com/gpu",),
    )
    gmodel = CapacityModel(
        gsnap, mode="strict", fixture=fixture, device=device
    )
    gplace = gmodel.place(
        PodSpec(cpu_request_milli=100, mem_request_bytes=128 << 20,
                replicas=3, extended_requests={"nvidia.com/gpu": 1},
                tolerations=({"operator": "Exists"},)),
        policy="first-fit",
    )
    print(f"\nGPU placement (1 GPU per replica): {gplace.by_node()}")
    assert gplace.all_placed
    assert gplace.by_node().get(fixture["nodes"][0]["name"], 0) == 0

    # Anti-affinity against EXISTING pods, namespace-scoped like a real
    # PodAffinityTerm: an app=db pod in another namespace does not repel.
    fixture["pods"].append({
        "name": "db-0", "namespace": "prod", "nodeName":
        fixture["nodes"][1]["name"], "phase": "Running",
        "labels": {"app": "db"}, "containers": [],
    })
    asnap = kcc.snapshot_from_fixture(fixture, semantics="strict")
    amodel = CapacityModel(
        asnap, mode="strict", fixture=fixture, device=device
    )
    repelled = amodel.evaluate(PodSpec(
        cpu_request_milli=250, mem_request_bytes=512 << 20,
        anti_affinity_labels={"app": "db"}, namespace="prod",
        tolerations=({"operator": "Exists"},),
    ))
    other_ns = amodel.evaluate(PodSpec(
        cpu_request_milli=250, mem_request_bytes=512 << 20,
        anti_affinity_labels={"app": "db"}, namespace="staging",
        tolerations=({"operator": "Exists"},),
    ))
    print(f"\nanti-affinity vs prod/db: node-1 fits "
          f"{int(repelled.fits[1])}; from another namespace: "
          f"{int(other_ns.fits[1])}")
    assert repelled.fits[1] == 0 and other_ns.fits[1] > 0

    # Preemption-aware capacity: a batch pod at priority -100 is
    # evictable for anything at priority >= its own+1, so a
    # priority-1000 spec sees the headroom it would free (the
    # kube-scheduler preemption upper bound, ops/preemption.py).
    fixture["pods"].append({
        "name": "batch-hog", "namespace": "batch",
        "nodeName": fixture["nodes"][2]["name"], "phase": "Running",
        "priority": -100,
        "containers": [{"resources": {"requests": {
            "cpu": "3", "memory": "4194304Ki"}}}],
    })
    psnap = kcc.snapshot_from_fixture(fixture, semantics="strict")
    pmodel = CapacityModel(
        psnap, mode="strict", fixture=fixture, device=device
    )
    ask = dict(cpu_request_milli=1000, mem_request_bytes=1 << 30,
               tolerations=({"operator": "Exists"},))
    squeezed = pmodel.evaluate(PodSpec(**ask))
    preempting = pmodel.evaluate(PodSpec(**ask, priority=1000))
    print(f"\npreemption: node-2 fits {int(squeezed.fits[2])} around the "
          f"batch hog, {int(preempting.fits[2])} when priority 1000 may "
          f"evict it")
    assert preempting.fits[2] > squeezed.fits[2]

    # Drain simulation (kubectl drain dry-run): every pod on node-2 gets
    # a rehoming target with its OWN requests, or the verdict says the
    # node cannot be emptied.
    plan = pmodel.drain(fixture["nodes"][2]["name"], policy="best-fit")
    print(f"\ndrain {plan.node}: evictable={plan.evictable}")
    for pod, target in plan.by_pod().items():
        print(f"  {pod:<40} -> {target or 'UNPLACEABLE'}")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
