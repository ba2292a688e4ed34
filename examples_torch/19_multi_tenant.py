"""First-class multi-tenancy: one server, three tenants, one hot.

Walks the whole tenancy story in-process:

1. parse a tenant map — `acme` (per-tenant token, 2 rps cap), `beta`
   (weight 2), and the implicit `default` everyone else gets;
2. serve with per-tenant quotas armed (`AdmissionController(tenants=)`
   + `CapacityServer(tenants=)`) — a deficit-round-robin fair queue
   replaces the global FIFO;
3. drive `acme` past its rps cap and catch the typed, AUTHORITATIVE
   `TenantQuotaError` (wire code `tenant_quota` — multi-endpoint
   clients must NOT fail over: every replica enforces the same map);
4. show attribution riding the observability plane: the flight
   recorder's `dump` grows a per-tenant filter, `info(tenancy=True)`
   renders quotas and live admission state — and the per-tenant token
   NEVER appears in any of it;
5. show an old tenantless client still working as `"default"`.

PyTorch port: the server sweeps on ``device`` (the card by
default); the tenant map, the fair queue and the quota buckets are host
code.

Run:  python examples_torch/19_multi_tenant.py [--device cpu]
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

from kubernetesclustercapacity_tpu_torch.resilience import TenantQuotaError  # noqa: E402
from kubernetesclustercapacity_tpu_torch.service import (  # noqa: E402
    CapacityClient,
    CapacityServer,
)
from kubernetesclustercapacity_tpu_torch.service.plane import (  # noqa: E402
    AdmissionController,
)
from kubernetesclustercapacity_tpu_torch.service.tenancy import (  # noqa: E402
    parse_tenants,
)
from kubernetesclustercapacity_tpu_torch.snapshot import (  # noqa: E402
    synthetic_snapshot,
)


def main(device: str = "cuda") -> None:
    tmap = parse_tenants(
        {
            "tenants": [
                # rps cap 2/s with burst 2: the third back-to-back
                # call in this script reliably overruns it.
                {"name": "acme", "token": "acme-secret", "rps": 2.0,
                 "burst": 2.0, "weight": 1.0},
                {"name": "beta", "weight": 2.0},
            ]
        }
    )
    print(f"tenant map: {', '.join(tmap.names)} "
          f"(+ the implicit 'default')")

    srv = CapacityServer(
        synthetic_snapshot(64, seed=7),
        port=0,
        batch_window_ms=0.0,
        tenants=tmap,
        admission=AdmissionController(max_concurrent=4, tenants=tmap),
        device=device,
    )
    srv.start()
    try:
        # --- the hot tenant: authenticated + attributed by its token,
        # shed by ITS OWN bucket once the burst is gone. ---
        sheds = 0
        with CapacityClient(*srv.address, tenant_token="acme-secret") as c:
            for _ in range(4):
                try:
                    c.sweep(random={"n": 2, "seed": 1})
                except TenantQuotaError as e:
                    sheds += 1
                    last = e
        assert sheds > 0, "the 2 rps / burst-2 cap never tripped"
        print(f"acme overage shed {sheds}x with the typed quota error:")
        print(f"  {type(last).__name__} (wire code {last.wire_code!r}): "
              f"{last}")

        # --- beta (a bare label: quota attribution without secrets)
        # and an old tenantless client, side by side. ---
        with CapacityClient(*srv.address, tenant="beta") as c:
            c.sweep(random={"n": 2, "seed": 2})
        with CapacityClient(*srv.address) as c:  # pre-tenancy client
            c.sweep(random={"n": 2, "seed": 3})

            # --- per-tenant observability, bounded and secret-free. ---
            acme_only = c.dump(tenant="acme")["records"]
            info = c.info(tenancy=True)
        print(f"dump(tenant='acme'): {len(acme_only)} record(s), "
              f"tenants seen: "
              f"{sorted({r['tenant'] for r in acme_only})}")
        ten = info["tenancy"]
        print("info(tenancy=True):")
        for spec in ten["tenants"]["tenants"]:
            print(f"  {spec['name']}: rps={spec['rps']:g} "
                  f"weight={spec['weight']:g}")
        shed_by_reason = ten["admission"]["shed"]
        print(f"  admission shed: {shed_by_reason}")
        assert shed_by_reason.get("tenant_quota", 0) == sheds
        # The per-tenant secret never rides the wire back out.
        assert "acme-secret" not in json.dumps(info)
        assert "acme-secret" not in json.dumps(acme_only)
        print("secrets: per-tenant token absent from info, dump, and "
              "every digest")
    finally:
        srv.shutdown()
    print("done: quotas enforced per tenant, old clients untouched")


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
