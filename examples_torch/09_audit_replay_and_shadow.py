"""Audit log, deterministic replay, and shadow-oracle verification.

The north star demands bit-exact replica counts vs. the reference —
but a test-time proof says nothing about the server you are running
NOW, with its device cache, shape buckets and micro-batcher between
the wire and the kernel.  This example walks the whole audited
lifecycle:

1. a server records every generation (invertible diffs + checkpoints,
   digest-chained) and every answering request (full args + result
   digest) into an append-only audit log;
2. a ``ShadowSampler`` re-checks every sweep against the pure-Python
   oracle off the request path (production posture: a small
   ``-shadow-sample-rate`` fraction);
3. the log reloads in a *fresh* reader — the crash-recovery path — and
   a ``Replayer`` reconstructs each generation and re-answers each
   recorded request bit-for-bit, the programmatic form of
   ``kccap-torch -replay DIR`` (and ``-replay-ref SEGMENT:OFFSET``, the ref
   every flight-recorder ``dump`` record now carries).

PyTorch port: the audited server answers on ``device`` (the card
by default): a sweep the eligibility proofs admit runs kernel B1
(``csrc/sweep_fit.cu``, its plain PyTorch version with ``--device
cpu``), the others and the explain the exact int64 program.  The
``Replayer`` re-answers every recorded request on the same device.  The
shadow sampler's oracle and the log are host code.  The audit refs'
byte offsets differ from the JAX package's by the length of the kernel
label recorded before them.

Run:  python examples_torch/09_audit_replay_and_shadow.py [--device cpu]
"""

import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support

import numpy as np

from kubernetesclustercapacity_tpu_torch.audit import (
    AuditLog,
    AuditReader,
    Replayer,
    ShadowSampler,
)
from kubernetesclustercapacity_tpu_torch.report import replay_table_report
from kubernetesclustercapacity_tpu_torch.service import CapacityClient, CapacityServer
from kubernetesclustercapacity_tpu_torch.snapshot import synthetic_snapshot


def main(device: str = "cuda") -> None:
    audit_dir = tempfile.mkdtemp(prefix="kccap-audit-")
    audit = AuditLog(audit_dir, checkpoint_every=4)
    # Production would use -shadow-sample-rate 0.01; rate 1.0 here so
    # the example's handful of sweeps are all checked.
    shadow = ShadowSampler(1.0, audit_log=audit)
    base = synthetic_snapshot(16, seed=7)
    server = CapacityServer(
        base, port=0, audit_log=audit, shadow=shadow, device=device
    )
    server.start()
    try:
        with CapacityClient(*server.address) as client:
            # Answering requests — each lands in the audit log with its
            # full args and a canonical result digest.
            client.sweep(random={"n": 8, "seed": 3})
            client.explain(cpuRequests="500m", memRequests="1gb")

            # Churn: two more generations, recorded as invertible diffs
            # against the checkpointed baseline.
            shrunk = dataclasses.replace(
                base,
                alloc_cpu_milli=(
                    np.asarray(base.alloc_cpu_milli) // 2
                ).astype(np.int64),
            )
            server.replace_snapshot(shrunk)
            client.sweep(
                cpu_request_milli=[250, 500],
                mem_request_bytes=[10**9, 2 * 10**9],
                replicas=[5, 5],
            )

            # Every flight-recorder record now points back into the
            # audit log: dump → audit_ref → kccap-torch -replay, one paste.
            dump = client.dump(op="sweep", limit=1)
            ref = dump["records"][-1]["audit_ref"]
            print(f"last sweep's audit ref: {ref}")

        assert shadow.drain(30.0), "shadow queue did not drain"
        st = shadow.stats()
        print(
            f"shadow oracle: checked={st['checked']} "
            f"divergences={st['divergences']} "
            f"alert={st['alert']['state']}"
        )
        assert st["divergences"] == 0, "live kernels diverged from oracle!"
    finally:
        server.shutdown()
        shadow.close()
        audit.close()

    # --- offline: reload the log fresh (the incident-review posture)
    # and replay everything.  Every generation reconstructs from the
    # nearest checkpoint and must hash to its recorded digest; every
    # request must re-answer to its recorded result digest.
    reader = AuditReader.load(audit_dir)
    with Replayer(reader, device=device) as replayer:
        one = replayer.replay_record(reader.record_at(ref))
        print(f"replay of {ref}: {one['status']}")
        result = replayer.replay_all()
    print()
    print(replay_table_report(result))
    assert result["clean"], "replay mismatched the recorded history"


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
