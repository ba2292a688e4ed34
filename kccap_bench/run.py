"""Runs one cell of the benchmark once and prints its result line.

    python3 -m kccap_bench.run --workload W --seed N --seconds S --trace 0|1

from the root of a checkout.  The run starts the server process
(``child.py``), builds the traffic from the seed meanwhile, warms every
shape the traffic uses, then drives the load open-loop for ``S``
seconds.  With ``--trace 1`` the last stretch of the window (4 s at
most, half of it at least) runs under ``torch.profiler``.  Once the
window has closed and every reply is in (or given up ``GRACE_S`` later),
the server process records its readings and stops, and the plain
reference checks the kept replies.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard
error).  The run exits non-zero, and prints no result, where it finds no
CUDA device or finds JAX or the JAX package loaded.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

from kccap_bench import checks, spec  # noqa: E402
from kccap_bench.child import forbidden_modules  # noqa: E402
from kccap_bench.gcwatch import GcWatch  # noqa: E402
from kccap_bench.load import drive, send_all  # noqa: E402

GRACE_S = 60.0
READY_TIMEOUT_S = 1100.0
TRACE_MAX_S = 4.0
CLIENT_TIMEOUT_S = 300.0


class Child:
    """The server process and its command pipe."""

    def __init__(self, root: str, args: list[str]) -> None:
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kccap_bench.child", *args], cwd=root,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1)
        self._lines: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.startswith("KCCAP_BENCH "):
                self._lines.put(line[len("KCCAP_BENCH "):].strip())
            else:  # the program's own output: keep stdout for the result
                sys.stderr.write(line)
        self._lines.put(None)

    def expect(self, word: str, timeout: float) -> str | None:
        end = time.perf_counter() + timeout
        while True:
            try:
                line = self._lines.get(
                    timeout=max(end - time.perf_counter(), 0.001))
            except queue.Empty:
                return None
            if line is None:
                return None
            if line.startswith(word):
                return line[len(word):].strip()

    def command(self, cmd: str, timeout: float = 120.0) -> bool:
        with self._lock:
            try:
                self.proc.stdin.write(cmd + "\n")
                self.proc.stdin.flush()
            except (BrokenPipeError, OSError):
                return False
            return self.expect(f"OK {cmd.split()[0]}", timeout) is not None

    def stop(self) -> int:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            return self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()


def fail(msg: str) -> int:
    print(f"kccap_bench: {msg}", file=sys.stderr)
    return 1


def _latencies(records, seconds: float):
    """Client-side readings: query latencies from when each was due, the
    update-to-answer latencies, per-op send-to-reply sums, counts of the
    attempted and the failed, and how late the generator ran."""
    limit = seconds + GRACE_S
    answer, update_to_answer, wire = [], [], {}
    attempted = failed = 0
    released_late, sent_late = [], []

    def ok_of(rec, prefix):
        done = getattr(rec, prefix + "done")
        return getattr(rec, prefix + "ok") & (done <= limit)

    def add_wire(op, rec, prefix, ok):
        sent = getattr(rec, prefix + "sent")[ok]
        done = getattr(rec, prefix + "done")[ok]
        w = wire.setdefault(op, {"sum": 0.0, "count": 0})
        w["sum"] += float(np.sum(done - sent))
        w["count"] += int(ok.sum())

    for rec in records:
        s = rec.stream
        ok = ok_of(rec, "")
        op = s.requests[0][0]
        attempted += len(rec.due)
        failed += int((~ok).sum())
        add_wire(op, rec, "", ok)
        released_late.extend((rec.released - rec.due).tolist())
        sent_late.extend((rec.sent - rec.due).tolist())
        if s.then is None:
            lat = np.where(ok, rec.done - rec.due, limit - rec.due)
            answer.extend((lat * 1e3).tolist())
            continue
        sent = ~np.isnan(rec.then_sent)
        then_ok = ok_of(rec, "then_") & sent
        attempted += int(sent.sum())
        failed += int((sent & ~then_ok).sum())
        add_wire(s.then[0][0], rec, "then_", then_ok)
        lat = np.where(then_ok, rec.then_done - rec.done, limit - rec.done)
        answer.extend((lat[sent] * 1e3).tolist())
        both = ok & then_ok
        u2a = np.where(both, rec.then_done - rec.due, limit - rec.due)
        update_to_answer.extend((u2a * 1e3).tolist())

    def spread(x):
        x = np.asarray(x)
        x = x[~np.isnan(x)] * 1e3
        if not len(x):
            return {}
        return {"p50": float(np.percentile(x, 50)),
                "p99": float(np.percentile(x, 99)), "max": float(x.max())}

    return {"answer_ms": answer, "update_to_answer_ms": update_to_answer,
            "wire": wire, "attempted": attempted, "failed": failed,
            "released_late_ms": spread(released_late),
            "sent_late_ms": spread(sent_late)}


def _cpu_stat():
    """The machine's ``(steal, total)`` CPU time so far, in ticks of
    ``/proc/stat``, or None where there is no such file."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None
    return (ticks[7] if len(ticks) > 7 else 0), sum(ticks)


def _host(before: dict, after: dict) -> dict:
    """The host over the window: the share of the machine's CPU time
    stolen by its hypervisor, and this process's CPU seconds (its work
    is the same in every run, so they follow the speed of the cores)."""
    out = {"load_cpu_s": after["cpu_s"] - before["cpu_s"]}
    if before["stat"] and after["stat"]:
        steal = after["stat"][0] - before["stat"][0]
        total = after["stat"][1] - before["stat"][1]
        out["steal_pct"] = 100.0 * steal / total if total else 0.0
    return out


def _host_now() -> dict:
    return {"cpu_s": time.process_time(), "stat": _cpu_stat()}


def _gc_between(a: dict, b: dict, long: list) -> dict:
    """The collector between two :meth:`GcWatch.mark` readings: counts
    by generation, milliseconds in all, and the long pauses (ms)."""
    return {"count": [y - x for x, y in zip(a["count"], b["count"])],
            "total_ms": 1e3 * (sum(b["total_s"]) - sum(a["total_s"])),
            "long_ms": [[g, round(s * 1e3, 3)] for g, s in long]}


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", inject: str | None = None,
             out=None) -> int:
    """One run of ``workload`` from the checkout at ``root``.  ``device``
    ``"cpu"`` and ``inject`` (a Python file the server process runs
    before serving) are for the benchmark's own tests."""
    out = sys.stdout if out is None else out
    seed = int(seed) % 2**63
    cell = spec.load_cell(root, workload)
    config, traffic, entry = cell["config"], cell["traffic"], cell["workload"]
    kind = spec.load_module(root, "gen", traffic["kind"])
    cluster = spec.load_module(root, "clusters", config["cluster"]["kind"])
    tmp = tempfile.mkdtemp(prefix="kccap_bench_")
    child_args = ["--workload", workload, "--seed", str(seed), "--tmp", tmp,
                  "--device", device, "--chips", str(entry["chips"]),
                  "--trace", str(int(trace))]
    if inject:
        child_args += ["--inject", inject]
    child = Child(root, child_args)
    clients = []
    try:
        from kubernetesclustercapacity_tpu_torch.service import (
            CapacityClient,
        )

        fixture = cluster.build(config["cluster"], seed)
        plan = kind.plan(traffic, config, seed, seconds, fixture)
        # The cluster and the plan live to the end of the run; keep the
        # collector's full passes off them, or each pass stalls the load
        # generator for a tenth of a second.
        gc.collect()
        gc.freeze()
        gcw = GcWatch()
        ready = child.expect("READY", READY_TIMEOUT_S)
        if ready is None:
            return fail(f"the server process ended before it served "
                        f"(exit code {child.stop()})")
        port, child_setup = ready.split(" ", 1)

        def connect():
            c = CapacityClient("127.0.0.1", int(port), connect_timeout_s=60,
                               timeout_s=CLIENT_TIMEOUT_S, retry=None)
            clients.append(c)
            return c

        pool = [connect() for _ in range(int(traffic["connections"]))]
        writer = connect() if any(s.lane == "writer"
                                  for s in plan.streams) else None
        for group in plan.warm:
            send_all(pool, group)
        setup_s = time.perf_counter() - _T_START

        host0 = _host_now()
        child.command("mark start")
        t0 = time.perf_counter()
        own_gc = gcw.mark()
        timer = None
        if trace:
            span = min(TRACE_MAX_S, seconds / 2)

            def traced():
                time.sleep(max(t0 + seconds - span - time.perf_counter(), 0))
                child.command("trace_start")
                time.sleep(max(t0 + seconds - time.perf_counter(), 0))
                child.command("trace_stop", timeout=600)

            timer = threading.Thread(target=traced, daemon=True)
            timer.start()
        records = drive(plan, pool, writer, t0, t0 + seconds + GRACE_S)
        if timer is not None:
            timer.join()
        load = _latencies(records, seconds)
        load["host"] = _host(host0, _host_now())
        own_gc = _gc_between(own_gc, gcw.mark(),
                             gcw.long_between(t0, time.perf_counter()))
        gcw.stop()
        for c in clients:
            c.close()
        path = os.path.join(tmp, "artifacts.json")
        if not child.command(f"dump {path}", timeout=600):
            return fail(f"the server process did not record its readings "
                        f"(exit code {child.stop()})")
        code = child.stop()
        with open(path) as f:
            artifacts = json.load(f)
        if code != 0 or artifacts["forbidden"]:
            return fail(f"the server process exited {code}; modules it "
                        f"should not load: {artifacts['forbidden']}")

        # The reference, after the window and with the server gone.
        import torch

        from kccap_bench.reference import pack

        cols = (pack.pack_reference(fixture)
                if config["semantics"] == "reference" else
                pack.pack_strict(fixture,
                                 tuple(config.get("extended_resources", ()))))
        keys = checks.kept_keys(records)
        expected = kind.reference_answers(plan, traffic, config, fixture,
                                          cols, keys, torch.int64, device)
        numbers = checks.compare(records, keys, expected)
        if hasattr(kind, "update_numbers"):
            numbers.update(kind.update_numbers(plan, records, config,
                                               fixture))

        load["setup_s"] = setup_s
        artifacts["load"] = load
        artifacts["cell"] = {
            "query_op": plan.query_op,
            "semantics": config["semantics"],
            "n_nodes": cols.n_nodes,
            "live_nodes": cols.live_nodes(),
            "specs_per_request": int(traffic["specs_per_request"]),
        }
        if hasattr(kind, "cell_ops_per_request"):
            artifacts["cell"]["resources"] = len(traffic["resources"])
            artifacts["cell"]["cell_ops_per_request"] = \
                kind.cell_ops_per_request(plan, config["semantics"])
        metrics = {}
        for m in spec.cell_metrics(cell["bench"], workload, trace):
            value = spec.load_module(root, "metrics", m["name"]).read(
                artifacts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result = {
            "correct": all(v <= checks.LIMITS[k] for k, v in numbers.items()),
            "attempted": load["attempted"],
            "failed": load["failed"],
            "metrics": metrics,
            "device": dict(artifacts["device"]),
        }
        if trace:
            tr = artifacts["trace"]
            result["device"]["busy_s"] = tr.get("busy_s", 0.0)
            result["device"]["window_s"] = tr.get("window_s", 0.0)
            result["breakdown"] = {"device_ops": tr.get("device_ops", []),
                                   "idle_gaps": tr.get("idle_gaps", [])}
        result["checks"] = {k: {"value": v, "limit": checks.LIMITS[k]}
                            for k, v in numbers.items()}

        found = forbidden_modules()
        if found:
            return fail(f"this process loaded {found}")
        print(f"set-up: {setup_s:.3f} s in all; the server process's "
              f"{child_setup}", file=out)
        print(f"load: {load['attempted']} requests, {load['failed']} "
              f"failed; generator late (ms) {load['released_late_ms']}; "
              f"sent late (ms) {load['sent_late_ms']}; "
              f"{len(load['answer_ms'])} answers", file=out)
        marks = artifacts["marks"]
        server_gc = _gc_between(marks["start"]["gc"], marks["end"]["gc"],
                                artifacts["gc_long"])
        answers = np.asarray(load["answer_ms"])
        print(f"answers (ms): p50 {np.percentile(answers, 50)}, p95 "
              f"{np.percentile(answers, 95)}, p99 "
              f"{np.percentile(answers, 99)}", file=out)
        print(f"collector, server process: {server_gc}", file=out)
        print(f"collector, load process: {own_gc}", file=out)
        answered = load["attempted"] - load["failed"]
        server_cpu = marks["end"]["cpu_s"] - marks["start"]["cpu_s"]
        print(f"host: {load['host']}; server process CPU {server_cpu} s, "
              f"{server_cpu / max(answered, 1) * 1e3} ms a request "
              f"answered; server peak RSS "
              f"{artifacts['maxrss_kib'] / 1024} MiB", file=out)
        for k, v in numbers.items():
            print(f"check {k}: {v} (limit {checks.LIMITS[k]})",
                  file=sys.stderr)
        print(json.dumps(result), file=out)
        out.flush()
        return 0
    finally:
        for c in clients:
            c.close()
        if child.proc.poll() is None:
            child.proc.kill()
            child.proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    return run_cell(os.getcwd(), args.workload, args.seed, args.seconds,
                    bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
