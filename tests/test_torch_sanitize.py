"""kccap-torch-sanitize: the port's runtime lockset race detector,
lock-order prover, and seeded schedule fuzzer.

Three proof obligations, mirroring the static analyzer's test story:

* **sensitivity + precision** — a planted unguarded write and a
  planted A→B/B→A inversion are detected at exact field/lock
  granularity; a clean control class yields nothing.
* **determinism** — the same seed twice produces a byte-identical
  finding set (the repro contract: every report prints its seed).
* **zero-cost gate** — with ``KCCAP_SANITIZE`` unset, lock
  construction, attribute access, and the switch interval are
  *identical objects* to the uninstrumented ones, and ``install``
  refuses to arm.

Plus the tier-1 gate itself: the 16-thread package-wide hammer over
all the port's instrumented threaded classes, ≥ 3 seeds, must report
zero unsuppressed races and zero lock-order cycles — and the static and
dynamic provers must agree on the instrumented surface (cross-checked
both directions).  The schedule PRNG takes the JAX sanitizer's
decisions for the same seed, so a seed replays the same perturbation in
both packages.
"""

import os
import sys
import threading

import pytest

from kubernetesclustercapacity_tpu.analysis import sanitize as j_sanitize
from kubernetesclustercapacity_tpu_torch.analysis import hammer, sanitize
from kubernetesclustercapacity_tpu_torch.analysis.engine import (
    Baseline,
    Project,
)
from kubernetesclustercapacity_tpu_torch.analysis.rules_locks import lock_model

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_PKG = os.path.join(_REPO, "kubernetesclustercapacity_tpu_torch")
_BASELINE = os.path.join(_REPO, "LINT_BASELINE_TORCH.json")


@pytest.fixture(autouse=True)
def _port_sanitizer_isolation():
    """The port's instrumentation never outlives a test (the shared
    conftest restores the switch interval and the JAX sanitizer)."""
    yield
    sanitize.uninstall()


# -- planted fixtures -------------------------------------------------------
# Detection must not depend on lucky timing: the drivers below
# serialize the conflicting accesses with joins, so the lockset
# machinery (not the scheduler) decides the verdict.


class PlantedRace:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counter = 0

    def locked_incr(self) -> None:
        with self._lock:
            self._counter += 1

    def unlocked_incr(self) -> None:
        self._counter += 1


class PlantedInversion:
    def __init__(self) -> None:
        self._lock_a = threading.Lock()
        self._lock_b = threading.Lock()

    def ab(self) -> None:
        with self._lock_a:
            with self._lock_b:
                pass

    def ba(self) -> None:
        with self._lock_b:
            with self._lock_a:
                pass


class CleanControl:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def incr(self) -> None:
        with self._lock:
            self._n += 1

    def value(self) -> int:
        with self._lock:
            return self._n


class SuppressedRace:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._errors = 0

    def incr(self) -> None:
        with self._lock:
            self._errors += 1

    def display(self) -> int:
        return self._errors  # kccap: lint-ok[lock-discipline] fixture: deliberate racy display read


_FIXTURE_CLASSES = (
    (PlantedRace, ("_counter",), "PlantedRace"),
    (PlantedInversion, (), "PlantedInversion"),
    (CleanControl, ("_n",), "CleanControl"),
    (SuppressedRace, ("_errors",), "SuppressedRace"),
)


def _one(target) -> None:
    t = threading.Thread(target=target)
    t.start()
    t.join()


def _plant(seed: int):
    """Install, run the serialized planted schedule, return findings
    (repo-relative) and stats; always uninstalls."""
    sanitize.install(seed=seed, classes=_FIXTURE_CLASSES)
    try:
        race = PlantedRace()
        inv = PlantedInversion()
        clean = CleanControl()
        sup = SuppressedRace()
        _one(race.locked_incr)
        _one(race.unlocked_incr)
        _one(inv.ab)
        _one(inv.ba)
        for _ in range(3):
            _one(clean.incr)
        assert clean.value() == 3
        _one(sup.incr)
        _one(sup.display)
        found = sanitize.findings(repo_root=_REPO)
        st = sanitize.stats()
        return found, st
    finally:
        sanitize.uninstall()


@pytest.fixture()
def armed(monkeypatch):
    monkeypatch.setenv(sanitize.ENV_SWITCH, "1")
    yield
    sanitize.uninstall()  # idempotent backstop


# -- sensitivity + precision ------------------------------------------------


def test_planted_race_detected_at_field_and_lock_granularity(armed):
    found, _ = _plant(seed=11)
    races = [f for f in found if f.rule == sanitize.RACE_RULE]
    # Raw detector yield: the planted race plus the (deliberate,
    # inline-suppressed) display read — partition() filters the latter.
    assert sorted(f.symbol for f in races) == [
        "PlantedRace._counter",
        "SuppressedRace._errors",
    ]
    [f] = [f for f in races if f.symbol == "PlantedRace._counter"]
    # Exact granularity: the field, the lock it is elsewhere guarded
    # by, both threads' sites, and the seed for replay.
    assert "PlantedRace._lock" in f.message
    assert "no locks held" in f.message
    assert "[seed 11]" in f.message
    assert f.path == "tests/test_torch_sanitize.py"
    assert f.line > 0


def test_planted_inversion_detected_both_orders(armed):
    found, _ = _plant(seed=11)
    cycles = [f for f in found if f.rule == sanitize.ORDER_RULE]
    assert {f.symbol for f in cycles} == {
        "PlantedInversion._lock_a->PlantedInversion._lock_b",
        "PlantedInversion._lock_b->PlantedInversion._lock_a",
    }
    for f in cycles:
        assert "opposing order" in f.message
        assert "[seed 11]" in f.message


def test_clean_control_produces_zero_findings(armed):
    found, _ = _plant(seed=11)
    assert not any("CleanControl" in f.symbol for f in found)


def test_same_seed_twice_is_byte_identical(armed):
    first, _ = _plant(seed=5)
    second, _ = _plant(seed=5)
    assert [f.render() + "|" + f.message for f in first] == [
        f.render() + "|" + f.message for f in second
    ]
    assert first  # non-vacuous: the planted findings are present


def test_suppression_flows_through_the_lint_workflow(armed):
    """A site marked ``lint-ok[lock-discipline]`` admits the dynamic
    race too (two provers, one invariant) — and the baseline workflow
    applies to what remains."""
    found, _ = _plant(seed=11)
    part = sanitize.partition(found, Baseline(), _REPO)
    sup = [f for f in part.suppressed if f.rule == sanitize.RACE_RULE]
    assert [f.symbol for f in sup] == ["SuppressedRace._errors"]
    assert not any(
        f.symbol == "SuppressedRace._errors" for f in part.findings
    )
    # Baseline identity: accept everything live, rerun partitions clean.
    bl = Baseline.from_findings(part.findings)
    repart = sanitize.partition(found, bl, _REPO)
    assert repart.clean
    assert len(repart.baselined) == len(part.findings)


def test_schedule_prng_is_counter_based():
    a = sanitize.SchedulePRNG(seed=3)
    b = sanitize.SchedulePRNG(seed=3)
    c = sanitize.SchedulePRNG(seed=4)
    seq_a = [a.at(i) for i in range(64)]
    # Out-of-order queries see the same values: decision i is a pure
    # function of (seed, i), not of call order.
    seq_b = [b.at(i) for i in reversed(range(64))]
    assert seq_a == list(reversed(seq_b))
    assert seq_a != [c.at(i) for i in range(64)]


@pytest.mark.parametrize("seed", range(4))
def test_schedule_prng_takes_the_jax_decisions(seed):
    """Seeds 0-3 over 10,000 draws: the port's PRNG is the JAX
    sanitizer's, so a replayed seed perturbs both packages alike."""
    mine = sanitize.SchedulePRNG(seed)
    ref = j_sanitize.SchedulePRNG(seed)
    assert [mine.at(i) for i in range(10_000)] == [
        ref.at(i) for i in range(10_000)
    ]
    fz, jfz = sanitize._ScheduleFuzzer(seed), j_sanitize._ScheduleFuzzer(seed)
    assert fz.SWITCH_CHOICES == jfz.SWITCH_CHOICES


# -- the zero-instrumentation gate ------------------------------------------


def test_gate_closed_install_refuses(monkeypatch):
    monkeypatch.delenv(sanitize.ENV_SWITCH, raising=False)
    with pytest.raises(RuntimeError, match="env-gated"):
        sanitize.install(seed=0)


def test_gate_closed_zero_instrumentation(monkeypatch):
    """Identity pins: with the gate closed, nothing is wrapped —
    lock construction, attribute access and the switch interval are
    the stock objects, not equivalents."""
    monkeypatch.delenv(sanitize.ENV_SWITCH, raising=False)
    import _thread

    assert threading.Lock is _thread.allocate_lock
    assert threading.RLock.__module__ == "threading"
    assert threading.Condition.__module__ == "threading"
    for cls, _fields, _label in hammer.instrument_targets(_PKG):
        assert "__getattribute__" not in vars(cls), cls
        assert "__setattr__" not in vars(cls), cls
    assert sys.getswitchinterval() == pytest.approx(0.005)


def test_uninstall_restores_identities(armed):
    import _thread

    before_get = {
        cls: cls.__getattribute__
        for cls, _f, _l in hammer.instrument_targets(_PKG)
    }
    sanitize.install(
        seed=0, classes=hammer.instrument_targets(_PKG)
    )
    assert threading.Lock is not _thread.allocate_lock
    sanitize.uninstall()
    assert threading.Lock is _thread.allocate_lock
    for cls, fn in before_get.items():
        assert cls.__getattribute__ is fn, cls
        assert "__getattribute__" not in vars(cls), cls
    assert sys.getswitchinterval() == pytest.approx(0.005)
    # Idempotent: a second uninstall is a no-op.
    sanitize.uninstall()


def test_wrapped_locks_outlive_uninstall(armed):
    """A lock created during the window keeps working after uninstall
    (it delegates to a real primitive; its sanitizer is inert)."""
    sanitize.install(seed=0)
    lock = threading.Lock()
    cond = threading.Condition()
    sanitize.uninstall()
    with lock:
        pass
    with cond:
        cond.notify_all()


# -- static <-> dynamic cross-check and the tier-1 hammer gate --------------


def test_hammered_set_matches_static_inference():
    """Both directions, direction one: every hammered class is inferred
    threaded by the static model, and its monitored fields ARE the
    static guarded set (the sanitizer consumes the model, so this pins
    the wiring, not a coincidence)."""
    model = lock_model(Project(_PKG))
    by_name = {}
    for m in model.values():
        by_name.setdefault(m.name, m)
    targets = {
        label: fields for _cls, fields, label in hammer.instrument_targets(_PKG)
    }
    assert set(targets) == {name for _m, name in hammer.HAMMERED_CLASSES}
    for _module, name in hammer.HAMMERED_CLASSES:
        assert name in by_name, f"{name} not statically inferred threaded"
        assert targets[name] == tuple(sorted(by_name[name].guarded))


def test_package_hammer_is_clean_across_seeds(monkeypatch):
    """THE tier-1 gate: 16 threads, fuzzed schedules, 3 seeds, all
    instrumented classes — zero unsuppressed races, zero lock-order
    cycles.  Any hit prints field/lock granularity plus its seed, so
    the failure IS the repro recipe."""
    monkeypatch.setenv(sanitize.ENV_SWITCH, "1")
    baseline = Baseline.load(_BASELINE)
    observed: dict[str, set] = {}
    for seed in range(3):
        found, st = hammer.run(
            seed=seed, threads=16, iters=30, package_dir=_PKG
        )
        part = sanitize.partition(found, baseline, _REPO)
        assert part.clean, (
            f"sanitizer found unsuppressed concurrency bugs under seed "
            f"{seed}:\n" + "\n".join(f.render() for f in part.findings)
        )
        assert st["threads_seen"] >= 16
        assert st["schedule_decisions"] > 0
        for label, fields in st["observed_fields"].items():
            observed.setdefault(label, set()).update(fields)
    # Direction two of the cross-check: what the detector OBSERVED is
    # within the static guarded set, and the hammer exercised at least
    # one guarded field of every class that has any (a gate that never
    # watches a field certifies nothing).
    model = lock_model(Project(_PKG))
    guarded_by_name = {}
    for m in model.values():
        guarded_by_name.setdefault(m.name, set()).update(m.guarded)
    for label, fields in observed.items():
        assert fields <= guarded_by_name[label], label
    for _module, name in hammer.HAMMERED_CLASSES:
        if guarded_by_name.get(name):
            assert observed.get(name), (
                f"hammer never touched a guarded field of {name}"
            )


def test_hammer_pins_the_two_repaired_classes(monkeypatch):
    """The concurrent-reconcile driver watches ``DeviceLedger._suspects``
    (read and replaced in one locked block since the repair), and the
    cache drivers watch ``DeviceCache._entries`` through
    ``_per_locked`` — both observed, both race-free."""
    monkeypatch.setenv(sanitize.ENV_SWITCH, "1")
    found, st = hammer.run(seed=1, threads=8, iters=12, package_dir=_PKG)
    assert not [f for f in found if f.symbol in (
        "DeviceLedger._suspects", "DeviceCache._entries")]
    assert "_suspects" in st["observed_fields"]["DeviceLedger"]
    assert "_entries" in st["observed_fields"]["DeviceCache"]
    assert "_suspects" in st["observed_locked_writes"]["DeviceLedger"]


def test_hammered_classes_name_the_jax_hammers():
    from kubernetesclustercapacity_tpu.analysis import hammer as j_hammer

    assert len(hammer.HAMMERED_CLASSES) == 15
    assert [
        (m.replace("kubernetesclustercapacity_tpu_torch",
                   "kubernetesclustercapacity_tpu"), c)
        for m, c in hammer.HAMMERED_CLASSES
    ] == list(j_hammer.HAMMERED_CLASSES)


def test_sanitize_cli_smoke(monkeypatch, capsys):
    from kubernetesclustercapacity_tpu_torch.analysis import sanitize_cli

    monkeypatch.setenv(sanitize.ENV_SWITCH, "1")
    rc = sanitize_cli.run(
        [_PKG, "--seed", "0", "--threads", "4", "--iters", "5"]
    )
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "seeds=[0]" in out

    rc = sanitize_cli.run([_PKG, "--static-only"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "static 0 finding(s)" in out
