"""The dynamic sanitizer: plant a race and an inversion, watch both
get caught — then prove the gate costs nothing when closed.

Walks the whole `kccap-torch-sanitize` loop in-process, with the
PyTorch port's sanitizer:

1. arm the `KCCAP_SANITIZE` gate and `install()` with a seed;
2. drive a class with an unguarded write and a class acquiring two
   locks in both orders (serialized — the LOCKSET machinery, not the
   scheduler, produces the verdict);
3. read the findings (field/lock granularity, both sites, the seed to
   replay) and the run stats;
4. uninstall and pin that `threading.Lock` is the stock factory again.

Run: ``python examples_torch/18_sanitize.py``
"""

import os
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))  # noqa: E402 - run-by-path support


class LeakyCounter:
    """The planted race: `flush` writes the guarded field lock-free."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._count = 0

    def incr(self) -> None:
        with self._lock:
            self._count += 1

    def flush(self) -> None:
        self._count = 0  # unguarded write — the bug


class TwoLocks:
    """The planted inversion: both orders of the same lock pair."""

    def __init__(self) -> None:
        self._lock_front = threading.Lock()
        self._lock_back = threading.Lock()

    def front_then_back(self) -> None:
        with self._lock_front:
            with self._lock_back:
                pass

    def back_then_front(self) -> None:
        with self._lock_back:
            with self._lock_front:
                pass


def _run(fn) -> None:
    t = threading.Thread(target=fn)
    t.start()
    t.join()


def main() -> None:
    from kubernetesclustercapacity_tpu_torch.analysis import sanitize

    gate = os.environ.get(sanitize.ENV_SWITCH)
    os.environ[sanitize.ENV_SWITCH] = "1"
    try:
        _demo(sanitize)
    finally:
        # Close the gate again: the process goes on uninstrumented.
        if gate is None:
            os.environ.pop(sanitize.ENV_SWITCH, None)
        else:
            os.environ[sanitize.ENV_SWITCH] = gate


def _demo(sanitize) -> None:

    seed = 2026
    sanitize.install(
        seed=seed,
        classes=[
            (LeakyCounter, ("_count",), "LeakyCounter"),
            (TwoLocks, (), "TwoLocks"),
        ],
    )
    try:
        counter = LeakyCounter()
        locks = TwoLocks()
        _run(counter.incr)  # T2: guarded write
        _run(counter.flush)  # T3: unguarded write -> lockset empties
        _run(locks.front_then_back)
        _run(locks.back_then_front)
        found = sanitize.findings(repo_root=os.getcwd())
        stats = sanitize.stats()
    finally:
        sanitize.uninstall()

    races = [f for f in found if f.rule == sanitize.RACE_RULE]
    cycles = [f for f in found if f.rule == sanitize.ORDER_RULE]
    print(f"seed {seed}: {len(races)} race(s), "
          f"{len(cycles)} lock-order inversion edge(s)")
    for f in found:
        print(" ", f.render())
    assert [f.symbol for f in races] == ["LeakyCounter._count"]
    assert {f.symbol for f in cycles} == {
        "TwoLocks._lock_front->TwoLocks._lock_back",
        "TwoLocks._lock_back->TwoLocks._lock_front",
    }
    assert f"[seed {seed}]" in races[0].message  # the repro handle
    print(
        f"stats: {stats['lock_events']} lock events, "
        f"{stats['field_events']} field events, "
        f"{stats['schedule_decisions']} schedule decisions"
    )

    # The gate restores to zero instrumentation.
    import _thread

    assert threading.Lock is _thread.allocate_lock
    assert "__getattribute__" not in vars(LeakyCounter)
    print("uninstalled: threading.Lock and attribute access are stock again")


if __name__ == "__main__":
    main()
