"""Supervised thread targets: no worker dies silently.

``kccap-lint``'s ``hygiene-thread-death`` rule flags any
``threading.Thread`` target whose body can raise outside a
``try``/``except`` — a daemon worker killed by an unexpected exception
looks exactly like a quiet one, and every invariant it maintained
(heartbeats, queue drains, accept loops) stops holding with no signal.
:func:`supervised` is the standard fix: it wraps the target so an
escaping exception is counted, printed with its traceback to stderr,
and optionally handed to an ``on_death`` hook, instead of vanishing
into ``threading.excepthook``.

The worker's *expected* errors stay where they are (each loop's narrow
``except OSError`` etc. is the real protocol); supervision only
backstops the unexpected — the bug class that turns a race detector's
"no events from thread X" into a false all-clear.
"""

from __future__ import annotations

import sys
import threading
import traceback

__all__ = ["supervised", "death_count", "last_death"]

_lock = threading.Lock()
_deaths: list[tuple[str, str]] = []  # (thread name, "Type: msg")


def _record_death(name: str, exc: BaseException) -> None:
    desc = f"{type(exc).__name__}: {exc}"
    with _lock:
        _deaths.append((name, desc))
    print(
        f"kccap: supervised thread {name!r} died: {desc}",
        file=sys.stderr,
    )
    traceback.print_exc(file=sys.stderr)
    try:
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
            REGISTRY,
            enabled,
        )

        if enabled():
            REGISTRY.counter(
                "kccap_thread_deaths_total",
                "Supervised worker threads killed by an unexpected "
                "exception, by thread name.",
                ("thread",),
            ).labels(thread=name).inc()
    except Exception:  # noqa: BLE001 - accounting must not re-raise
        pass


def supervised(target, *, name: str, on_death=None):
    """Wrap ``target`` so an escaping exception is loud, not silent.

    Returns a callable with the same signature; pass it as a
    ``threading.Thread`` target (positional ``args`` ride through).
    ``on_death(exc)`` runs after recording — the place to restore an
    invariant the dead worker owned (itself guarded: a raising hook is
    swallowed, the death is already on record).
    """

    def _supervised_runner(*args, **kwargs):
        try:
            target(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - the whole point
            _record_death(name, e)
            if on_death is not None:
                try:
                    on_death(e)
                except Exception:  # noqa: BLE001 - hook must not mask
                    pass

    _supervised_runner.__name__ = f"supervised[{name}]"
    return _supervised_runner


def death_count() -> int:
    """Supervised-thread deaths recorded so far in this process."""
    with _lock:
        return len(_deaths)


def last_death() -> tuple[str, str] | None:
    """The most recent ``(thread name, error)`` pair, or ``None``."""
    with _lock:
        return _deaths[-1] if _deaths else None
