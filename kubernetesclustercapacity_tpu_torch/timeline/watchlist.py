"""Watchlists: the named scenarios a timeline re-evaluates every generation.

A watchlist file (``kccap-server -watch FILE``, YAML or JSON — YAML is a
superset, so one loader serves both) names the what-if specs an operator
actually cares about, in the reference CLI's own flag grammar::

    watches:
      - name: web-tier
        pod:
          cpuRequests: 500m
          memRequests: 1gb
          replicas: "40"
        min_replicas: 30        # optional alert threshold
      - name: batch-strict
        pod: {cpuRequests: "2", memRequests: 4gb}
        semantics: strict       # optional kernel-mode override

``pod`` fields parse through :func:`~..scenario.scenario_from_flags` —
the exact reference codecs, so a watch capacity is bit-identical to the
``kccap`` fit of the same flags.  ``semantics`` overrides the evaluation
mode for that watch (default: the served snapshot's own packing mode);
``min_replicas`` arms the ok → breached → recovered alert machine
(absent = the watch is observed but never alerts).

**Capacity-at-risk watches**: a ``quantile`` field turns a watch
stochastic — "alert when P95 capacity < N"::

    watches:
      - name: web-p95
        pod: {cpuRequests: 500m, memRequests: 1gb, replicas: "40"}
        quantile: 0.95          # capacity at 95% confidence
        usage:                  # per-pod usage distributions
          cpu: {dist: normal, mean: 500m, std: 150m}
          # memory defaults to a point at the pod's memRequests
        samples: 128            # optional Monte Carlo draw count
        seed: 7                 # optional; explicit, never wall-clock
        min_replicas: 30

``quantile`` must lie strictly inside ``(0, 1)`` and REQUIRES a
``usage`` block with at least one non-degenerate distribution — a
point-distribution watch has no usage uncertainty, so every quantile
would silently equal the plain fit (rejected with a clear error rather
than reported as a lie).  A resource omitted from ``usage`` defaults
to a point distribution at the pod's own request.

**Gang watches**: a ``gang`` block makes the watch count WHOLE GANGS
of the pod spec instead of independent replicas — "alert when fewer
than 2 rack-co-located 64-rank gangs fit"::

    watches:
      - name: train-64
        pod: {cpuRequests: "4", memRequests: 8gb}
        gang:
          ranks: 64
          count: 2              # gangs requested (schedulability)
          colocate: rack        # optional: host|rack|zone
          max_ranks_per_domain: 8   # optional, with spread_level
          spread_level: host
        min_replicas: 1         # alert threshold, in WHOLE GANGS

The block parses through :func:`~..topology.gang.parse_gang_block`
(same grammar as the ``gang`` service op and ``kccap -gang-spec``);
``gang`` and ``quantile`` are mutually exclusive — a stochastic gang
watch would need a semantics nobody has defined, so it is rejected,
not guessed.

**Forecast (horizon) watches**: a ``horizon`` block turns a
capacity-at-risk watch predictive — "alert when the P95 capacity is
forecast to cross ``min_replicas`` anywhere inside the horizon"::

    watches:
      - name: web-p95-weekly
        pod: {cpuRequests: 500m, memRequests: 1gb, replicas: "40"}
        quantile: 0.95
        usage:
          cpu: {dist: normal, mean: 500m, std: 150m}
        horizon:
          steps: 24             # projection steps (default 16)
          step_s: 3600          # seconds per step (default 3600)
        min_replicas: 30

The timeline fits a Theil–Sen demand trend over its OWN generation
ring (record timestamps, never the wall clock), projects the watch's
usage samples along it, and breaches on the MINIMUM projected quantile
capacity across the horizon — surfacing ``time_to_breach_s`` on the
watch result.  ``horizon`` requires ``quantile`` and is mutually
exclusive with ``gang``; unlike a plain capacity-at-risk watch,
all-point usage IS allowed here (growth scaling makes even a point
vary across the horizon).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from kubernetesclustercapacity_tpu_torch.scenario import (
    Scenario,
    ScenarioError,
    scenario_from_flags,
)
from kubernetesclustercapacity_tpu_torch.stochastic.distributions import (
    DistributionError,
    UsageDistribution,
    parse_distribution,
)

__all__ = ["WatchError", "WatchSpec", "load_watchlist", "parse_watchlist"]

_MAX_WATCH_SAMPLES = 1 << 14

# The reference's five flag spellings, the only keys a pod block accepts —
# an unknown key is a typo'd watch that would silently evaluate defaults.
_POD_KEYS = frozenset(
    {"cpuRequests", "cpuLimits", "memRequests", "memLimits", "replicas"}
)

_MODES = ("reference", "strict")


class WatchError(ValueError):
    """Malformed watchlist file/entry (bad YAML/JSON, bad flags, dupes)."""


@dataclass(frozen=True)
class WatchSpec:
    """One named scenario: what to evaluate, how, and when to alert.

    ``quantile`` (with its ``usage`` distributions) makes the watch a
    capacity-at-risk watch: its evaluated "capacity" is the Monte Carlo
    capacity quantile, and ``min_replicas`` breaches against THAT
    ("alert when P95 capacity < N").
    """

    name: str
    scenario: Scenario
    mode: str | None = None  # None = the served snapshot's semantics
    min_replicas: int | None = None
    quantile: float | None = None
    usage_cpu: UsageDistribution | None = None
    usage_mem: UsageDistribution | None = None
    samples: int = 0  # 0 = the process default (KCCAP_CAR_SAMPLES/64)
    seed: int = 0
    #: Gang watch: capacity counted in whole gangs of the pod spec
    #: (a :class:`~..topology.gang.GangSpec`); ``min_replicas`` then
    #: thresholds GANGS, not pods.
    gang: object | None = None
    #: Forecast watch: project the quantile capacity ``horizon_steps``
    #: steps of ``horizon_step_s`` seconds ahead along the timeline's
    #: fitted demand trend; breach on the horizon MINIMUM.
    horizon_steps: int | None = None
    horizon_step_s: float = 3600.0

    def to_wire(self) -> dict:
        """JSON-able description (rides the ``timeline`` op)."""
        out = {
            "name": self.name,
            "cpu_request_milli": self.scenario.cpu_request_milli,
            "mem_request_bytes": self.scenario.mem_request_bytes,
            "replicas": self.scenario.replicas,
            "mode": self.mode,
            "min_replicas": self.min_replicas,
        }
        if self.gang is not None:
            out["gang"] = self.gang.to_wire()
        if self.quantile is not None:
            out["quantile"] = self.quantile
            out["samples"] = self.samples
            out["seed"] = self.seed
            out["usage"] = {
                "cpu": self.usage_cpu.to_wire(),
                "memory": self.usage_mem.to_wire(),
            }
        if self.horizon_steps is not None:
            out["horizon"] = {
                "steps": self.horizon_steps,
                "step_s": self.horizon_step_s,
            }
        return out


def _parse_entry(i: int, entry) -> WatchSpec:
    if not isinstance(entry, dict):
        raise WatchError(f"watch #{i}: expected a mapping, got {entry!r}")
    name = entry.get("name")
    if not isinstance(name, str) or not name:
        raise WatchError(f"watch #{i}: 'name' must be a non-empty string")
    pod = entry.get("pod") or {}
    if not isinstance(pod, dict):
        raise WatchError(f"watch {name!r}: 'pod' must be a mapping")
    unknown = set(pod) - _POD_KEYS
    if unknown:
        raise WatchError(
            f"watch {name!r}: unknown pod field(s) {sorted(unknown)} "
            f"(want {sorted(_POD_KEYS)})"
        )
    try:
        # YAML scalars may arrive as ints (replicas: 40) — the reference
        # grammar is string flags, so stringify before the codec.
        scenario = scenario_from_flags(
            **{k: str(v) for k, v in pod.items()}
        )
        scenario.validate()
    except ScenarioError as e:
        raise WatchError(f"watch {name!r}: bad pod spec: {e}") from e
    mode = entry.get("semantics")
    if mode is not None and mode not in _MODES:
        raise WatchError(
            f"watch {name!r}: semantics must be one of {_MODES}, got {mode!r}"
        )
    min_replicas = entry.get("min_replicas")
    if min_replicas is not None:
        if not isinstance(min_replicas, int) or isinstance(min_replicas, bool):
            raise WatchError(
                f"watch {name!r}: min_replicas must be an integer"
            )
        if min_replicas < 0:
            raise WatchError(
                f"watch {name!r}: min_replicas must be >= 0"
            )
    extra = set(entry) - {
        "name", "pod", "semantics", "min_replicas",
        "quantile", "usage", "samples", "seed", "gang", "horizon",
    }
    if extra:
        raise WatchError(
            f"watch {name!r}: unknown field(s) {sorted(extra)}"
        )
    gang = None
    if "gang" in entry:
        from kubernetesclustercapacity_tpu_torch.topology.gang import (
            GangSpecError,
            parse_gang_block,
        )

        if "quantile" in entry:
            raise WatchError(
                f"watch {name!r}: 'gang' and 'quantile' are mutually "
                "exclusive (stochastic gang capacity is undefined — "
                "pick one)"
            )
        if "horizon" in entry:
            raise WatchError(
                f"watch {name!r}: 'gang' and 'horizon' are mutually "
                "exclusive (a forecast projects usage quantiles, not "
                "gang packings — pick one)"
            )
        try:
            gang = parse_gang_block(entry["gang"])
        except GangSpecError as e:
            raise WatchError(f"watch {name!r}: {e}") from e
    horizon_steps, horizon_step_s = _parse_horizon_block(name, entry)
    quantile, usage_cpu, usage_mem, samples, seed = _parse_stochastic_fields(
        name, entry, scenario, has_horizon=horizon_steps is not None
    )
    return WatchSpec(
        name=name, scenario=scenario, mode=mode, min_replicas=min_replicas,
        quantile=quantile, usage_cpu=usage_cpu, usage_mem=usage_mem,
        samples=samples, seed=seed, gang=gang,
        horizon_steps=horizon_steps, horizon_step_s=horizon_step_s,
    )


def _parse_horizon_block(name: str, entry: dict) -> tuple[int | None, float]:
    """The forecast grammar of one watch entry: ``horizon`` with
    optional ``steps``/``step_s``.  Requires ``quantile`` (a forecast
    projects a quantile, not a point fit); bounds come from
    :func:`~..forecast.horizon.max_steps` so a watchlist cannot smuggle
    in a sweep the server would refuse as a one-shot op."""
    if "horizon" not in entry:
        return None, 3600.0
    if "quantile" not in entry:
        raise WatchError(
            f"watch {name!r}: 'horizon' requires a 'quantile' — a "
            "forecast projects a capacity quantile over time"
        )
    block = entry["horizon"]
    if block is None:
        block = {}
    if not isinstance(block, dict):
        raise WatchError(
            f"watch {name!r}: 'horizon' must be a mapping, got {block!r}"
        )
    unknown = set(block) - {"steps", "step_s"}
    if unknown:
        raise WatchError(
            f"watch {name!r}: unknown horizon field(s) {sorted(unknown)} "
            "(want steps/step_s)"
        )
    from kubernetesclustercapacity_tpu_torch.forecast.horizon import (
        DEFAULT_STEPS,
        max_steps,
    )

    steps = block.get("steps", DEFAULT_STEPS)
    if isinstance(steps, bool) or not isinstance(steps, int):
        raise WatchError(f"watch {name!r}: horizon.steps must be an integer")
    cap = max_steps()
    if not 1 <= steps <= cap:
        raise WatchError(
            f"watch {name!r}: horizon.steps must be in [1, {cap}], "
            f"got {steps}"
        )
    step_s = block.get("step_s", 3600.0)
    if isinstance(step_s, bool) or not isinstance(step_s, (int, float)):
        raise WatchError(f"watch {name!r}: horizon.step_s must be a number")
    step_s = float(step_s)
    if not step_s > 0.0:
        raise WatchError(
            f"watch {name!r}: horizon.step_s must be > 0, got {step_s:g}"
        )
    return steps, step_s


def _parse_stochastic_fields(
    name: str, entry: dict, scenario: Scenario, *, has_horizon: bool = False
):
    """The capacity-at-risk grammar of one watch entry: ``quantile``
    (strictly inside (0, 1)), ``usage`` distributions (missing
    resources default to a point at the pod's own request), ``samples``
    and ``seed``.  Hard rejections — quantile without usage, usage
    without quantile, out-of-range quantiles, all-point usage — each
    with an error naming the watch, so a typo'd watch never silently
    evaluates as something else.  A ``horizon`` watch relaxes the
    usage requirements: growth scaling makes even a point distribution
    vary across the projection, so all-point (or absent) usage is
    meaningful there."""
    quantile = entry.get("quantile")
    usage = entry.get("usage")
    if quantile is None:
        for field in ("usage", "samples", "seed"):
            if field in entry:
                raise WatchError(
                    f"watch {name!r}: '{field}' requires a 'quantile' "
                    "(only capacity-at-risk watches sample usage)"
                )
        return None, None, None, 0, 0
    if isinstance(quantile, bool) or not isinstance(quantile, (int, float)):
        raise WatchError(
            f"watch {name!r}: quantile must be a number in (0, 1), "
            f"got {quantile!r}"
        )
    quantile = float(quantile)
    if not 0.0 < quantile < 1.0:
        raise WatchError(
            f"watch {name!r}: quantile must be strictly inside (0, 1), "
            f"got {quantile:g}"
        )
    if usage is None and not has_horizon:
        raise WatchError(
            f"watch {name!r}: quantile needs a 'usage' distribution "
            "block — a point-request watch has no usage uncertainty, so "
            "every quantile would equal the plain fit"
        )
    if usage is None:
        usage = {}
    if not isinstance(usage, dict):
        raise WatchError(f"watch {name!r}: 'usage' must be a mapping")
    extra = set(usage) - {"cpu", "memory"}
    if extra:
        raise WatchError(
            f"watch {name!r}: unknown usage resource(s) {sorted(extra)} "
            "(want cpu/memory)"
        )
    from kubernetesclustercapacity_tpu_torch.utils.quantity import int64_bits

    try:
        # Defaults are a point at the pod's own request, on the kernel's
        # int64 carrier (wrapped uint64 cpu requests keep the reference
        # meaning: a huge divisor that fits 0 everywhere).
        usage_cpu = (
            parse_distribution("cpu", usage["cpu"])
            if "cpu" in usage
            else UsageDistribution(
                kind="point", value=int64_bits(scenario.cpu_request_milli)
            )
        )
        usage_mem = (
            parse_distribution("memory", usage["memory"])
            if "memory" in usage
            else UsageDistribution(
                kind="point", value=scenario.mem_request_bytes
            )
        )
    except DistributionError as e:
        raise WatchError(f"watch {name!r}: {e}") from e
    if usage_cpu.degenerate and usage_mem.degenerate and not has_horizon:
        raise WatchError(
            f"watch {name!r}: every usage distribution is a point — the "
            f"P{quantile * 100:g} capacity would always equal the plain "
            "fit; drop 'quantile' or give cpu/memory real spread"
        )
    samples = entry.get("samples", 0)
    if isinstance(samples, bool) or not isinstance(samples, int):
        raise WatchError(f"watch {name!r}: samples must be an integer")
    if samples and not 2 <= samples <= _MAX_WATCH_SAMPLES:
        raise WatchError(
            f"watch {name!r}: samples must be in "
            f"[2, {_MAX_WATCH_SAMPLES}], got {samples}"
        )
    seed = entry.get("seed", 0)
    if isinstance(seed, bool) or not isinstance(seed, int):
        raise WatchError(f"watch {name!r}: seed must be an integer")
    return quantile, usage_cpu, usage_mem, samples, seed


def parse_watchlist(data) -> tuple[WatchSpec, ...]:
    """Parsed document (``{"watches": [...]}`` or a bare list) → specs."""
    if isinstance(data, dict):
        entries = data.get("watches")
        extra = set(data) - {"watches"}
        if extra:
            raise WatchError(f"unknown top-level field(s) {sorted(extra)}")
    else:
        entries = data
    if not isinstance(entries, list) or not entries:
        raise WatchError(
            "watchlist wants a non-empty 'watches' list (or a bare list)"
        )
    specs = tuple(_parse_entry(i, e) for i, e in enumerate(entries))
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise WatchError(f"duplicate watch name(s): {dupes}")
    return specs


def load_watchlist(path: str) -> tuple[WatchSpec, ...]:
    """Load ``path`` (YAML when PyYAML is present, else strict JSON).

    YAML is a superset of JSON, so a ``.json`` watchlist parses either
    way; without PyYAML only JSON files load (gated, not required).
    """
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        import yaml  # type: ignore[import-untyped]

        data = yaml.safe_load(text)
    except ImportError:
        try:
            data = json.loads(text)
        except ValueError as e:
            raise WatchError(
                f"{path}: not valid JSON (and PyYAML is unavailable): {e}"
            ) from e
    except Exception as e:  # yaml.YAMLError — malformed document
        raise WatchError(f"{path}: cannot parse: {e}") from e
    return parse_watchlist(data)
