"""Scenario types: the what-if pod specs the capacity sweep evaluates.

Counterpart of ``kubernetesclustercapacity_tpu/scenario.py`` (numpy only).
The reference evaluates exactly ONE scenario per process run — the six CLI
flags at ``ClusterCapacity.go:50-62`` parsed at ``:64-83``.  Here a scenario
is a first-class value, and a :class:`ScenarioGrid` batches thousands of them
into dense int64 arrays: the sweep's scenario axis, and a
:class:`MultiResourceGrid` carries R request rows per scenario.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from kubernetesclustercapacity_tpu_torch.utils.quantity import (
    QuantityParseError,
    cpu_parse_error_payload,
    cpu_to_milli_reference,
    go_atoi,
    go_atoi_clamped,
    go_atoi_error,
    int64_bits,
    to_bytes_reference,
)

__all__ = [
    "Scenario",
    "ScenarioGrid",
    "MultiResourceGrid",
    "ScenarioError",
    "scenario_from_flags",
    "random_scenario_grid",
]

# Reference CLI defaults (ClusterCapacity.go:57-61).
DEFAULT_CPU_REQUESTS = "100m"
DEFAULT_CPU_LIMITS = "200m"
DEFAULT_MEM_REQUESTS = "100mb"
DEFAULT_MEM_LIMITS = "200mb"
DEFAULT_REPLICAS = "1"


class ScenarioError(ValueError):
    """Invalid scenario flags — the analog of the reference's ``os.Exit(1)``.

    ``reference_line``, when set, is the BYTE-EXACT fatal line the reference
    would have printed before exiting (``ClusterCapacity.go:69,75,81``); the
    CLI prints it verbatim for error-path transcript parity.
    """

    def __init__(self, msg: str, *, reference_line: str | None = None):
        super().__init__(msg)
        self.reference_line = reference_line


@dataclass(frozen=True)
class Scenario:
    """One what-if pod spec: resource requests/limits + desired replicas.

    Units are millicores and bytes.  Limits are carried for reporting
    parity only — like the reference, they never gate capacity
    (``ClusterCapacity.go:109-117``, SURVEY.md §2.4 Q2).
    ``input_cpu_error_payloads`` are the suffix-stripped CPU flag values the
    reference codec failed to parse (requests first, then limits).
    """

    cpu_request_milli: int
    mem_request_bytes: int
    replicas: int
    cpu_limit_milli: int = 0
    mem_limit_bytes: int = 0
    input_cpu_error_payloads: tuple[str, ...] = ()

    def validate(self) -> None:
        """Reject requests the reference would crash on (SURVEY.md §2.4 Q8).

        A zero CPU request is the reference's integer divide-by-zero panic
        at ``ClusterCapacity.go:123``; memory can reach zero too (``"0.5B"``
        passes ``bytefmt``'s positivity check and truncates to 0, panicking
        at ``:129``).  CPU requests are uint64 — any NONZERO bit pattern is
        a valid, if enormous, divisor — and negative replicas are accepted,
        as Go's ``Atoi`` accepts them.
        """
        if self.cpu_request_milli % (1 << 64) == 0:
            raise ScenarioError(
                "cpuRequests must be nonzero (the reference integer-divides "
                "by it and would panic on zero)"
            )
        if self.mem_request_bytes <= 0:
            raise ScenarioError("memRequests must be > 0")


def scenario_from_flags(
    cpuRequests: str = DEFAULT_CPU_REQUESTS,
    cpuLimits: str = DEFAULT_CPU_LIMITS,
    memRequests: str = DEFAULT_MEM_REQUESTS,
    memLimits: str = DEFAULT_MEM_LIMITS,
    replicas: str = DEFAULT_REPLICAS,
) -> Scenario:
    """Parse flag strings exactly as the reference ``main`` does (``:64-83``).

    * CPU flags go through the reference codec — parse failure silently
      yields 0 there (validation is deferred to :meth:`Scenario.validate`).
    * Memory flags: a ``bytefmt`` parse error is fatal (``os.Exit(1)`` at
      ``:68-77``) → :class:`ScenarioError` here.
    * Replicas: Go ``strconv.Atoi`` failure is fatal (``:79-83``).
    """
    cpu_req = cpu_to_milli_reference(cpuRequests)
    cpu_lim = cpu_to_milli_reference(cpuLimits)
    # Requests convert before limits in main (:64-65); each failure is one
    # codec error line printed before the parsed-input line.
    cpu_error_payloads = tuple(
        p
        for p in (
            cpu_parse_error_payload(cpuRequests),
            cpu_parse_error_payload(cpuLimits),
        )
        if p is not None
    )
    # Fatal-flag errors carry the reference's exact Println output: the
    # zeroed value ToBytes/Atoi returned alongside its error, space-joined
    # (ClusterCapacity.go:69,75,81).
    try:
        mem_req = to_bytes_reference(memRequests)
    except QuantityParseError as e:
        raise ScenarioError(
            f"Invalid input memRequests: {e}",
            reference_line=f"ERROR : Invalid input memRequests = 0 {e} ...exiting",
        ) from e
    try:
        mem_lim = to_bytes_reference(memLimits)
    except QuantityParseError as e:
        raise ScenarioError(
            f"Invalid input memLimits: {e}",
            reference_line=f"ERROR : Invalid input memLimits = 0 {e} ...exiting",
        ) from e
    n_replicas = go_atoi(replicas)  # Go strconv.Atoi acceptance rules (:79)
    if n_replicas is None:
        # Go prints the VALUE Atoi returned with its error — 0 for syntax
        # errors but the int64-CLAMPED value for range errors (:81).
        raise ScenarioError(
            f"Invalid input replicas: {replicas!r}",
            reference_line=(
                f"ERROR : Invalid input replicas = "
                f"{go_atoi_clamped(replicas)} "
                f"{go_atoi_error(replicas)} ...exiting"
            ),
        )
    return Scenario(
        cpu_request_milli=cpu_req,
        mem_request_bytes=mem_req,
        replicas=n_replicas,
        cpu_limit_milli=cpu_lim,
        mem_limit_bytes=mem_lim,
        input_cpu_error_payloads=cpu_error_payloads,
    )


@dataclass(frozen=True)
class ScenarioGrid:
    """A batch of S scenarios as dense arrays — the sweep's scenario axis.

    ``cpu_request_milli`` (uint64 bit patterns in an int64 carrier),
    ``mem_request_bytes`` and ``replicas`` are int64 ``[S]`` arrays.
    """

    cpu_request_milli: np.ndarray
    mem_request_bytes: np.ndarray
    replicas: np.ndarray

    def __post_init__(self) -> None:
        for name in ("cpu_request_milli", "mem_request_bytes", "replicas"):
            arr = np.asarray(getattr(self, name), dtype=np.int64)
            object.__setattr__(self, name, arr)
        if not (
            self.cpu_request_milli.shape
            == self.mem_request_bytes.shape
            == self.replicas.shape
        ) or self.cpu_request_milli.ndim != 1:
            raise ScenarioError("scenario arrays must be equal-length 1-D")

    @property
    def size(self) -> int:
        return int(self.cpu_request_milli.shape[0])

    def validate(self) -> None:
        # A negative CPU entry is a wrapped huge request (fits 0 everywhere,
        # reference semantics); only a true zero is the panic case (Q8).
        if (self.cpu_request_milli == 0).any():
            raise ScenarioError("all cpu requests must be nonzero")
        if (self.mem_request_bytes <= 0).any():
            raise ScenarioError("all mem requests must be > 0")

    @classmethod
    def from_scenarios(cls, scenarios: list[Scenario]) -> "ScenarioGrid":
        return cls(
            cpu_request_milli=np.array(
                [int64_bits(s.cpu_request_milli) for s in scenarios],
                dtype=np.int64,
            ),
            mem_request_bytes=np.array(
                [s.mem_request_bytes for s in scenarios], dtype=np.int64
            ),
            replicas=np.array([s.replicas for s in scenarios], dtype=np.int64),
        )

    def __getitem__(self, i: int) -> Scenario:
        return Scenario(
            cpu_request_milli=int(self.cpu_request_milli[i]),
            mem_request_bytes=int(self.mem_request_bytes[i]),
            replicas=int(self.replicas[i]),
        )


@dataclass(frozen=True)
class MultiResourceGrid:
    """An R-resource what-if grid (BASELINE config 4's scenario axis).

    ``resources`` names the request rows in order (``"cpu"`` in millicores,
    ``"memory"`` in bytes, anything else an extended-resource column of the
    snapshot, in its native unit); ``requests`` is ``[S, R]`` int64;
    ``replicas`` is ``[S]``.
    """

    resources: tuple[str, ...]
    requests: np.ndarray
    replicas: np.ndarray

    def __post_init__(self) -> None:
        object.__setattr__(self, "resources", tuple(self.resources))
        if len(set(self.resources)) != len(self.resources):
            # A duplicate would alias one snapshot column twice
            # (resource_matrix maps by name): fail instead.
            raise ScenarioError(
                f"duplicate resource names in {self.resources!r}"
            )
        req = np.asarray(self.requests, dtype=np.int64)
        rep = np.asarray(self.replicas, dtype=np.int64)
        if req.ndim != 2 or req.shape[1] != len(self.resources):
            raise ScenarioError(
                f"requests must be [S, {len(self.resources)}], got {req.shape}"
            )
        if rep.shape != (req.shape[0],):
            raise ScenarioError("replicas must be [S]")
        object.__setattr__(self, "requests", req)
        object.__setattr__(self, "replicas", rep)

    @property
    def size(self) -> int:
        return int(self.requests.shape[0])

    @classmethod
    def from_grid(
        cls, grid: ScenarioGrid, extended: dict | None = None
    ) -> "MultiResourceGrid":
        """Lift a 2-resource grid, optionally adding extended columns
        (``{resource_name: [S] per-replica requests}``, in sorted name
        order after cpu and memory)."""
        extended = dict(extended or {})
        names = ("cpu", "memory", *sorted(extended))
        cols = [grid.cpu_request_milli, grid.mem_request_bytes]
        for r in names[2:]:
            col = np.asarray(extended[r], dtype=np.int64)
            if col.shape != (grid.size,):
                raise ScenarioError(f"extended column {r!r} must be [S]")
            cols.append(col)
        return cls(
            resources=names,
            requests=np.stack(cols, axis=1),
            replicas=grid.replicas,
        )

    def validate(self) -> None:
        """cpu/memory must be positive (the reference's zero-request panic,
        SURVEY §2.4 Q8); extended requests may be 0 = "does not consume";
        negative anything is rejected."""
        if (self.requests < 0).any():
            raise ScenarioError("requests must be >= 0")
        for i, r in enumerate(self.resources):
            if r in ("cpu", "memory") and (self.requests[:, i] == 0).any():
                raise ScenarioError(f"all {r} requests must be > 0")
        if (self.replicas < 0).any():
            raise ScenarioError("all replicas must be >= 0")


def random_scenario_grid(
    n_scenarios: int,
    *,
    seed: int = 0,
    cpu_milli_range: tuple[int, int] = (50, 4000),
    mem_mib_range: tuple[int, int] = (64, 8192),
    replicas_range: tuple[int, int] = (1, 500),
) -> ScenarioGrid:
    """Random what-if grid (BASELINE config 3: "1k random (cpu,mem) grid").

    Memory requests are drawn in whole MiB so the fused int32 KiB-rescaled
    kernel stays eligible; the exact path accepts arbitrary bytes.  The
    same seed draws the same grid as the JAX package.
    """
    rng = np.random.default_rng(seed)
    return ScenarioGrid(
        cpu_request_milli=rng.integers(
            cpu_milli_range[0], cpu_milli_range[1], size=n_scenarios, dtype=np.int64
        ),
        mem_request_bytes=rng.integers(
            mem_mib_range[0], mem_mib_range[1], size=n_scenarios, dtype=np.int64
        )
        * (1024 * 1024),
        replicas=rng.integers(
            replicas_range[0], replicas_range[1], size=n_scenarios, dtype=np.int64
        ),
    )
