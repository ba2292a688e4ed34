"""Gang capacity: whole-gang counting over the topology hierarchy.

Counterpart of ``kubernetesclustercapacity_tpu/topology/gang.py``.  A
**gang** is ``ranks`` co-scheduled replicas of one per-rank pod spec (an
MPI job, a training step's workers) whose capacity is all-or-nothing: 63
of 64 ranks is zero gangs.  This module answers "how many WHOLE gangs
fit", under the topology constraints rank-aware schedulers enforce:

* **co-location** (``colocate``): every rank of a gang inside one
  domain of a level (``host``/``rack``/``zone``) — gangs may not span
  domains, though one domain may hold several gangs;
* **rank-aware spread** (``spread_level`` + ``max_ranks_per_domain``):
  at most k ranks of any ONE gang per domain of a (finer) level;
* **per-host anti-affinity** (``anti_affinity_host``): sugar for
  ``spread_level="host", max_ranks_per_domain=1``.

The math rides the per-node fit column every other surface uses (the
exact int64 program's fits), reduced by topology code on ``device``:

* co-location: domain capacity ``c_d = clamp(Σ_{n∈d} fit_n)``, gangs
  ``Σ_d c_d // R`` — a segmented sum (``index_add_`` into a ``[S, D+1]``
  int64 tensor, code ``-1`` spilling into the discarded last slot) and a
  floor-divide, vectorized over the scenario axis;
* spread: for each co-domain, the largest G with
  ``Σ_sub min(c_sub, G·k) ≥ G·R``.  That condition is exact — by
  max-flow/min-cut on the gang×domain transportation network the
  min cut is ``Σ_sub min(c_sub, G·k)`` — and the feasible set is an
  interval (``Σ min(c, G·k)`` is concave in G), so a vectorized binary
  search finds G* per (scenario, co-domain).

**The search's step count.**  The JAX package loops while any
``lo < hi``.  Here one host read of the upper bound ``hi0.max()`` fixes
the step count at its ``bit_length() + 1`` before the loop: each step
halves every interval (floor), and a converged interval stays put (with
``lo == hi`` the probe is ``lo``, which is always feasible), so the
extra steps change nothing and the loop needs no further sync.

**Grouped path**: domain membership folds into per-(group, domain)
COUNT matrices: a group's fit is shape-determined, so ``Σ_{n∈d} fit_n =
Σ_g cnt[g,d]·fit_g`` exactly — an ``[S,G]×[G,D]`` product over ~100s of
groups.  CUDA has no int64 matmul, so the product is an exact int64
broadcast-multiply-and-sum over G (chunked over S), never f64: fits are
clamped only after the sum, and reference-mode fits can exceed 2^53.
Host-level constraints use the singleton-host identity (``c_host =
fit_node`` on unique-hostname fleets); fleets with shared host domains
take the per-node path, explicitly.  ``KCCAP_GANG_GROUPED=0`` forces the
per-node reduction.

Domain capacities clamp into ``[0, 2^40]`` ranks before the gang
arithmetic — negative (reference-mode phantom/overcommit) capacity holds
no ranks, and beyond a trillion ranks the count saturates rather than
risking int64 wrap inside the search.  The pure numpy/Python oracle
(:func:`gang_oracle`, the JAX module's verbatim) applies the identical
clamp.  :func:`gang_capacity` and :func:`gang_explain` take ``device=``
(default ``"cuda"``; without a card they raise unless given ``"cpu"``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from kubernetesclustercapacity_tpu_torch import devcache as _devcache
from kubernetesclustercapacity_tpu_torch.topology.model import (
    LEVEL_ORDER,
    LEVELS,
    ClusterTopology,
    TopologyKeys,
    topology_from_snapshot,
)

__all__ = [
    "GangSpec",
    "GangSpecError",
    "GangResult",
    "gang_capacity",
    "gang_explain",
    "gang_oracle",
    "gang_spec_from_msg",
    "load_gang_spec",
    "parse_gang_block",
    "gang_grouped_enabled",
]

#: Carrier-safety clamp on domain capacities (ranks): negative holds
#: nothing, and past ~10^12 the gang count saturates instead of letting
#: ``G·k`` / ``G·R`` products wrap the int64 carrier mid-search.
CAP_MAX = 1 << 40


def gang_grouped_enabled() -> bool:
    """``KCCAP_GANG_GROUPED=0`` forces the per-node gang reduction even
    when grouped dispatch engages — the same restart-free escape hatch
    policy as ``KCCAP_GROUPING``, scoped to the gang kernels."""
    return os.environ.get("KCCAP_GANG_GROUPED", "1") != "0"


class GangSpecError(ValueError):
    """Malformed gang spec — every constraint-field inconsistency is a
    typed rejection with a clear message, never a silently-unconstrained
    evaluation (the ``place_replicas`` spread-knob guard's policy)."""


@dataclass(frozen=True)
class GangSpec:
    """R ranks of one per-rank pod plus the topology constraints.

    ``count`` is the schedulability target in WHOLE GANGS (the gang
    analog of replicas: ``schedulable = gangs >= count``).  Constraint
    fields and their validation are the module docstring's vocabulary.
    """

    ranks: int
    count: int = 1
    colocate: str | None = None
    spread_level: str | None = None
    max_ranks_per_domain: int | None = None
    anti_affinity_host: bool = False

    def __post_init__(self) -> None:
        if not isinstance(self.ranks, int) or isinstance(self.ranks, bool):
            raise GangSpecError(f"ranks must be an integer, got {self.ranks!r}")
        if self.ranks < 1:
            raise GangSpecError(f"ranks must be >= 1, got {self.ranks}")
        if not isinstance(self.count, int) or isinstance(self.count, bool):
            raise GangSpecError(f"count must be an integer, got {self.count!r}")
        if self.count < 0:
            raise GangSpecError(f"count must be >= 0, got {self.count}")
        for name in ("colocate", "spread_level"):
            lvl = getattr(self, name)
            if lvl is not None and lvl not in LEVELS:
                raise GangSpecError(
                    f"{name} must be one of {LEVELS}, got {lvl!r}"
                )
        # The place_replicas guard, gang-flavored: a cap without the
        # level it applies to (or a level without a cap) would evaluate
        # silently unconstrained — reject, never guess.
        if (self.max_ranks_per_domain is None) != (self.spread_level is None):
            raise GangSpecError(
                "max_ranks_per_domain and spread_level go together — a "
                "cap without its level (or a level without a cap) would "
                "leave the gang silently unconstrained"
            )
        if self.max_ranks_per_domain is not None:
            if not isinstance(self.max_ranks_per_domain, int) or isinstance(
                self.max_ranks_per_domain, bool
            ):
                raise GangSpecError(
                    f"max_ranks_per_domain must be an integer, got "
                    f"{self.max_ranks_per_domain!r}"
                )
            if self.max_ranks_per_domain < 1:
                raise GangSpecError(
                    f"max_ranks_per_domain must be >= 1, got "
                    f"{self.max_ranks_per_domain}"
                )
        if self.colocate is not None and self.spread_level is not None:
            if LEVEL_ORDER[self.spread_level] >= LEVEL_ORDER[self.colocate]:
                raise GangSpecError(
                    f"spread_level {self.spread_level!r} must be strictly "
                    f"finer than colocate {self.colocate!r} (hierarchy: "
                    f"{' < '.join(LEVELS)})"
                )
        if not isinstance(self.anti_affinity_host, bool):
            raise GangSpecError(
                f"anti_affinity_host must be a bool, got "
                f"{self.anti_affinity_host!r}"
            )
        if self.anti_affinity_host and self.spread_level == "host":
            raise GangSpecError(
                "anti_affinity_host IS a host-level spread cap of 1 — "
                "give one host constraint, not two"
            )
        if self.anti_affinity_host and self.colocate == "host":
            raise GangSpecError(
                "anti_affinity_host (one rank per host) contradicts "
                "colocate='host' (all ranks on one host)"
            )

    def effective_spread(self) -> tuple[str, int] | None:
        """The one spread constraint in force: ``(level, cap)`` or
        ``None``.  ``anti_affinity_host`` desugars to ``("host", 1)``;
        a cap above ``ranks`` is vacuous and clamps to ``ranks`` (a
        gang has only R ranks to place)."""
        if self.anti_affinity_host:
            return ("host", 1)
        if self.spread_level is not None:
            return (self.spread_level, min(self.max_ranks_per_domain, self.ranks))
        return None

    def to_wire(self) -> dict:
        out: dict = {"ranks": self.ranks, "count": self.count}
        if self.colocate is not None:
            out["colocate"] = self.colocate
        if self.spread_level is not None:
            out["spread_level"] = self.spread_level
            out["max_ranks_per_domain"] = self.max_ranks_per_domain
        if self.anti_affinity_host:
            out["anti_affinity_host"] = True
        return out


_GANG_KEYS = frozenset(
    {
        "ranks", "count", "colocate", "spread_level",
        "max_ranks_per_domain", "anti_affinity_host",
    }
)


def parse_gang_block(block) -> GangSpec:
    """A watchlist/wire ``gang:`` mapping → :class:`GangSpec` (unknown
    keys rejected — a typo'd constraint must never evaluate as
    unconstrained)."""
    if not isinstance(block, dict):
        raise GangSpecError(f"gang block must be a mapping, got {block!r}")
    unknown = set(block) - _GANG_KEYS
    if unknown:
        raise GangSpecError(
            f"unknown gang field(s) {sorted(unknown)} "
            f"(want {sorted(_GANG_KEYS)})"
        )
    if "ranks" not in block:
        raise GangSpecError("gang block needs 'ranks'")
    return GangSpec(
        ranks=block["ranks"],
        count=block.get("count", 1),
        colocate=block.get("colocate"),
        spread_level=block.get("spread_level"),
        max_ranks_per_domain=block.get("max_ranks_per_domain"),
        anti_affinity_host=block.get("anti_affinity_host", False),
    )


def gang_spec_from_msg(msg: dict) -> GangSpec:
    """The wire form: gang fields ride the request envelope flat (the
    protocol's flag convention), with string integers accepted."""

    def as_int(name, default=None):
        v = msg.get(name, default)
        if v is None or isinstance(v, bool):
            return v if v is None else v
        try:
            return int(v)
        except (TypeError, ValueError):
            raise GangSpecError(f"{name} must be an integer, got {v!r}")

    return GangSpec(
        ranks=as_int("ranks"),
        count=as_int("count", 1),
        colocate=msg.get("colocate"),
        spread_level=msg.get("spread_level"),
        max_ranks_per_domain=as_int("max_ranks_per_domain"),
        anti_affinity_host=bool(msg.get("anti_affinity_host", False)),
    )


def load_gang_spec(path: str):
    """``kccap -gang-spec FILE``: the watchlist grammar's pod block plus
    a ``gang:`` block in one document.  Returns ``(scenario, GangSpec)``.

    YAML when PyYAML is present, strict JSON otherwise — the same
    loader policy as the watchlist's.
    """
    import json as _json

    from kubernetesclustercapacity_tpu_torch.scenario import (
        ScenarioError,
        scenario_from_flags,
    )

    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        import yaml  # type: ignore[import-untyped]

        data = yaml.safe_load(text)
    except ImportError:
        try:
            data = _json.loads(text)
        except ValueError as e:
            raise GangSpecError(
                f"{path}: not valid JSON (and PyYAML is unavailable): {e}"
            ) from e
    except Exception as e:  # yaml.YAMLError — malformed document
        raise GangSpecError(f"{path}: cannot parse: {e}") from e
    if not isinstance(data, dict):
        raise GangSpecError(f"{path}: gang spec wants a mapping document")
    extra = set(data) - {"pod", "gang"}
    if extra:
        raise GangSpecError(
            f"{path}: unknown top-level field(s) {sorted(extra)} "
            "(want pod/gang)"
        )
    pod = data.get("pod") or {}
    if not isinstance(pod, dict):
        raise GangSpecError(f"{path}: 'pod' must be a mapping")
    try:
        scenario = scenario_from_flags(**{k: str(v) for k, v in pod.items()})
        scenario.validate()
    except (TypeError, ScenarioError) as e:
        raise GangSpecError(f"{path}: bad pod spec: {e}") from e
    if "gang" not in data:
        raise GangSpecError(f"{path}: gang spec needs a 'gang' block")
    return scenario, parse_gang_block(data["gang"])


# --- device programs (int64 tensors on one device) ---------------------

#: Elements of one ``[S_chunk, G, D]`` int64 intermediate of the grouped
#: products (2^24 × 8 bytes = 128 MiB); larger products run in S chunks.
_PRODUCT_BLOCK = 1 << 24


def _seg_sum(x_sd: torch.Tensor, seg: torch.Tensor, n_seg: int):
    """``[S, D]`` → ``[S, n_seg]``: column ``d`` added into segment
    ``seg[d]``; ``seg == n_seg`` is the discarded spill slot."""
    out = torch.zeros(
        (x_sd.shape[0], n_seg + 1), dtype=torch.int64, device=x_sd.device
    )
    out.index_add_(1, seg, x_sd)
    return out[:, :n_seg]


def _domain_caps(fits_sn, codes, *, n_domains: int):
    """``[S, N]`` fits × ``[N]`` codes → clamped ``[S, D]`` domain
    capacities.  One segmented sum per scenario row (code ``-1`` spills
    into a discarded slot), then the carrier-safety clamp."""
    ok = codes >= 0
    seg = torch.where(ok, codes, n_domains)
    sums = _seg_sum(torch.where(ok, fits_sn, 0), seg, n_domains)
    return sums.clamp(0, CAP_MAX)


def _i64_product(a_sg, b_gd):
    """Exact int64 ``a @ b`` (wrapping mod 2^64 like the JAX program's
    int64 matmul): a broadcast multiply and a sum over G, in S chunks."""
    s, g = a_sg.shape
    d = b_gd.shape[1]
    out = torch.empty((s, d), dtype=torch.int64, device=a_sg.device)
    step = max(1, _PRODUCT_BLOCK // max(g * d, 1))
    for lo in range(0, s, step):
        out[lo:lo + step] = (
            a_sg[lo:lo + step, :, None] * b_gd[None, :, :]
        ).sum(dim=1)
    return out


def _grouped_caps(fits_sg, cnt_gd):
    """Grouped form of :func:`_domain_caps`: ``Σ_g cnt[g,d]·fit_g``,
    then the same clamp — exact because a group's fit is every
    member's fit."""
    return _i64_product(fits_sg, cnt_gd).clamp(0, CAP_MAX)


def _gangs_colocated(caps_sd, ranks: int):
    """Whole gangs under co-location: ``Σ_d c_d // R`` per scenario."""
    return (caps_sd // max(int(ranks), 1)).sum(dim=-1)


def _gangs_colocated_per_group(fits_sg, cnt_g, ranks: int):
    """Host co-location on a singleton-host grouped fleet: every host's
    capacity IS its node's fit, so gangs = ``Σ_g cnt_g·(clamp(fit_g)//R)``
    — the whole-gang floor-divide stays count-weighted per group."""
    fits = fits_sg.clamp(0, CAP_MAX)
    return ((fits // max(int(ranks), 1)) * cnt_g[None, :]).sum(dim=-1)


def _search_steps(hi0) -> int:
    """Binary-search steps that settle every interval ``[0, hi0]``: one
    host read (see the module docstring)."""
    if hi0.numel() == 0:
        return 0
    return int(hi0.max()).bit_length() + 1


def _bisect(hi0, supply_at, r: int):
    """Largest feasible G in ``[0, hi0]`` per cell, ``supply_at(mid)``
    giving the min-cut supply at ``mid`` gangs."""
    lo = torch.zeros_like(hi0)
    hi = hi0
    for _ in range(_search_steps(hi0)):
        mid = (lo + hi + 1) // 2
        feasible = supply_at(mid) >= mid * r
        lo = torch.where(feasible, mid, lo)
        hi = torch.where(feasible, hi, mid - 1)
    return lo


def _gangs_spread(sub_caps_sd, parent_d, ranks, cap_k, *, n_co: int):
    """Max whole gangs per co-domain under a per-sub-domain rank cap.

    Binary search on G per (scenario, co-domain): feasibility of G gangs
    is ``Σ_{sub∈d} min(c_sub, G·k) ≥ G·R`` (exact by min-cut; the
    feasible set is an interval by concavity), evaluated as one
    segmented sum per search step.  Returns gangs summed over
    co-domains, ``[S]``.
    """
    caps = sub_caps_sd  # [S, Dsub], pre-clamped
    ok = parent_d >= 0
    seg = torch.where(ok, parent_d, n_co)
    safe_parent = torch.where(ok, parent_d, 0)
    r = max(int(ranks), 1)
    k = max(int(cap_k), 1)

    def seg_sum(x_sd):
        return _seg_sum(torch.where(ok, x_sd, 0), seg, n_co)

    def supply_at(mid):
        lim = mid.index_select(1, safe_parent) * k  # [S, Dsub]
        return seg_sum(torch.minimum(caps, lim))

    lo = _bisect(seg_sum(caps) // r, supply_at, r)
    return lo.sum(dim=-1)


def _gangs_spread_per_group(fits_sg, cnt_gd, ranks, cap_k):
    """The spread search on a singleton-host grouped fleet: host caps
    are per-node fits, so the feasibility sum is
    ``Σ_g cnt[g,d]·min(clamp(fit_g), G_d·k)`` — an ``[S, G, D]`` product
    per search step over ~100s of groups × co-domains, never N rows; the
    search runs per S chunk so the product stays within one block."""
    fits = fits_sg.clamp(0, CAP_MAX)  # [S, G]
    r = max(int(ranks), 1)
    k = max(int(cap_k), 1)
    s, g = fits.shape
    d = cnt_gd.shape[1]
    step = max(1, _PRODUCT_BLOCK // max(g * d, 1))
    out = torch.zeros(s, dtype=torch.int64, device=fits.device)
    for lo in range(0, s, step):
        f = fits[lo:lo + step]

        def supply_at(mid, f=f):
            minned = torch.minimum(f[:, :, None], mid[:, None, :] * k)
            return (minned * cnt_gd[None, :, :]).sum(dim=1)

        out[lo:lo + step] = _bisect(
            _i64_product(f, cnt_gd) // r, supply_at, r
        ).sum(dim=-1)
    return out


# --- host-side assembly -------------------------------------------------


@dataclass
class GangResult:
    """Gang capacity of S scenarios (numpy throughout).

    ``gangs[s]`` whole gangs; ``schedulable[s] = gangs >= spec.count``;
    ``pod_totals[s]`` the plain (gang-free) pod capacity for contrast;
    ``largest_cap``/``largest_domain`` the biggest co-location domain's
    rank capacity and name per scenario (cluster-wide when
    ``colocate`` is None); ``engine`` which reduction served
    (``"grouped"`` count-matrix or ``"per-node"``).
    """

    spec: GangSpec
    gangs: np.ndarray
    pod_totals: np.ndarray
    largest_cap: np.ndarray
    largest_domain: list
    mode: str
    engine: str
    excluded_nodes: int = 0
    co_caps: np.ndarray | None = field(default=None, repr=False)
    co_domains: list = field(default_factory=list, repr=False)

    @property
    def schedulable(self) -> np.ndarray:
        return self.gangs >= np.int64(self.spec.count)

    @property
    def size(self) -> int:
        return int(self.gangs.shape[0])

    def to_wire(self) -> dict:
        out = {
            "gangs": [int(g) for g in self.gangs],
            "schedulable": [bool(b) for b in self.schedulable],
            "pod_totals": [int(t) for t in self.pod_totals],
            "scenarios": self.size,
            "mode": self.mode,
            "engine": self.engine,
            "excluded_nodes": self.excluded_nodes,
            **self.spec.to_wire(),
        }
        return out


def _contingency(group_index, codes, n_groups, n_domains, node_mask):
    """``cnt[g, d]`` — nodes of shape group g inside domain d (masked
    and code-excluded nodes drop out), as one flat bincount."""
    keep = codes >= 0
    if node_mask is not None:
        keep = keep & np.asarray(node_mask, dtype=bool)
    flat = group_index[keep] * n_domains + codes[keep]
    return np.bincount(flat, minlength=n_groups * n_domains).astype(
        np.int64
    ).reshape(n_groups, n_domains)


def _level_codes(topo: ClusterTopology, level: str | None):
    """Codes and domain names at one level; ``None`` = the single
    cluster-wide domain."""
    if level is None:
        return np.zeros(topo.n_nodes, dtype=np.int64), ["cluster"]
    return topo.codes(level), topo.domains(level)


def _grouped_eligible(spec: GangSpec, topo: ClusterTopology) -> bool:
    """The grouped count-matrix path needs host-level constraints to
    mean per-node constraints (singleton hosts); rack/zone levels are
    always eligible (count matrices are exact at any compression)."""
    spread = spec.effective_spread()
    needs_host = spec.colocate == "host" or (
        spread is not None and spread[0] == "host"
    )
    return not needs_host or topo.host_singleton


def gang_capacity(
    snapshot,
    grid,
    spec: GangSpec,
    *,
    mode: str | None = None,
    node_mask=None,
    keys: TopologyKeys | None = None,
    missing: str = "own",
    topology: ClusterTopology | None = None,
    device="cuda",
) -> GangResult:
    """Whole-gang capacity of every scenario in ``grid`` under ``spec``.

    Per-rank fits come from the exact int64 program on ``device``
    (over node-shape groups when :func:`..snapshot.grouped_for_dispatch`
    engages, as in the JAX package), then reduce through the topology
    codes per the module's semantics on the same device.  ``mode``
    defaults to the snapshot's packing semantics and ``node_mask``
    composes like every fit surface (a masked node holds no ranks).
    Equal to :func:`gang_oracle` in both semantics modes and on both
    engines.
    """
    from kubernetesclustercapacity_tpu_torch.ops.fit import (
        sweep_grid,
        sweep_grid_grouped,
    )
    from kubernetesclustercapacity_tpu_torch.snapshot import (
        grouped_for_dispatch,
    )

    mode = mode or snapshot.semantics
    grid.validate()
    dev, put = _devcache.int64_putter(device)
    topo = topology or topology_from_snapshot(
        snapshot, keys=keys, missing=missing
    )
    spread = spec.effective_spread()
    grouped = (
        grouped_for_dispatch(snapshot) if gang_grouped_enabled() else None
    )
    if grouped is not None and not _grouped_eligible(spec, topo):
        grouped = None

    co_codes, co_domains = _level_codes(topo, spec.colocate)
    excluded = int((co_codes < 0).sum())
    if spread is not None:
        sub_codes, _sub_domains = _level_codes(topo, spread[0])
        excluded = max(excluded, int((sub_codes < 0).sum()))
    scen = [put(a) for a in (grid.cpu_request_milli, grid.mem_request_bytes,
                             grid.replicas)]

    def parent_of_sub():
        return put(
            topo.parent_map(spread[0], spec.colocate)
            if spec.colocate is not None
            else np.zeros(len(_sub_domains), dtype=np.int64)
        )

    if grouped is not None:
        counts = put(grouped.effective_counts(node_mask))
        fits_g = sweep_grid_grouped(
            *_devcache.CACHE.grouped_exact_tensors(grouped, dev),
            counts, *scen, mode=mode, return_per_group=True,
        )[2]  # [S, G]
        pod_totals = (fits_g * counts[None, :]).sum(dim=1)
        g_idx, n_g = grouped.group_index, grouped.n_groups
        cnt_co = _contingency(
            g_idx, co_codes, n_g, len(co_domains), node_mask
        )
        if spec.colocate == "host":
            # Singleton hosts (eligibility-guarded): per-group closed form.
            cnt_g = cnt_co.sum(axis=1)
            gangs = _gangs_colocated_per_group(fits_g, put(cnt_g),
                                               spec.ranks)
            co_caps = None
            largest_cap, largest_domain = _largest_group_host(
                fits_g.cpu().numpy(), cnt_g, grouped
            )
        else:
            cnt_co_t = put(cnt_co)
            co_caps_t = _grouped_caps(fits_g, cnt_co_t)
            if spread is not None and spread[0] == "host":
                gangs = _gangs_spread_per_group(
                    fits_g, cnt_co_t, spec.ranks, spread[1]
                )
            elif spread is not None:
                cnt_sub = _contingency(
                    g_idx, sub_codes, n_g, len(_sub_domains), node_mask
                )
                gangs = _gangs_spread(
                    _grouped_caps(fits_g, put(cnt_sub)), parent_of_sub(),
                    spec.ranks, spread[1], n_co=len(co_domains),
                )
            else:
                gangs = _gangs_colocated(co_caps_t, spec.ranks)
            co_caps = co_caps_t.cpu().numpy()
            largest_cap, largest_domain = _largest_of(co_caps, co_domains)
        engine = "grouped"
    else:
        mask_t = None if node_mask is None else put(node_mask, torch.bool)
        fits = sweep_grid(
            *_devcache.CACHE.exact_tensors(snapshot, dev), *scen,
            mode=mode, node_mask=mask_t, return_per_node=True,
        )[2]  # [S, N]
        pod_totals = fits.sum(dim=1)
        co_caps_t = _domain_caps(
            fits, put(_masked(co_codes, node_mask)),
            n_domains=len(co_domains),
        )
        if spread is None:
            gangs = _gangs_colocated(co_caps_t, spec.ranks)
        else:
            sub_caps = _domain_caps(
                fits, put(_masked(sub_codes, node_mask)),
                n_domains=len(_sub_domains),
            )
            gangs = _gangs_spread(
                sub_caps, parent_of_sub(), spec.ranks, spread[1],
                n_co=len(co_domains),
            )
        co_caps = co_caps_t.cpu().numpy()
        largest_cap, largest_domain = _largest_of(co_caps, co_domains)
        engine = "per-node"

    return GangResult(
        spec=spec,
        gangs=gangs.cpu().numpy().astype(np.int64),
        pod_totals=pod_totals.cpu().numpy().astype(np.int64),
        largest_cap=largest_cap,
        largest_domain=largest_domain,
        mode=mode,
        engine=engine,
        excluded_nodes=excluded,
        co_caps=co_caps,
        co_domains=list(co_domains),
    )


def _masked(codes: np.ndarray, node_mask) -> np.ndarray:
    """Fold the node mask into the code column (masked row → code -1 →
    contributes to no domain)."""
    if node_mask is None:
        return codes
    return np.where(np.asarray(node_mask, dtype=bool), codes, -1)


def _largest_of(caps_sd: np.ndarray, domains: list):
    """Per-scenario biggest co-domain: (cap, name)."""
    if caps_sd.shape[1] == 0:
        s = caps_sd.shape[0]
        return np.zeros(s, dtype=np.int64), [None] * s
    arg = np.argmax(caps_sd, axis=1)
    return (
        caps_sd[np.arange(caps_sd.shape[0]), arg].astype(np.int64),
        [domains[int(a)] for a in arg],
    )


def _largest_group_host(fits_sg, cnt_g, grouped):
    """Biggest host (= node) per scenario on the grouped path: the max
    clamped per-group fit among populated groups, named by the group's
    representative node."""
    fits = np.clip(np.asarray(fits_sg, dtype=np.int64), 0, CAP_MAX)
    populated = cnt_g > 0
    if not populated.any():
        s = fits.shape[0]
        return np.zeros(s, dtype=np.int64), [None] * s
    masked = np.where(populated[None, :], fits, -1)
    arg = np.argmax(masked, axis=1)
    names = grouped.representative_names()
    return (
        np.maximum(masked[np.arange(fits.shape[0]), arg], 0),
        [names[int(a)] for a in arg],
    )


# --- oracle -------------------------------------------------------------


def _oracle_caps(fits_n, codes, n_domains) -> np.ndarray:
    caps = np.zeros(n_domains + 1, dtype=np.int64)
    safe = np.where(codes >= 0, codes, n_domains)
    np.add.at(caps, safe, np.asarray(fits_n, dtype=np.int64))
    return np.clip(caps[:n_domains], 0, CAP_MAX)


def _oracle_spread_count(sub_caps: np.ndarray, ranks: int, k: int) -> int:
    """Largest G with ``Σ min(c, G·k) >= G·R`` — Python bisection over
    the same concave feasibility the kernel searches (an independent
    implementation, not a shared one)."""
    k = min(k, ranks)
    lo, hi = 0, int(sub_caps.sum()) // max(ranks, 1)

    def feasible(g: int) -> bool:
        return int(np.minimum(sub_caps, g * k).sum()) >= g * ranks

    while lo < hi:
        mid = (lo + hi + 1) // 2
        if feasible(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def gang_oracle(
    fits_sn, topo: ClusterTopology, spec: GangSpec, *, node_mask=None
) -> list[int]:
    """Pure numpy/Python gang counting over per-node fits — the ground
    truth the kernels pin against (no JAX anywhere on this path)."""
    fits = np.asarray(fits_sn, dtype=np.int64)
    if fits.ndim == 1:
        fits = fits[None, :]
    co_codes, co_domains = _level_codes(topo, spec.colocate)
    co_codes = _masked(co_codes, node_mask)
    spread = spec.effective_spread()
    out: list[int] = []
    for s in range(fits.shape[0]):
        if spread is None:
            caps = _oracle_caps(fits[s], co_codes, len(co_domains))
            out.append(int(sum(int(c) // spec.ranks for c in caps)))
            continue
        sub_codes, sub_domains = _level_codes(topo, spread[0])
        sub_codes = _masked(sub_codes, node_mask)
        sub_caps = _oracle_caps(fits[s], sub_codes, len(sub_domains))
        parent = (
            topo.parent_map(spread[0], spec.colocate)
            if spec.colocate is not None
            else np.zeros(len(sub_domains), dtype=np.int64)
        )
        total = 0
        for d in range(len(co_domains)):
            subs = sub_caps[parent == d]
            if subs.size:
                total += _oracle_spread_count(subs, spec.ranks, spread[1])
        out.append(total)
    return out


# --- explain ------------------------------------------------------------


def gang_explain(
    snapshot,
    grid,
    spec: GangSpec,
    *,
    mode: str | None = None,
    node_mask=None,
    keys: TopologyKeys | None = None,
    missing: str = "own",
    scenario: int = 0,
    device="cuda",
) -> dict:
    """WHY the gang count stops where it does: which topology LEVEL
    binds, contrasted with the cluster-wide resource story.

    Evaluates the spec, then re-evaluates with each constraint peeled
    (spread dropped; co-location dropped) to attribute the loss: the
    binding level is the finest constraint whose removal would raise
    the count; ``"cluster"`` means topology is not the constraint —
    plain resource headroom is, named via the pod-level explain
    histogram.  Every evaluation runs on ``device``.
    """
    from kubernetesclustercapacity_tpu_torch.explain import explain_snapshot

    mode = mode or snapshot.semantics
    topo = topology_from_snapshot(snapshot, keys=keys, missing=missing)
    result = gang_capacity(
        snapshot, grid, spec, mode=mode, node_mask=node_mask, topology=topo,
        device=device,
    )
    s = scenario
    gangs = int(result.gangs[s])
    pod_total = int(result.pod_totals[s])
    cluster_gangs = int(min(max(pod_total, 0), CAP_MAX)) // spec.ranks
    spread = spec.effective_spread()

    no_spread = gangs
    if spread is not None:
        bare = replace(
            spec,
            spread_level=None,
            max_ranks_per_domain=None,
            anti_affinity_host=False,
        )
        no_spread = int(
            gang_capacity(
                snapshot, grid, bare, mode=mode, node_mask=node_mask,
                topology=topo, device=device,
            ).gangs[s]
        )

    if spread is not None and gangs < no_spread:
        binding = spread[0]
    elif spec.colocate is not None and gangs < cluster_gangs:
        binding = spec.colocate
    else:
        binding = "cluster"

    ex = explain_snapshot(
        snapshot, _one_scenario(grid, s), mode=mode, node_mask=node_mask,
        device=device,
    )
    counts = ex.binding_counts(0)
    resource = max(
        ("cpu", "memory", "pods"), key=lambda r: counts.get(r, 0)
    )
    largest = {
        "name": result.largest_domain[s],
        "capacity": int(result.largest_cap[s]),
        "whole_gangs": int(result.largest_cap[s]) // spec.ranks,
    }
    level_word = spec.colocate or "cluster"
    if binding == "cluster":
        summary = (
            f"binds at cluster: {resource} headroom caps "
            f"{gangs} whole gang(s) of {spec.ranks}"
        )
    elif binding == spec.colocate:
        summary = (
            f"binds at {binding}: largest {binding} holds "
            f"{largest['capacity']}/{spec.ranks} ranks; cluster-wide "
            f"{resource} headroom is not the constraint"
        )
    else:
        summary = (
            f"binds at {binding}: max {spread[1]} rank(s) per {binding} "
            f"caps gangs at {gangs} (unconstrained {level_word} gangs: "
            f"{no_spread}); cluster-wide {resource} headroom is not "
            "the constraint"
        )
    out = {
        "gangs": gangs,
        "schedulable": bool(result.schedulable[s]),
        "binding": binding,
        "cluster_pods": pod_total,
        "cluster_gangs": cluster_gangs,
        "largest_domain": largest,
        "binding_counts": counts,
        "excluded_nodes": result.excluded_nodes,
        "summary": summary,
        **spec.to_wire(),
    }
    if spread is not None:
        out["gangs_without_spread"] = no_spread
    return out


def _one_scenario(grid, s: int):
    from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid

    return ScenarioGrid(
        cpu_request_milli=np.asarray(grid.cpu_request_milli)[[s]],
        mem_request_bytes=np.asarray(grid.mem_request_bytes)[[s]],
        replicas=np.asarray(grid.replicas)[[s]],
    )
