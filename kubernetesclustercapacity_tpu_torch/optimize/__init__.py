"""Optimization-based packing backend.

Counterpart of ``kubernetesclustercapacity_tpu/optimize``.  The first-fit
packer answers "how many fit" by walking nodes; it can neither bound its
distance from optimal nor *price* capacity.  This package formulates
replica placement as a linear program over the (shape, count) node groups
and solves it with a scenario-batched primal-dual iteration on the card
(:mod:`.lp`), emitting a **duality certificate** (a solve that cannot
certify says ``uncertified``, never a silently-wrong bound) and
per-resource **shadow prices** for every answer.
"""

from kubernetesclustercapacity_tpu_torch.optimize.lp import (
    DEFAULT_MAX_ITERS,
    DEFAULT_TOL,
    OPT_RESOURCES,
    OptimizeError,
    OptimizeResult,
    lp_bound_oracle,
    opt_max_iters,
    opt_tol,
    optimize_snapshot,
    verify_rounded_packing,
)

__all__ = [
    "DEFAULT_MAX_ITERS",
    "DEFAULT_TOL",
    "OPT_RESOURCES",
    "OptimizeError",
    "OptimizeResult",
    "lp_bound_oracle",
    "opt_max_iters",
    "opt_tol",
    "optimize_snapshot",
    "verify_rounded_packing",
]
