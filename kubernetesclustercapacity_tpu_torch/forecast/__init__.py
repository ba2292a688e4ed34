"""Capacity forecasting and certified planning (counterpart of
``kubernetesclustercapacity_tpu/forecast/``): time-to-breach and "what to
buy", derived from verified history.

* :mod:`.trend` — robust Theil–Sen demand/supply trends replayed from the
  audit log's digest-verified generations;
* :mod:`.horizon` — the trend composed with the seeded sampler: capacity
  quantiles projected over ``H`` steps as ONE ``[H·S]`` exact sweep on the
  card, reduced to ``time_to_breach_s`` per quantile;
* :mod:`.planner` — the cheapest node set from a shape catalog that
  restores a quantile, with a closed-form LP bound, the scale-down dual and
  host-side certification.
"""

from kubernetesclustercapacity_tpu_torch.forecast.horizon import (  # noqa: F401
    DEFAULT_STEP_S,
    DEFAULT_STEPS,
    HorizonResult,
    horizon_oracle,
    max_steps,
    project_horizon,
)
from kubernetesclustercapacity_tpu_torch.forecast.planner import (  # noqa: F401
    CatalogShape,
    PlannerError,
    PlanResult,
    apply_plan,
    load_catalog,
    parse_catalog,
    plan_capacity,
)
from kubernetesclustercapacity_tpu_torch.forecast.trend import (  # noqa: F401
    TrendFit,
    fit_trend,
    trend_from_audit,
    trend_oracle,
)
