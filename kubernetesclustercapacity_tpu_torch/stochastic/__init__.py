"""Stochastic capacity (counterpart of ``kubernetesclustercapacity_tpu/
stochastic/``): capacity-at-risk under usage uncertainty.

* :mod:`.distributions` — the point/normal/lognormal/empirical vocabulary,
  its loader, and the deterministic counter-based sampler (threefry with
  explicit seeds, the JAX package's draws bit for bit, on ``device``);
* :mod:`.car` — capacity-at-risk: samples → one ``[S]``-scenario exact
  sweep on the card → quantiles, pinned bit-exact against a numpy
  seed-replay oracle;
* :mod:`.history` — the empirical feed: observed per-pod usage and
  per-generation totals from the audit log's digest-verified generations.
"""

from kubernetesclustercapacity_tpu_torch.stochastic.car import (  # noqa: F401
    DEFAULT_QUANTILES,
    CaRResult,
    capacity_at_risk,
    car_oracle,
    fit_totals_numpy,
    quantile_index,
    quantile_label,
)
from kubernetesclustercapacity_tpu_torch.stochastic.distributions import (  # noqa: F401
    DistributionError,
    StochasticSpec,
    UsageDistribution,
    default_samples,
    load_stochastic_spec,
    parse_distribution,
    parse_stochastic_spec,
    sample_key,
    sample_usage,
)
from kubernetesclustercapacity_tpu_torch.stochastic.history import (  # noqa: F401
    InsufficientHistoryError,
    SeriesHistory,
    UsageHistory,
    extract_series,
    extract_usage_history,
)
