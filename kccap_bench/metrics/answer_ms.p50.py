"""``answer_p50_ms`` read in a traced run: the median latency of the
cell's query requests, from when each was due to its decoded reply, over
every request of the window (a failed request counts at the time it was
given up).  The profiler is on for the window's last seconds only."""

import numpy as np


def read(artifacts):
    x = artifacts["load"]["answer_ms"]
    return float(np.percentile(x, 50)) if x else None
