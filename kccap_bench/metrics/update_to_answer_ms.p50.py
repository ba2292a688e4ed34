"""``update_to_answer_p50_ms`` read in a traced run: the median, over the
window's ``update`` batches, of the time from when a batch was due to the
decoded reply of the sweep its writer sends the moment the update
returns."""

import numpy as np


def read(artifacts):
    x = artifacts["load"].get("update_to_answer_ms")
    return float(np.percentile(x, 50)) if x else None
