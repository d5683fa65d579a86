"""gap_p95_ms (ms): the 95th percentile of the time between consecutive
sink writes inside one runner call, over every such pair in the window
(the boundaries between calls are left out: rt_factor counts them). None
below 200 gaps, where fewer than ten would lie beyond it."""

import numpy as np


def read(run):
    gaps = run.window.gaps_ms
    if len(gaps) < 200:
        return None
    return float(np.percentile(gaps, 95))
