"""p95_ms: the 95th percentile, over every request of the window, of the
time from its submission to its answer on the host. A closed-loop burst's
requests share its latency, so each burst counts once per request."""

import numpy as np


def read(ctx):
    w = ctx["window"]
    per_request = np.repeat(w["latencies"], w["burst"])
    return 1e3 * float(np.percentile(per_request, 95))
