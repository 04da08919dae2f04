"""95th percentile of the latency of every request due in the window,
from when it was due to when its answer came (host clock); a request that
failed or was not answered counts with the whole wait until it was given
up, past any limit."""
import numpy as np


def read(rec):
    lat = rec.get('latencies_ms')
    if lat is None or len(lat) == 0:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 95))
