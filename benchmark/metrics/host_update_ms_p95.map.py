"""``host_update_ms_p95.map``: the 95th percentile of the host's
milliseconds an update, from its start to its scalar read, over the traced
run's updates before the profiler started."""
import numpy as np


def read(rc):
    if not rc.untraced_lat:
        return None
    return float(np.percentile(np.asarray(rc.untraced_lat), 95)) * 1e3
