"""ttft_p90_s.rollout: the 90th percentile of the wait from a request's
arrival to its first token, over every request issued in the window; one
still waiting at the close counts with its wait so far."""
import numpy as np


def read(view):
    if view.kind != "rollout" or not view.ttfts:
        return None
    return float(np.percentile(view.ttfts, 90))
