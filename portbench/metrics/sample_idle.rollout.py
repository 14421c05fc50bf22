"""sample_idle.rollout: the card's idle time inside the program's
``serve.sample`` spans (a decode step's row keys hashed on the host, the
Gumbel draw and the argmax) over the traced stretch, in percent."""
from benchlib import spans


def read(view):
    if view.trace is None or view.kind != "rollout":
        return None
    return spans.idle_share(view.trace, ("serve.sample",))
