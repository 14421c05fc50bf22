"""first_draw_idle.rollout: the card's idle time inside the program's
``engine.first_draw`` spans (an admission's first tokens drawn on the host
from its last logits) over the traced stretch, in percent."""
from benchlib import spans


def read(view):
    if view.trace is None or view.kind != "rollout":
        return None
    return spans.idle_share(view.trace, ("engine.first_draw",))
