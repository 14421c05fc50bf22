"""model_idle.rollout: the card's idle time inside the program's
``serve.model`` spans (the model's launches of a decode step or a prefill
chunk) over the traced stretch, in percent."""
from benchlib import spans


def read(view):
    if view.trace is None or view.kind != "rollout":
        return None
    return spans.idle_share(view.trace, ("serve.model",))
