"""model_idle_ms.rollout: the card's idle time inside the program's
``serve.model`` spans of decode steps (those inside ``engine.decode``; a
prefill chunk's lie outside) per ``engine.decode`` span of the traced
stretch, in ms a decode step."""
from benchlib import spans


def read(view):
    if view.trace is None or view.kind != "rollout":
        return None
    return spans.idle_ms_per(view.trace, ("serve.model",), "engine.decode")
