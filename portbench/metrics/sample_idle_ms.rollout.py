"""sample_idle_ms.rollout: the card's idle time inside the program's
``serve.sample`` spans per ``engine.decode`` span of the traced stretch, in
ms a decode step: ``sample_idle.rollout`` without its swing with the
admissions the stretch holds."""
from benchlib import spans


def read(view):
    if view.trace is None or view.kind != "rollout":
        return None
    return spans.idle_ms_per(view.trace, ("serve.sample",), "engine.decode")
