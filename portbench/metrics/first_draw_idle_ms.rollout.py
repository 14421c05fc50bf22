"""first_draw_idle_ms.rollout: the card's idle time inside the program's
``engine.first_draw`` spans per ``engine.admit`` span of the traced stretch,
in ms an admission: ``first_draw_idle.rollout`` without its swing with the
number of admissions the stretch holds."""
from benchlib import spans


def read(view):
    if view.trace is None or view.kind != "rollout":
        return None
    return spans.idle_ms_per(view.trace, ("engine.first_draw",),
                             "engine.admit")
