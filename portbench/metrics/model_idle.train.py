"""model_idle.train: the card's idle time inside the program's
``learner.loss`` or ``learner.grad`` spans (the forward, the n-step
returns inside it, and the backward of the learner's steps) over the
traced steps, in percent."""
from benchlib import spans


def read(view):
    if view.trace is None or view.kind != "train":
        return None
    return spans.idle_share(view.trace, ("learner.loss", "learner.grad"))
