"""mfu.train: the learner's model FLOPs over the window (every step's
6 N tokens plus causal attention, ``roofline.train_step_flops``) over
the window's seconds times the bf16 peak times the cards, in percent."""
from benchlib import roofline


def read(view):
    if view.kind != "train" or not view.steps:
        return None
    flops = view.step_flops * view.steps
    return 100.0 * flops / (view.window_s * roofline.PEAK_BF16 * view.chips)
