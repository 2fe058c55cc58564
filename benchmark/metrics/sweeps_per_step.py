"""PD sweeps per sample-step: `StepRecord.iters` summed over the window's
forward episodes, over their sample-steps."""


def read(t):
    iters, _, _, steps = t["sums"]
    return iters / steps if steps else None
