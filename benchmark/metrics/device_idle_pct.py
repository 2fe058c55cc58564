"""The device's idle share of the window: 100 (1 - the step programs'
device seconds over the window's wall).  The programs' time comes from
the CUDA events around each program launch; work outside the programs
(autograd's glue, the records, the loss) counts as idle."""


def read(t):
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
