"""selfcol_detect's share of its roofline: the least time its calls'
inputs allow on an H100 SXM (`roofline.py`) over their device time
(torch.profiler, an uncaptured replay of the cell's own steps), in %."""


def read(t):
    k = t.get("kernels", {}).get("selfcol_detect")
    if not k:
        return None
    return 100.0 * k["least_s_per_call"] / k["device_s_per_call"]
