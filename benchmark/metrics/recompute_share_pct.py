"""The backward's recompute share of the window: the CUDA-event seconds of
the PD programs ("pd" launches) that the chunked value-and-grad's
`recompute` spans queued, over the window's wall, in %.  Read from the
program's tracer (`utils/timing.last_report`); nothing where the program
has none."""


def read(t):
    from diffcloth_tpu_torch.utils import timing
    r = getattr(timing, "last_report", lambda: None)()
    if not r or "pd" not in r["launch_s"] or not t.get("window_s"):
        return None
    return 100.0 * r["launch_s"]["pd"].get("recompute", 0.0) / t["window_s"]
