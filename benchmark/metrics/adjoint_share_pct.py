"""The adjoint's share of the window: the CUDA-event seconds of the adjoint
programs ("adj" launches) over the window's wall, in %.  Read from the
program's tracer (`utils/timing.last_report`); nothing where the program
has none."""


def read(t):
    from diffcloth_tpu_torch.utils import timing
    r = getattr(timing, "last_report", lambda: None)()
    if not r or "adj" not in r["kind_s"] or not t.get("window_s"):
        return None
    return 100.0 * r["kind_s"]["adj"] / t["window_s"]
