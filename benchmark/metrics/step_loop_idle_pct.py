"""The device's idle share inside the step loops: the idle seconds (the
window less the programs' CUDA-event intervals, on the host clock) given
to the forward's `chunk` spans and the backward's `recompute` spans, the
innermost spans open over them, over the window's wall, in %: the host
between one step's programs and the next.  Read from the program's tracer
(`utils/timing.last_report`); nothing where the program has none."""


def read(t):
    from diffcloth_tpu_torch.utils import timing
    r = getattr(timing, "last_report", lambda: None)()
    if not r or not r["launches"] or not t.get("window_s"):
        return None
    idle = r["idle_s"]
    return 100.0 * (idle.get("chunk", 0.0)
                    + idle.get("recompute", 0.0)) / t["window_s"]
