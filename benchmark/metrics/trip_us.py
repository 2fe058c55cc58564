"""Device microseconds an adjoint fixed-point trip: the adjoint programs'
"trips" loops' device time (`%globaltimer` at the loop's entry and at its
last body run) over their iterations (body runs x block length, masked
ones included).  Read from the program's tracer
(`utils/timing.last_report`); nothing where the program has none."""


def read(t):
    from diffcloth_tpu_torch.utils import timing
    r = getattr(timing, "last_report", lambda: None)()
    loop = (r or {}).get("loops", {}).get("adj", {}).get("trips")
    if not loop or not loop["iters"]:
        return None
    return 1e6 * loop["device_s"] / loop["iters"]
