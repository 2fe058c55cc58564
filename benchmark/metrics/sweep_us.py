"""Device microseconds a PD sweep: the PD programs' "pd" loops' device time
(`%globaltimer` at the loop's entry and at its last body run) over their
iterations (body runs x block length, masked ones included), the forward's
and the recompute's together.  Read from the program's tracer
(`utils/timing.last_report`); nothing where the program has none."""


def read(t):
    from diffcloth_tpu_torch.utils import timing
    r = getattr(timing, "last_report", lambda: None)()
    loop = (r or {}).get("loops", {}).get("pd", {}).get("pd")
    if not loop or not loop["iters"]:
        return None
    return 1e6 * loop["device_s"] / loop["iters"]
