"""The PD programs' time outside their loop: the "pd" launches' CUDA-event
seconds less their "pd" loops' device seconds, over the former, in %: the
contact prologue (obstacle and self-contact detection) and the epilogue.
Read from the program's tracer (`utils/timing.last_report`); nothing where
the program has none."""


def read(t):
    from diffcloth_tpu_torch.utils import timing
    r = getattr(timing, "last_report", lambda: None)()
    if not r or not r["kind_s"].get("pd") or "pd" not in r["loops"]:
        return None
    inside = sum(lp["device_s"] for lp in r["loops"]["pd"].values())
    return 100.0 * (r["kind_s"]["pd"] - inside) / r["kind_s"]["pd"]
