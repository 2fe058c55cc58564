"""The adjoint programs' time outside their loops: the "adj" launches'
CUDA-event seconds less the device seconds of all their loops (trips,
GMRES fallback), over the former, in %: the adjoint's start, the
fallback's start and the residual's VJP.  Read from the program's tracer
(`utils/timing.last_report`); nothing where the program has none."""


def read(t):
    from diffcloth_tpu_torch.utils import timing
    r = getattr(timing, "last_report", lambda: None)()
    if not r or not r["kind_s"].get("adj") or "adj" not in r["loops"]:
        return None
    inside = sum(lp["device_s"] for lp in r["loops"]["adj"].values())
    return 100.0 * (r["kind_s"]["adj"] - inside) / r["kind_s"]["adj"]
