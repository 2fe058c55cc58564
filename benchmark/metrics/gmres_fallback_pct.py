"""The share of the adjoint's sample-steps that fell to its GMRES fallback
(`BackwardStats` fallback_lanes over lane_steps), in %."""


def read(t):
    a = t["adjoint"]
    if not a or not a["lane_steps"]:
        return None
    return 100.0 * a["fallback_lanes"] / a["lane_steps"]
