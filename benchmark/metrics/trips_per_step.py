"""The adjoint's fixed-point trips per sample-step with a cotangent
(`BackwardStats` lane_trips over lane_steps)."""


def read(t):
    a = t["adjoint"]
    if not a or not a["lane_steps"]:
        return None
    return a["lane_trips"] / a["lane_steps"]
