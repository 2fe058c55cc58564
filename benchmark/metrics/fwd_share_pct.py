"""The chunked value-and-grad's forward share: the forward seconds of every
evaluation in the window (`value_and_grad.split`, synchronized at both
ends) over the evaluations' wall, in %."""


def read(t):
    splits = [e["split"] for e in t["evals"] if e["split"]]
    if not splits:
        return None
    return 100.0 * sum(s["forward_s"] for s in splits) / sum(
        e["wall"] for e in t["evals"])
