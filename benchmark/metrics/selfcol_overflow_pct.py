"""The share of sample-steps whose self-contacts overflowed the capacity
and were dropped (`StepRecord.selfcol_overflow`), in %."""


def read(t):
    _, overflow, _, steps = t["sums"]
    return 100.0 * overflow / steps if steps else None
