"""Particles in obstacle contact per sample-step
(`StepRecord.obstacle_contacts`); nothing where the scene has none."""


def read(t):
    _, _, contacts, steps = t["sums"]
    return contacts / steps if steps and contacts else None
