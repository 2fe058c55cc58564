"""The one generator of the benchmark's inputs.  A traffic mix is a data
file, `traffic/<name>.json`: the entry the window drives ("entry"), its
chunk, and how many of its answers the reference checks ("check").  A
configuration file says what a population holds: "population" candidates
drawn by "candidates" around "base", starting from "starts".  Every input
comes from (seed, evaluation index) alone, so one seed gives the same
inputs on every run."""
from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load(kind: str, name: str) -> dict:
    """configs/<name>.json or traffic/<name>.json (kind "configs" or
    "traffic")."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def rng(seed: int, *index: int) -> np.random.Generator:
    """A generator for (seed, index...): any whole seed, however large."""
    return np.random.default_rng([seed % (1 << 64), *index])


def base_vector(cfg: dict, defaults: dict) -> np.ndarray:
    """The candidate vector of the configuration's base: each entry of
    "vector" from "base", else from `defaults` (field -> array, the
    scene's own values)."""
    out = []
    for field, idx in cfg["vector"]:
        v = np.asarray(cfg["base"].get(field, defaults[field]), np.float64)
        out.append(float(v if idx is None else v.reshape(-1)[idx]))
    return np.array(out)


def candidates(cfg: dict, seed: int, index: int,
               base: np.ndarray) -> np.ndarray:
    """(P, D) candidate vectors of evaluation `index`, drawn from (seed,
    index) for one field of the base: "normal" adds sigma N(0, 1) to the
    base's entries (clipped to "clip"); "stratified" draws one entry in
    each of P equal bins of [low, high], in a random order, so that each
    candidate is uniform over the bounds and every evaluation spans them
    alike (the same work for every seed, the candidates its own)."""
    spec, P = cfg["candidates"], cfg["population"]
    g = rng(seed, 1, index)
    X = np.repeat(base[None], P, 0)
    cols = [j for j, (f, i) in enumerate(cfg["vector"])
            if f == spec["field"]
            and (spec.get("index") is None or i == spec["index"])]
    if spec["kind"] == "normal":
        X[:, cols] += spec["sigma"] * g.standard_normal((P, len(cols)))
        if "clip" in spec:
            X[:, cols] = np.clip(X[:, cols], *spec["clip"])
    elif spec["kind"] == "stratified":
        lo, hi = spec["low"], spec["high"]
        for j in cols:
            u = (g.permutation(P) + g.uniform(size=P)) / P
            X[:, j] = lo + (hi - lo) * u
    else:
        raise ValueError(f"candidates {spec['kind']!r}")
    return X


def checked_episodes(traffic: dict, seed: int, index: int,
                     P: int) -> np.ndarray:
    """The episodes of evaluation `index` whose answers the reference
    checks (sorted, distinct)."""
    k = min(traffic["check"].get("episodes_per_evaluation", 0), P)
    return np.sort(rng(seed, 2, index).choice(P, k, replace=False))


def checked_steps(count: int, seed: int, index: int, N: int,
                  first: bool) -> list:
    """`count` distinct steps (1-based) of an N-step episode batch, step 1
    among them when `first`."""
    g = rng(seed, 3, index)
    steps = [1] if first else []
    pool = [k for k in range(1, N + 1) if k not in steps]
    steps += g.choice(pool, min(count, len(pool)), replace=False).tolist()
    return sorted(int(k) for k in steps)
