"""Whether a run's answers are right: the plain reference (`reference/`)
works out again what the window's answers say, and each compared number is
held to its limit in `limits/<cell>.json`.

The numbers, each the largest over what the run checked:
  step_gap  |v_program - v_reference| / |v_reference| of a step's velocity
            (over the state, per episode), the reference's step taken from
            the program's own state before it;
  adjoint_gap  |lambda_program - lambda_reference| of the cotangent on a
            state, the reference's from the VJP of the step after it at the
            program's cotangents (with the loss's own), over the episode's
            largest |lambda_program|: the largest over every step of every
            checked episode, so a fault at one step (a contact's friction
            VJP, a GMRES fallback) shows;
  loss_gap  |L_program - L_reference| of a checked episode's loss, the
            reference's of its own states after each step, over
            |L_reference| or the checked episodes' median, whichever is
            larger;
  grad_gap  |G_program - G_reference| of an entry of a checked episode's
            gradient vector, G_reference the sum of the reference's
            parameter VJPs of every step at the program's cotangents, over
            that entry's largest |G_reference| among the checked episodes
            or the median entry's, whichever is larger."""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark import traffic as tr
from benchmark.reference import judge
from benchmark.reference import scene as rscene

HERE = os.path.dirname(os.path.abspath(__file__))


def limits(cell: str) -> dict:
    with open(os.path.join(HERE, "limits", cell + ".json")) as f:
        return json.load(f)["limits"]


def fields_of(cfg: dict, X: np.ndarray, defaults: dict) -> dict:
    """Candidate vectors (E, D) -> field -> (E, ...) numpy, each field's
    other entries from the base (or the scene's `defaults`)."""
    out = {}
    for j, (f, i) in enumerate(cfg["vector"]):
        if f not in out:
            v = np.asarray(cfg["base"].get(f, defaults[f]), np.float64)
            out[f] = np.repeat(v[None], X.shape[0], 0).astype(np.float64)
        if i is None:
            out[f][:, ...] = X[:, j].reshape((-1,) + (1,) * (out[f].ndim - 1))
        else:
            out[f][:, i] = X[:, j]
    return out


def trim(kept: list, traffic: dict, seed: int) -> list:
    """The evaluations' kept episodes cut to the traffic's
    "episodes_per_run", drawn from the seed among all of them; each
    evaluation keeps its chosen rows in order."""
    n = traffic["check"].get("episodes_per_run")
    if not kept or n is None:
        return kept
    rows = [(i, j) for i, ev in enumerate(kept)
            for j in range(len(ev["episodes"]))]
    pick = set(map(tuple, np.asarray(rows)[np.sort(tr.rng(seed, 4).choice(
        len(rows), min(n, len(rows)), replace=False))].tolist()))
    out = []
    for i, ev in enumerate(kept):
        js = [j for j in range(len(ev["episodes"])) if (i, j) in pick]
        if js:
            out.append(dict(ev, **{k: ev[k][js] for k in
                                   ("episodes", "x", "v", "lx", "lv")}))
    return out


def judge_run(cfg: dict, kept: list, x0: np.ndarray, target_checks: list,
              target_x, device="cuda") -> tuple:
    """The compared numbers of a run, and the per-episode and per-step gaps
    they are the largest of: `kept` its evaluations' answers (as
    `program.Cell` keeps them), x0 its (P, n, 3) starts, `target_checks`
    the target's checked steps, target_x ([P,] N + 1, n, 3) its target."""
    sim, _ = rscene.reference_sim(cfg, device=device)
    defaults = {k: v.detach().cpu().numpy()
                for k, v in sim.default_params().items()}
    out, raw = {"step_gap": 0.0}, {}
    # the target's checked steps, every episode of it
    if target_checks:
        Pt = target_checks[0][1].shape[0]
        truth = dict(cfg["base"], **cfg["truth"])
        p = judge.batched_params(sim, truth, {}, x0[:Pt])
        for k, *states in target_checks:
            gv = judge.follow(sim, p, k, *states)
            out["step_gap"] = max(out["step_gap"], float(gv.max()))
    # the judged episodes of all evaluations in one batch
    eps = np.concatenate([ev["episodes"] for ev in kept])
    X = np.concatenate([ev["X"][ev["episodes"]] for ev in kept])
    p = judge.batched_params(sim, cfg["base"], fields_of(cfg, X, defaults),
                             x0[eps])
    tgt = np.asarray(target_x)
    tgt = tgt[eps] if tgt.ndim == 4 else np.repeat(tgt[None], len(eps), 0)
    L_ref, G_ref, gaps, num, lam = judge.adjoint_steps(
        sim, p, *(np.concatenate([ev[k] for ev in kept])
                  for k in ("x", "v", "lx", "lv")), tgt, cfg["vector"])
    L = np.concatenate([ev["loss"][ev["episodes"]] for ev in kept])
    G = np.concatenate([ev["grad"][ev["episodes"]] for ev in kept])
    out["step_gap"] = max(out["step_gap"], float(gaps.max()))
    chain = cotangent_gaps(num, lam)
    out["adjoint_gap"] = float(chain.max())
    out["loss_gap"] = float(np.max(np.abs(L - L_ref) / _scale(
        np.abs(L_ref))))
    # per entry of the vector, against the largest |entry| over the judged
    # episodes or the median entry's largest, whichever is larger: at a
    # candidate near the optimum, or for an entry the loss hardly moves,
    # the gradient is all but zero
    s = np.abs(G_ref).max(axis=0)
    s = np.maximum(s, np.median(s))
    per_ep = np.abs(G - G_ref) / np.maximum(s, 1e-30)
    out["grad_gap"] = float(np.max(per_ep))
    raw.update(step=gaps, chain=chain, num=num, lam=lam, grad=per_ep,
               loss=np.abs(L - L_ref) / _scale(np.abs(L_ref)))
    return out, raw


def cotangent_gaps(num: np.ndarray, lam: np.ndarray) -> np.ndarray:
    """(E, N - 1) each step's cotangent gap |lambda_ref - lambda| over the
    episode's largest |lambda|.  A step's own |lambda| would be the finer
    scale, but there the two adjoints' fixed points, each stopped at an
    absolute tolerance, read 2-16 % apart at a few steps against a
    control's 46 %: no limit would hold."""
    return num / np.maximum(lam.max(axis=1, keepdims=True), 1e-30)


def _scale(a: np.ndarray) -> np.ndarray:
    """Each of a, or the median of a where that is larger."""
    return np.maximum(np.maximum(a, np.median(a)), 1e-30)


def verdict(numbers: dict, lim: dict) -> bool:
    """Every number finite and within its limit."""
    return all(np.isfinite(numbers.get(k, np.nan)) and numbers[k] <= v
               for k, v in lim.items())


def free_device():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
