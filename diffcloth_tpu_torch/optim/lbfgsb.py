"""Box-constrained L-BFGS-B with the reference hyperparameters.

The port's own copy of `diffcloth_tpu/optim/lbfgsb.py` (numpy and scipy
only; the port imports nothing of the JAX package).

reference: BackwardTaskSolver::optimizeLBFGS (BackwardTaskSolver.cpp:22-66)
runs LBFGSpp::LBFGSBSolver with delta=1e-3 (relative objective decrease with
a max(1,|f|) floor), m=10, max_linesearch=20.  scipy's L-BFGS-B exposes the
same knobs (ftol/factr is the identical criterion), so the host-side
optimizer runs on scipy while loss/gradient evaluations run on device.

The default ftol here is 1e-6, tighter than the reference's 1e-3: the
criterion's max(1,|f|) floor makes 1e-3 an *absolute* threshold once the
loss is below 1, which for task losses starting < 1 halts before any real
progress.  Pass ftol=1e-3 for strict reference behavior.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
from scipy.optimize import minimize


@dataclasses.dataclass
class LbfgsResult:
    x: np.ndarray
    loss: float
    n_iters: int
    n_evals: int
    converged: bool
    message: str
    loss_history: List[float]


def _two_loop(g, S, Y, rho):
    """Standard L-BFGS two-loop recursion: returns H·g."""
    q = g.copy()
    alphas = []
    for s, y, r in zip(reversed(S), reversed(Y), reversed(rho)):
        a = r * np.dot(s, q)
        alphas.append(a)
        q -= a * y
    if S:
        gamma = np.dot(S[-1], Y[-1]) / max(np.dot(Y[-1], Y[-1]), 1e-30)
        q *= gamma
    for (s, y, r), a in zip(zip(S, Y, rho), reversed(alphas)):
        b = r * np.dot(y, q)
        q += (a - b) * s
    return q


def minimize_lbfgsb_native(loss_and_grad, x0, lower, upper, *,
                           ftol: float = 1e-6, m: int = 10,
                           max_linesearch: int = 20, gtol: float = 1e-10,
                           maxiter: int = 100,
                           callback=None, state=None,
                           on_state=None) -> LbfgsResult:
    """Projected L-BFGS-B: two-loop recursion + Armijo backtracking along
    the projected arc x(a) = clip(x - a*Hg, bounds).

    Written from scratch (no scipy) because scipy's Fortran linesearch
    aborts on this problem family's first iteration (huge curvature change
    across the box, f32-quantized objective); a projected-arc backtracking
    search is robust to both.  Runs in the unit box like the scipy path.

    `on_state(state)` receives the solver's whole state (a dict of numpy
    arrays: the iterate x and its unit-box z, loss, gradient, curvature
    pairs, iteration count, loss history and whether it converged) after
    every accepted iteration;
    passing such a `state` back resumes the run exactly where it was, x0
    unused, up to `maxiter` iterations in all; a converged state returns at
    once (the checkpoints of optim.solver.solve_demo)."""
    lower = np.asarray(lower, np.float64)
    upper = np.asarray(upper, np.float64)
    rng = np.where(upper - lower > 0, upper - lower, 1.0)

    def to_phys(z):
        return lower + z * rng

    history: List[float] = []

    def fun(z):
        L, g = loss_and_grad(to_phys(z))
        history.append(float(L))
        return float(L), np.asarray(g, np.float64) * rng

    if state is None:
        z = (np.clip(np.asarray(x0, np.float64), lower, upper) - lower) / rng
        f, g = fun(z)
        S: List[np.ndarray] = []
        Y: List[np.ndarray] = []
        rho: List[float] = []
        n_iters = 0
    else:
        z, g = np.array(state["z"], np.float64), np.array(state["g"],
                                                          np.float64)
        f = float(state["f"])
        S, Y = list(np.array(state["S"])), list(np.array(state["Y"]))
        rho = [float(r) for r in state["rho"]]
        n_iters = int(state["n_iters"])
        history.extend(float(h) for h in state["history"])
    converged = bool(state["converged"]) if state is not None else False
    message = (str(state["message"]) if converged
               else "max iterations reached")
    for it in range(n_iters, n_iters if converged else maxiter):
        d = -_two_loop(g, S, Y, rho)
        if np.dot(d, g) > -1e-15:      # not a descent direction: reset
            S.clear(); Y.clear(); rho.clear()
            d = -g
        # Trial-step schedule: L-BFGS directions are well-scaled (start at
        # alpha=1), but on the first/reset iteration d = -g can be tiny in
        # the unit box; with an f32-quantized objective a microscopic step
        # shows zero decrease and pure backtracking starves.  Scale the
        # first trial to move ~10% of the box, and scan a geometric ladder
        # both below AND above it.
        d_inf = np.linalg.norm(d, np.inf)
        alpha0 = 1.0 if S else min(1.0, 0.1 / max(d_inf, 1e-30))
        ladder = [alpha0 * (0.25 ** k)
                  for k in range(max_linesearch - 4)]
        ladder += [alpha0 * (4.0 ** k) for k in range(1, 5)
                   if alpha0 * (4.0 ** k) * d_inf <= 1.0]
        accepted = False
        for alpha in ladder:
            zn = np.clip(z + alpha * d, 0.0, 1.0)
            step = zn - z
            sn = np.dot(g, step)
            if sn >= 0 or not np.any(step):
                continue
            fn, gn = fun(zn)
            if np.isfinite(fn) and fn <= f + 1e-4 * sn:
                accepted = True
                break
        if not accepted:
            message = "linesearch failed"
            converged = np.linalg.norm(
                np.clip(z - g, 0.0, 1.0) - z, np.inf) <= max(gtol, 1e-8)
            break
        s, y = zn - z, gn - g
        sy = np.dot(s, y)
        if sy > 1e-10 * np.linalg.norm(s) * np.linalg.norm(y):
            S.append(s); Y.append(y); rho.append(1.0 / sy)
            if len(S) > m:
                S.pop(0); Y.pop(0); rho.pop(0)
        n_iters += 1
        df = f - fn
        z, f, g = zn, fn, gn
        # reference convergence test: |f-f'| <= delta*max(1,|f|,|f'|)
        if df <= ftol * max(1.0, abs(f), abs(f + df)):
            converged = True
            message = "relative reduction of f <= ftol"
        elif np.linalg.norm(np.clip(z - g, 0.0, 1.0) - z, np.inf) <= gtol:
            converged = True
            message = "projected gradient <= gtol"
        if on_state is not None:
            D = z.shape[0]
            on_state({"x": to_phys(z), "z": z, "f": np.float64(f), "g": g,
                      "S": np.array(S).reshape(-1, D),
                      "Y": np.array(Y).reshape(-1, D),
                      "rho": np.array(rho, np.float64),
                      "n_iters": np.int64(n_iters),
                      "history": np.array(history, np.float64),
                      "converged": np.bool_(converged),
                      "message": np.str_(message)})
        if callback is not None:
            callback(n_iters, to_phys(z))
        if converged:
            break
    return LbfgsResult(x=to_phys(z), loss=f, n_iters=n_iters,
                       n_evals=len(history), converged=bool(converged),
                       message=message, loss_history=history)


def minimize_lbfgsb(loss_and_grad: Callable[[np.ndarray],
                                            Tuple[float, np.ndarray]],
                    x0: np.ndarray, lower: np.ndarray, upper: np.ndarray,
                    *, ftol: float = 1e-6, m: int = 10,
                    max_linesearch: int = 20, gtol: float = 1e-12,
                    maxiter: int = 100,
                    callback: Optional[Callable[[int, np.ndarray],
                                                None]] = None,
                    backend: str = "native", state=None,
                    on_state=None) -> LbfgsResult:
    """`callback(iteration, x)` fires once per L-BFGS iteration.
    `on_state` / `state` save and resume the native solver's whole state,
    the checkpoint hook (reference saveLastIter, OptimizeHelper.cpp
    :528-533; see minimize_lbfgsb_native).

    The solver runs in the unit box: parameters are affinely mapped to
    [0,1]^d by their bounds (gradients by the chain rule).  The physical
    parameters span 5+ orders of magnitude in range (wind +-0.1 vs stiffness
    ~1e3) and in gradient scale, which makes the raw box so anisotropic
    that the generalized Cauchy point lands on a corner and the first
    linesearch collapses; unit-box scaling is the standard conditioner
    (the reference gets a weaker version from its log-scale transform on
    selected parameters, OptimizeHelper.cpp:58,113,124).

    backend="native" (default) uses the from-scratch projected L-BFGS-B
    above, whose projected-arc backtracking is robust where scipy's Fortran
    linesearch aborts; backend="scipy" keeps the Fortran path."""
    if backend == "native":
        return minimize_lbfgsb_native(
            loss_and_grad, x0, lower, upper, ftol=ftol, m=m,
            max_linesearch=max_linesearch, gtol=max(gtol, 1e-12),
            maxiter=maxiter, callback=callback, state=state,
            on_state=on_state)
    if state is not None or on_state is not None:
        raise ValueError("saving and resuming the solver's state needs "
                         "backend='native'")
    history: List[float] = []
    it_count = [0]

    lower = np.asarray(lower, np.float64)
    upper = np.asarray(upper, np.float64)
    rng = upper - lower
    rng = np.where(rng > 0, rng, 1.0)

    def to_phys(z):
        return lower + z * rng

    def fun(z):
        L, g = loss_and_grad(to_phys(z))
        history.append(L)
        return L, np.asarray(g, np.float64) * rng

    def cb(zk):
        it_count[0] += 1
        if callback is not None:
            callback(it_count[0], to_phys(np.asarray(zk)))

    z0 = (np.clip(np.asarray(x0, np.float64), lower, upper) - lower) / rng
    res = minimize(
        fun, z0, jac=True, method="L-BFGS-B",
        bounds=[(0.0, 1.0)] * z0.shape[0], callback=cb,
        options=dict(ftol=ftol, maxcor=m, maxls=max_linesearch,
                     gtol=gtol, maxiter=maxiter))
    return LbfgsResult(x=to_phys(res.x), loss=float(res.fun),
                       n_iters=int(res.nit),
                       n_evals=int(res.nfev), converged=bool(res.success),
                       message=str(res.message), loss_history=history)


@dataclasses.dataclass
class PopulationResult:
    """Outcome of a lockstep multi-start run: per-candidate endpoints plus
    the winner repackaged as a standard LbfgsResult."""
    X: np.ndarray            # (P, D) final iterates
    losses: np.ndarray       # (P,) final losses
    messages: List[str]
    n_iters: np.ndarray      # (P,) accepted steps per candidate
    converged: np.ndarray    # (P,) bool
    n_outer: int
    n_batched_evals: int
    best: LbfgsResult = None


def minimize_lbfgsb_population(batched_loss_and_grad, X0, lower, upper, *,
                               ftol: float = 1e-6, m: int = 10,
                               max_linesearch: int = 20,
                               gtol: float = 1e-10, maxiter: int = 100,
                               callback=None) -> PopulationResult:
    """P independent projected L-BFGS-B instances advanced in LOCKSTEP:
    every objective evaluation in the outer loop and in the backtracking
    ladder is ONE batched (P, D) call, so a whole population costs about
    the wall-clock of a single optimization (the reference's serial random
    restarts + per-restart L-BFGS, OptimizeHelper.cpp:316-359 +
    BackwardTaskSolver.cpp:22-66, collapsed onto batched episodes).

    Same per-candidate math as minimize_lbfgsb_native (two-loop recursion,
    projected-arc Armijo ladder, reference ftol criterion); candidates
    that fail their linesearch or converge freeze while the rest continue
    (their rows still ride along in the batch — a frozen row re-evaluates
    its current point, which costs nothing extra on device)."""
    X0 = np.atleast_2d(np.asarray(X0, np.float64))
    P, D = X0.shape
    lower = np.asarray(lower, np.float64)
    upper = np.asarray(upper, np.float64)
    rngv = np.where(upper - lower > 0, upper - lower, 1.0)

    n_evals = 0

    def fun(Z):
        nonlocal n_evals
        n_evals += 1
        L, G = batched_loss_and_grad(lower[None] + Z * rngv[None])
        return np.asarray(L, np.float64), np.asarray(G, np.float64) * rngv

    Z = (np.clip(X0, lower, upper) - lower) / rngv
    F, G = fun(Z)
    S = [[] for _ in range(P)]
    Y = [[] for _ in range(P)]
    rho = [[] for _ in range(P)]
    frozen = np.zeros(P, bool)
    conv = np.zeros(P, bool)
    msgs = ["max iterations reached"] * P
    iters = np.zeros(P, int)
    n_outer = 0
    for it in range(maxiter):
        if frozen.all():
            break
        n_outer += 1
        Dirs = np.zeros((P, D))
        ladders: List[List[float]] = []
        for p in range(P):
            if frozen[p]:
                ladders.append([])
                continue
            d = -_two_loop(G[p], S[p], Y[p], rho[p])
            if np.dot(d, G[p]) > -1e-15:
                S[p].clear(); Y[p].clear(); rho[p].clear()
                d = -G[p]
            Dirs[p] = d
            d_inf = np.linalg.norm(d, np.inf)
            alpha0 = 1.0 if S[p] else min(1.0, 0.1 / max(d_inf, 1e-30))
            lad = [alpha0 * (0.25 ** k) for k in range(max_linesearch - 4)]
            lad += [alpha0 * (4.0 ** k) for k in range(1, 5)
                    if alpha0 * (4.0 ** k) * d_inf <= 1.0]
            ladders.append(lad)
        accepted = frozen.copy()
        Zn, Fn, Gn = Z.copy(), F.copy(), G.copy()
        max_rungs = max((len(l) for l in ladders), default=0)
        for k in range(max_rungs):
            todo = ~accepted
            if not todo.any():
                break
            Zt = Z.copy()
            sn = np.zeros(P)
            valid = np.zeros(P, bool)
            for p in np.where(todo)[0]:
                if k >= len(ladders[p]):
                    continue
                zt = np.clip(Z[p] + ladders[p][k] * Dirs[p], 0.0, 1.0)
                step = zt - Z[p]
                s = np.dot(G[p], step)
                if s >= 0 or not np.any(step):
                    continue
                Zt[p] = zt
                sn[p] = s
                valid[p] = True
            if not valid.any():
                continue
            Ft, Gt = fun(Zt)
            acc_now = valid & np.isfinite(Ft) & (Ft <= F + 1e-4 * sn)
            for p in np.where(acc_now)[0]:
                Zn[p], Fn[p], Gn[p] = Zt[p], Ft[p], Gt[p]
            accepted |= acc_now
        failed = ~accepted & ~frozen
        for p in np.where(failed)[0]:
            msgs[p] = "linesearch failed"
            conv[p] = bool(np.linalg.norm(
                np.clip(Z[p] - G[p], 0.0, 1.0) - Z[p], np.inf)
                <= max(gtol, 1e-8))
        frozen |= failed
        moved = accepted & ~frozen
        for p in np.where(moved)[0]:
            s, y = Zn[p] - Z[p], Gn[p] - G[p]
            sy = np.dot(s, y)
            if sy > 1e-10 * np.linalg.norm(s) * np.linalg.norm(y):
                S[p].append(s); Y[p].append(y); rho[p].append(1.0 / sy)
                if len(S[p]) > m:
                    S[p].pop(0); Y[p].pop(0); rho[p].pop(0)
            iters[p] += 1
            df = F[p] - Fn[p]
            if df <= ftol * max(1.0, abs(Fn[p]), abs(F[p])):
                frozen[p] = True
                conv[p] = True
                msgs[p] = "relative reduction of f <= ftol"
            elif np.linalg.norm(np.clip(Zn[p] - Gn[p], 0.0, 1.0) - Zn[p],
                                np.inf) <= gtol:
                frozen[p] = True
                conv[p] = True
                msgs[p] = "projected gradient <= gtol"
        Z, F, G = Zn, Fn, Gn
        if callback is not None:
            callback(it + 1, lower[None] + Z * rngv[None], F)
    Xf = lower[None] + Z * rngv[None]
    b = int(np.argmin(F))
    best = LbfgsResult(x=Xf[b], loss=float(F[b]), n_iters=int(iters[b]),
                       n_evals=n_evals, converged=bool(conv[b]),
                       message=msgs[b], loss_history=[float(F[b])])
    return PopulationResult(X=Xf, losses=F, messages=msgs, n_iters=iters,
                            converged=conv, n_outer=n_outer,
                            n_batched_evals=n_evals, best=best)
