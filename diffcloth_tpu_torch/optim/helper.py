"""Parameter-vector packing, bounds, random restarts and the optimization
objective: the reference `OptimizeHelper` (OptimizeHelper.{h,cpp}).

Counterpart of `diffcloth_tpu/optim/helper.py`.  A `GradMask` (reference
`BackwardTaskInformation`, Simulation.h:188-209) selects which entries of
`SimParams` the box-constrained optimizer sees; packing order and bounds
mirror `OptimizeHelper::setParameterBounds` (OptimizeHelper.cpp:47-171).
Vectors are numpy f64 on the host; episodes run on the sim's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from diffcloth_tpu_torch.core.types import SimParams
from diffcloth_tpu_torch.utils import timing as tm

# per-type stiffness bounds [spring, attach, stretch, bend]
# (OptimizeHelper.cpp:81-84)
STIFFNESS_BOUNDS = [(0.0, 200.0), (63.0, 10000.0), (80.0, 1500.0), (1e-7, 5.0)]


@dataclasses.dataclass(frozen=True)
class GradMask:
    """Which parameters the task optimizes (BackwardTaskInformation)."""
    k_pertype: Tuple[bool, bool, bool, bool] = (False, False, False, False)
    density: bool = False
    f_ext: bool = False          # constant wind vector (3)
    f_wind: bool = False         # sinusoidal wind 5-vector
    x0: bool = False
    force_field: bool = False
    wind_perstep: bool = False
    control_points: bool = False
    mu_primitives: Tuple[int, ...] = ()


@dataclasses.dataclass
class _Slot:
    name: str
    path: str                # SimParams field
    index: tuple             # index into the field, () for a scalar
    lo: float
    hi: float


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


class OptimizeHelper:
    """Flat parameter vector <-> SimParams, with bounds and restarts.

    reference: OptimizeHelper.cpp - paramInfoToVecXd (:179-246),
    vecXdToParamInfo (:361-420), parameterFromRandSeed (:316-359),
    getRandomParam (:445-488), operator() (:535-573).

    `param_base` holds the fields the optimizer does not touch.  A batched
    base (B episodes) gives the population evaluations of
    `batched_loss` / `batched_loss_and_grad` (B candidates) one base
    episode each, e.g. each its own initial state.

    `chunked` (None: past 250 steps or 2000 vertices, the JAX helper's
    rule, helper.py:66-76) routes `loss` / `loss_and_grad` through the
    sim's chunked episode functions, `chunk` steps per chunk; the
    population evaluations always take them (helper.py:253-279)."""

    def __init__(self, sim, mask: GradMask, loss_fn,
                 param_base: Optional[SimParams] = None,
                 chunked: Optional[bool] = None, chunk: int = 50):
        self.sim = sim
        self.mask = mask
        self.loss_fn = loss_fn
        self.base = param_base if param_base is not None else \
            sim.default_params()
        self._one = (self.base.sample(0) if self.base.batch_size is not None
                     else self.base)
        self._slots: List[_Slot] = []
        self._build_slots()
        if chunked is None:
            chunked = sim.n_steps > 250 or sim.n > 2000
        self.chunked, self.chunk = chunked, chunk
        if chunked:
            self._vg = sim.episode_value_and_grad_chunked(loss_fn, chunk)
            self._loss_eval = sim.episode_loss_chunked(loss_fn, chunk)
        else:
            self._vg = sim.episode_value_and_grad(loss_fn)
            self._loss_eval = sim.episode_loss(loss_fn)
        self._batched_vg = sim.episode_value_and_grad_chunked(
            loss_fn, chunk, batched=True)
        self._batched_loss_eval = sim.episode_loss_chunked(
            loss_fn, chunk, batched=True)
        self._last_vg = self._vg
        self.eval_count = 0
        self.history: List[Tuple[float, np.ndarray]] = []

    # -------------------------------------------------------------- layout

    def _build_slots(self):
        s = self._slots
        bbox = self.sim.cfg.scene_bbox
        if self.mask.f_wind:
            for i in range(3):
                s.append(_Slot("windForce", "wind", (i,), -0.1, 0.1))
            s.append(_Slot("windFreq", "wind_freq", (), 0.01, 15.0))
            s.append(_Slot("windPhase", "wind_phase", (), -5.0, 5.0))
        if self.mask.f_ext:
            for i in range(3):
                s.append(_Slot("windDir", "wind", (i,), -3.0, 3.0))
        if self.mask.wind_perstep:
            # the reference declares no bounds for this group
            # (OptimizeHelper.cpp:351-353); the sinusoidal factor it
            # replaces lives in [0, 1], so allow [-2, 2]
            for t in range(int(self._one.wind_perstep.shape[0])):
                s.append(_Slot("windFactorPerStep", "wind_perstep", (t,),
                               -2.0, 2.0))
        if self.mask.x0:
            for p in range(self.sim.n):
                for d in range(3):
                    s.append(_Slot("x0", "x0", (p, d), bbox.lo[d],
                                   bbox.hi[d]))
        if self.mask.force_field:
            for p in range(self.sim.n):
                for d in range(3):
                    s.append(_Slot("forceField", "force_field", (p, d),
                                   -10.0, 10.0))
        for t in range(4):
            if self.mask.k_pertype[t]:
                lo, hi = STIFFNESS_BOUNDS[t]
                s.append(_Slot(f"k[{t}]", "k_pertype", (t,), lo, hi))
        if self.mask.density:
            s.append(_Slot("density", "density", (), 0.01, 1.0))
        if self.mask.control_points:
            # ENDPOINT_AND_TANGENTS: per fixed point (p1, m0, m1); p1 in the
            # scene bbox, tangents in [-50, 50] (Spline.h:99-105)
            F = self._one.spline.shape[0]
            for f in range(F):
                for d in range(3):
                    s.append(_Slot("spline_p1", "spline", (f, d),
                                   bbox.lo[d], bbox.hi[d]))
                for j in range(3, 9):
                    s.append(_Slot("spline_m", "spline", (f, j), -50.0,
                                   50.0))
        for prim_id in self.mask.mu_primitives:
            s.append(_Slot(f"mu[{prim_id}]", "mu", (prim_id,), 0.01, 0.95))

    @property
    def n_params(self) -> int:
        return len(self._slots)

    @property
    def lower_bound(self) -> np.ndarray:
        return np.array([sl.lo for sl in self._slots])

    @property
    def upper_bound(self) -> np.ndarray:
        return np.array([sl.hi for sl in self._slots])

    # ------------------------------------------------------------- packing

    def params_to_vec(self, params: SimParams) -> np.ndarray:
        """A single SimParams (or its gradient) -> the packed vector."""
        leaves = {}
        x = np.zeros(self.n_params)
        for i, sl in enumerate(self._slots):
            if sl.path not in leaves:
                leaves[sl.path] = _host(getattr(params, sl.path))
            x[i] = leaves[sl.path][sl.index]
        return x

    def vec_to_params(self, x: np.ndarray,
                      base: Optional[SimParams] = None) -> SimParams:
        base = self._one if base is None else base
        updates = {}
        for i, sl in enumerate(self._slots):
            if sl.path not in updates:
                updates[sl.path] = _host(getattr(base, sl.path))
            updates[sl.path][sl.index] = x[i]
        dev, dt = self.sim.device, self.sim.dtype
        return base.replace(**{k: torch.as_tensor(v).to(dev, dt)
                               for k, v in updates.items()})

    @property
    def last_split(self):
        """Forward and backward wall seconds of the last gradient call."""
        return self._last_vg.split

    def grads_to_vec(self, grads: SimParams) -> np.ndarray:
        return self.params_to_vec(grads)

    # ------------------------------------------------------------ restarts

    def random_param(self, seed: int) -> np.ndarray:
        """Bounded random restart with the reference's validity fixups
        (OptimizeHelper.cpp:316-359, 445-488).  numpy RNG instead of C
        rand(): same distribution, different stream."""
        rng = np.random.RandomState(seed)
        while True:
            u = rng.uniform(0.0, 1.0, self.n_params)
            x = self.lower_bound + u * (self.upper_bound - self.lower_bound)
            params = self.vec_to_params(x)
            dev, dt = self.sim.device, self.sim.dtype
            if self.mask.control_points:
                # all splines share one random endpoint translation
                # (OptimizeHelper.cpp:324-339)
                base_sp = _host(self._one.spline)
                delta = _host(params.spline)[0, 0:3] - base_sp[0, 0:3]
                p0 = _host(self.sim.stage_dev.spline_p0)
                yup = _host(self.sim.stage_dev.spline_yup)
                p1 = base_sp[:, 0:3] + delta[None, :]
                d = p1 - p0
                up = np.zeros_like(d)
                up[:, 1] = yup
                sp = np.concatenate([p1, d + up, d - up], axis=1)
                params = params.replace(spline=torch.as_tensor(sp).to(dev,
                                                                      dt))
            if self.mask.f_ext or self.mask.f_wind:
                cap = 1.0 if self.mask.f_ext else 2.0
                w = _host(params.wind)
                norm = np.linalg.norm(w)
                if norm > cap:
                    params = params.replace(
                        wind=torch.as_tensor(w * (cap / norm)).to(dev, dt))
            x = self.params_to_vec(params)
            if np.all(x >= self.lower_bound - 1e-12) and \
                    np.all(x <= self.upper_bound + 1e-12):
                return x

    # ----------------------------------------------------------- objective

    def loss(self, x: np.ndarray) -> float:
        """Forward-only loss (restart filtering, reporting)."""
        return float(self._loss_eval(self.vec_to_params(x)))

    def loss_and_grad(self, x: np.ndarray) -> Tuple[float, np.ndarray]:
        L, grads = self._vg(self.vec_to_params(x))
        self._last_vg = self._vg
        self.eval_count += 1
        self.history.append((float(L), np.array(x)))
        return float(L), self.grads_to_vec(grads)

    # ------------------------------------------------- population (batched)

    @property
    def can_batch(self) -> bool:
        """A batch shares one prefactorization, so candidates that change P
        (stiffness or density) cannot share a batched episode."""
        return not (any(self.mask.k_pertype) or self.mask.density)

    def stack_vecs(self, X: np.ndarray) -> SimParams:
        """(P, D) candidate vectors -> SimParams with a leading batch dim
        on every field (row i on base episode i when the base is batched)."""
        X = np.asarray(X)
        batched = self.base.batch_size is not None
        if batched and self.base.batch_size != X.shape[0]:
            raise ValueError(f"{X.shape[0]} candidates for a base of "
                             f"{self.base.batch_size} episodes")
        plist = [self.vec_to_params(x, self.base.sample(i) if batched
                                    else None) for i, x in enumerate(X)]
        return SimParams(**{k: torch.stack([getattr(p, k) for p in plist])
                            for k, _ in plist[0].items()})

    def batched_loss(self, X: np.ndarray) -> np.ndarray:
        """(P, D) -> (P,) losses from one batched chunked forward episode
        (the restart filter)."""
        return _host(self._batched_loss_eval(self.stack_vecs(X)))

    def batched_loss_and_grad(self, X: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """(P, D) -> ((P,), (P, D)): one batched chunked episode
        value-and-grad over the whole population (the lockstep multi-start
        L-BFGS inner loop, optim.lbfgsb.minimize_lbfgsb_population).  An
        `evaluate` span of the tracer (`utils/timing.py`), with `pack`,
        `value_and_grad` and `unpack` inside."""
        if not self.can_batch:
            raise ValueError("population evaluation shares one "
                             "prefactorization: stiffness/density cannot "
                             "vary across candidates")
        with tm.span("evaluate"):
            with tm.span("pack"):
                params = self.stack_vecs(X)
            with tm.span("value_and_grad"):
                L, grads = self._batched_vg(params)
            self._last_vg = self._batched_vg
            with tm.span("unpack"):
                L = _host(L)
                P = L.shape[0]
                G = np.stack([self.grads_to_vec(grads.sample(i))
                              for i in range(P)])
        self.eval_count += P
        self.history.extend((float(l), np.array(x)) for l, x in zip(L, X))
        return L, G
