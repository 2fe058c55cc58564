"""Task loss library: all eight reference loss types as differentiable
functions of the stacked episode records.

Counterpart of `diffcloth_tpu/losses.py` (reference
`Simulation::calculateLossAndGradient`, Simulation.cpp:3238-3488).  Each
loss is a plain PyTorch function of the records, and autograd carries the
per-frame cotangents into the episode's reverse pass.  Records may carry a
leading batch dim (B episodes): every loss then returns (B,) losses.
Targets may be numpy arrays or tensors, with or without the batch dim.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from benchmark.reference.config import LossType
from benchmark.reference.types import EpisodeRecords


@dataclasses.dataclass(frozen=True)
class LossInfo:
    """reference: Simulation.h LossInfo (:247-256)."""
    target_x: Optional[Any] = None          # ([B,] N+1, n, 3)
    target_v: Optional[Any] = None          # ([B,] N+1, n, 3)
    target_frame_shape: Tuple[Tuple[int, Any], ...] = ()
    target_translation: Optional[Any] = None  # (3,)
    x_init: Optional[Any] = None            # (n,3) for WITH_TRANSLATION
    target_twirl_height: float = 0.0
    loop_points: Optional[Any] = None       # (L,) int
    rest_min: Optional[Any] = None
    rest_max: Optional[Any] = None
    rest_mid: Optional[Any] = None
    # ASSISTED_DRESSING_KEYPOINTS: per keypoint (frame_idx, target_pos,
    # candidate particle indices padded to equal length with -1)
    keypoint_frames: Optional[Any] = None   # (K,) int
    keypoint_targets: Optional[Any] = None  # (K,3)
    keypoint_candidates: Optional[Any] = None  # (K,C) int, -1 pad
    # tau > 0 replaces the hard max over candidates with a softmax-weighted
    # mean (temperature tau, units of squared distance); tau = 0 is the
    # reference's loss (Simulation.cpp:3440-3475)
    keypoint_tau: float = 0.0


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    """a as a tensor of ref's dtype on ref's device."""
    return torch.as_tensor(a, device=ref.device).to(ref.dtype)


def _index(a, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=ref.device).long()


def _frame(x: torch.Tensor, i) -> torch.Tensor:
    """Frame(s) i of stacked (..., N, n, 3) records."""
    return x[..., i, :, :]


def _sq(d: torch.Tensor, dims) -> torch.Tensor:
    return torch.sum(d * d, dim=dims)


def match_trajectory(recs: EpisodeRecords, info: LossInfo):
    """L = 1/(N*n) sum_i |x_i - x*_i|^2 over frames 0..N
    (Simulation.cpp:3247-3278); frame 0 compares the (possibly optimized)
    initial positions."""
    x = recs.steps.x
    N, n = x.shape[-3] + 1, x.shape[-2]
    tgt = _like(info.target_x, x)
    return (_sq(x - tgt[..., 1:, :, :], (-3, -2, -1))
            + _sq(recs.x0 - _frame(tgt, 0), (-2, -1))) / (N * n)


def match_velocity(recs: EpisodeRecords, info: LossInfo):
    """Simulation.cpp:3280-3311."""
    v = recs.steps.v
    N, n = v.shape[-3] + 1, v.shape[-2]
    tgt = _like(info.target_v, v)
    return (_sq(v - tgt[..., 1:, :, :], (-3, -2, -1))
            + _sq(recs.v0 - _frame(tgt, 0), (-2, -1))) / (N * n)


def match_trajectory_max(recs: EpisodeRecords, info: LossInfo):
    """Max-over-frames variant (Simulation.cpp:3313-3341)."""
    x = recs.steps.x
    n = x.shape[-2]
    tgt = _like(info.target_x, x)
    per_frame = _sq(x - tgt[..., 1:, :, :], (-2, -1)) / n
    d0 = _sq(recs.x0 - _frame(tgt, 0), (-2, -1)) / n
    return torch.maximum(torch.amax(per_frame, dim=-1), d0)


def dress_angle(recs: EpisodeRecords, info: LossInfo):
    """Twirl-height loss on the dress hem loop points
    (Simulation.cpp:3343-3376)."""
    x = recs.steps.x
    lo, hi = _like(info.rest_min, x), _like(info.rest_max, x)
    target_h = lo[1] + (hi[1] - lo[1]) * info.target_twirl_height
    loop = _index(info.loop_points, x)
    dy = _frame(x, -1)[..., loop, 1] - target_h
    return torch.sum(dy * dy, dim=-1) / loop.shape[0]


def matchshape_translation_invariant(recs: EpisodeRecords, info: LossInfo):
    """Translation-free last-frame shape match (Simulation.cpp:3378-3402)."""
    x = recs.steps.x
    n = x.shape[-2]
    tgt = _like(info.target_x, x)
    if tgt.dim() == 3:
        tgt = tgt[-1]
    tgt = tgt - tgt[0:1]
    last = _frame(x, -1)
    cur = last - last[..., 0:1, :]
    return _sq(cur - tgt, (-2, -1)) / n


def multistep_matchshape(recs: EpisodeRecords, info: LossInfo):
    """Per-chosen-frame shape targets (Simulation.cpp:3404-3420)."""
    x = recs.steps.x
    n = x.shape[-2]
    loss = 0.0
    for frame_idx, shape in info.target_frame_shape:
        cur = recs.x0 if frame_idx == 0 else _frame(x, frame_idx - 1)
        loss = loss + _sq(cur - _like(shape, x), (-2, -1)) / n
    return loss


def matchshape_with_translation(recs: EpisodeRecords, info: LossInfo):
    """x_target = x_init + translation, matched at the last frame
    (Simulation.cpp:3422-3438)."""
    x = recs.steps.x
    n = x.shape[-2]
    tgt = _like(info.x_init, x) + _like(info.target_translation, x)[None, :]
    return _sq(_frame(x, -1) - tgt, (-2, -1)) / n


def assisted_dressing_keypoints(recs: EpisodeRecords, info: LossInfo):
    """Max-distance keypoint matching (Simulation.cpp:3440-3475): for each
    (frame, target, candidate set), penalize the farthest candidate.
    Keypoint frames are >= 1 in the demos."""
    x = recs.steps.x
    frames = _index(info.keypoint_frames, x)
    cand = _index(info.keypoint_candidates, x)             # (K, C)
    K = frames.shape[0]
    valid = cand >= 0
    pos = _frame(x, frames - 1)[..., torch.arange(K, device=x.device)[:, None],
                                cand.clamp(min=0), :]      # (..., K, C, 3)
    tgt = _like(info.keypoint_targets, x)                  # (K, 3)
    d2 = torch.sum((pos - tgt[:, None, :]) ** 2, dim=-1)   # (..., K, C)
    d2 = torch.where(valid, d2, -torch.inf)
    if info.keypoint_tau > 0.0:
        w = torch.softmax(d2 / info.keypoint_tau, dim=-1)  # pads weigh 0
        return torch.sum(w * torch.where(valid, d2, 0.0), dim=(-2, -1)) / K
    return torch.sum(torch.amax(d2, dim=-1), dim=-1) / K


_DISPATCH = {
    LossType.MATCH_TRAJECTORY: match_trajectory,
    LossType.MATCH_VELOCITY: match_velocity,
    LossType.MATCH_TRAJECTORY_MAX: match_trajectory_max,
    LossType.DRESS_ANGLE: dress_angle,
    LossType.MATCHSHAPE_TRANSLATION_INVARIANT:
        matchshape_translation_invariant,
    LossType.MULTISTEP_MATCHSHAPE: multistep_matchshape,
    LossType.MATCHSHAPE_WITH_TRANSLATION: matchshape_with_translation,
    LossType.ASSISTED_DRESSING_KEYPOINTS: assisted_dressing_keypoints,
}


def make_loss_fn(loss_type: LossType, info: LossInfo
                 ) -> Callable[[EpisodeRecords], torch.Tensor]:
    fn = _DISPATCH[loss_type]
    return lambda recs: fn(recs, info)
