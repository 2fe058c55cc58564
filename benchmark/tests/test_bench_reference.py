"""The plain reference against the program's CPU path (the route every
kernel wrapper takes on CPU tensors) on a tiny folded grid in f64: the
same rollout, and the same gradient through the reference's step-by-step
adjoint as through the program's chunked value-and-grad."""
import numpy as np
import torch

from benchmark import check
from benchmark import traffic as tr
from benchmark.reference import judge
from benchmark.reference import scene as rscene


# an 8 x 8 grid in a sinusoidal wind, two corners attached, self-collision
# on, 6 steps; the wind's five parameters are fitted
FOLDED_WIND = {
    "dtype": "float32",
    "scene": {
        "fabric": {"cloth_dim_x": 6, "cloth_dim_y": 6,
                   "k_stiff_stretching": 550, "k_stiff_bending": 0.01,
                   "grid_num_x": 8, "grid_num_y": 8, "density": 0.124,
                   "name": "folded_wind_grid"},
        "orientation": "FRONT", "attachment_points": "LEFT_RIGHT_CORNERS_2",
        "trajectory": "NO_TRAJECTORY", "primitive_config": "NONE",
        "wind_config": "WIND_SIN", "scene_bbox": [[-7, -7, -7], [7, 7, 7]],
        "time_step": 1 / 90, "step_num": 6,
        "forward_convergence_thresh": 1e-8,
        "backward_convergence_thresh": 5e-4, "name": "folded_wind_grid"},
    "flags": {"wind_enabled": True, "contact_enabled": True,
              "self_collision_enabled": True},
    "sim": {},
    "population": 2,
    "vector": [["wind", 0], ["wind", 1], ["wind", 2], ["wind_freq", None],
               ["wind_phase", None]],
    "base": {"wind": [0.04, 0.004, 0.04], "wind_freq": 10.0,
             "wind_phase": 0.5},
    "candidates": {"kind": "normal", "field": "wind", "sigma": 0.02,
                   "clip": [-0.1, 0.1]},
}


def test_reference_follows_the_programs_cpu_path():
    from diffcloth_tpu_torch import config as pc
    from diffcloth_tpu_torch import losses
    from diffcloth_tpu_torch.core.sim import ClothSim
    from diffcloth_tpu_torch.geometry import builder as gb
    torch.set_num_threads(2)
    cfg = FOLDED_WIND
    sim, scene = rscene.reference_sim(cfg, device="cpu")
    x0 = rscene.starts(scene, "fold_even", 2)
    defaults = {k: v.numpy() for k, v in sim.default_params().items()}
    X = tr.candidates(cfg, 7, 0, tr.base_vector(cfg, defaults))
    p = judge.batched_params(sim, cfg["base"],
                             check.fields_of(cfg, X, defaults), x0)
    ref = sim.rollout(p).steps
    assert int(ref.selfcol_pairs.sum()) > 0

    psim = ClothSim(gb.build_scene(rscene.scene_config(pc, cfg["scene"])),
                    flags=pc.SimFlags(**cfg["flags"]), device="cpu",
                    dtype=torch.float64,
                    eps_forward=sim.eps_forward)
    pp = type(psim.default_params())(**{
        f: torch.as_tensor(v.numpy(), dtype=torch.float64)
        for f, v in p.items()})
    prog = psim.rollout(pp).steps
    assert torch.equal(prog.x, ref.x) and torch.equal(prog.v, ref.v)

    target = np.concatenate([x0[:, None], ref.x.numpy() + 0.01], 1)
    loss_fn = losses.make_loss_fn(pc.LossType.MATCH_TRAJECTORY,
                                  losses.LossInfo(target_x=torch.as_tensor(
                                      target)))
    X_, V_ = ref.x.numpy(), ref.v.numpy()
    # the program's own cotangents on each state, as the harness keeps them
    from benchmark.program import CotangentWatch
    watch = CotangentWatch(psim, 2)
    watch.episodes = torch.arange(2)
    L, g = psim.episode_value_and_grad_chunked(loss_fn, 3, batched=True)(pp)
    LX, LV = watch.take()
    L_ref, G_ref, gaps, num, lam = judge.adjoint_steps(
        sim, p, X_, V_, LX, LV, target, cfg["vector"])
    chain = check.cotangent_gaps(num, lam)
    G = np.stack([g.wind[:, 0], g.wind[:, 1], g.wind[:, 2], g.wind_freq,
                  g.wind_phase], 1)
    assert np.abs(G - G_ref).max() <= 1e-9 * np.abs(G_ref).max()
    assert np.abs(L.numpy() - L_ref).max() <= 1e-12
    assert gaps.max() <= 1e-12 and chain.max() <= 1e-9
