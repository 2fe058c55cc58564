"""How far each package's f32 tensor-parallel objective stands from its own
plain objective, per gradient class, on tests/test_torch_parallel.py's
contact scene (the flagship stand-in's physics on an 8 x 8 grid started
folded half over half, B = 4, 3 steps).  A measurement, not a test (not
collected):

    python tests/tp_f32_gap.py

The JAX package: `parallel/mesh.batched_value_and_grad` on a dp = 2 x
tp = 2 mesh of four host devices against the unsharded vmap of the same
per-episode value-and-grad, averaged over the batch.  The port: the same
objective on four gloo ranks (tests/torch_parallel_worker.py) against the
unsharded `ClothSim.episode_value_and_grad`, averaged.  Prints, per class,
max |tp - plain| over the plain gradient's largest entry, for each
package, and the f64 gaps beside them (f64 rounding).
"""
import os
import sys
import tempfile
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import torch_parallel_worker as worker  # noqa: E402
from test_torch_parallel import (jax_contact_population,  # noqa: E402
                                 jax_contact_sim, jax_mesh_objective)

WORLD = 4


def jax_plain(dtype):
    """The JAX package's unsharded batched objective (vmap), averaged."""
    sim = jax_contact_sim(dtype, tp=False)
    base, params, loss_fn = jax_contact_population(sim)
    p_inv = sim.p_inv(base)

    def per_sample(p):
        return loss_fn(sim.simulate(p, p_inv, sim.x_fixed_seq(p)))
    L, g = jax.vmap(jax.value_and_grad(per_sample))(params)
    return np.asarray(L), {k: np.asarray(v).mean(axis=0)
                           for k, v in g._asdict().items()}


def port_plain(dtype):
    """The port's unsharded batched objective, averaged over the batch."""
    sim = worker.scene_sim("contact", dtype)
    _, params = worker.scene_population("contact", sim)
    L, g = sim.episode_value_and_grad(worker.loss_fn(sim))(params)
    return L.numpy(), {k: v.mean(dim=0).numpy() for k, v in g.items()
                       if v is not None}


def port_tp(cases):
    """The port's dp = 2 x tp = 2 objective on four gloo ranks."""
    with tempfile.TemporaryDirectory() as out:
        mp.spawn(worker.run, args=(WORLD, os.path.join(out, "init"), out,
                                   cases), nprocs=WORLD, join=True)
        with np.load(os.path.join(out, "port_parallel.npz")) as z:
            return {k: z[k] for k in z.files}


def gaps(plain, tp):
    """{class: max |tp - plain| / max |plain|} over the nonzero classes."""
    out = {}
    for k, ref in plain.items():
        scale = float(np.abs(ref).max())
        if scale > 0:
            out[k] = float(np.abs(tp[k] - ref).max()) / scale
    return out


def main():
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    cases = (("contact", "float32"), ("contact", "float64"))
    port = port_tp(cases)
    rows = {}
    for name, jdt, tdt in (("float32", jnp.float32, torch.float32),
                           ("float64", jnp.float64, torch.float64)):
        jL, jg = jax_plain(jdt)
        tL, tg = jax_mesh_objective(jdt, tp=True)
        pL, pg = port_plain(tdt)
        prefix = worker.key_prefix("contact", name) + "dp_tp_"
        ptp = {k: port[prefix + k] for k in pg}
        rows[name] = (gaps(jg, tg), gaps(pg, ptp),
                      float(np.abs(tL - jL).max() / np.abs(jL).max()),
                      float(np.abs(port[prefix + "losses"] - pL).max()
                            / np.abs(pL).max()))
    print("max |tp - plain| / max |plain|, contact scene (8 x 8 folded, "
          "B = 4, 3 steps), dp = 2 x tp = 2 against the unsharded batch:")
    for name, (jgap, pgap, jl, pl) in rows.items():
        print(f"  {name}: losses JAX {jl:.2e}, port {pl:.2e}")
        for k in sorted(set(jgap) | set(pgap)):
            print(f"    {k:12s} JAX {jgap.get(k, float('nan')):.2e}  "
                  f"port {pgap.get(k, float('nan')):.2e}")
    print(f"({time.perf_counter() - t0:.0f} s)")


if __name__ == "__main__":
    main()
