"""Episode export / re-import: OBJ frame sequences and their metadata.

Counterpart of `diffcloth_tpu/io/export.py`, in the same folder format
(reference `exportSimulation` + `exportFrameInfo`, Simulation.cpp
:4195-4239, `exportStatistics` :4003, `resetForwardRecordsFromFolder`,
Simulation.h:574-620):

    clothXXX.obj   per-frame mesh (frame 0 = the initial state)
    infoXXX.txt    per-frame clip positions, one 'x y z' per line
    episode.json   converged / iters / deformation per step + extra stats

Records may live on the card; they are copied to the host once.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from diffcloth_tpu_torch.geometry import objio


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def export_frame_info(path: str, x_fixed: np.ndarray,
                      extra: Optional[Dict] = None) -> None:
    """A frame's info.txt: one 'x y z' clip position per line, then an
    optional JSON trailer line."""
    lines = [f"{p[0]:.10f} {p[1]:.10f} {p[2]:.10f}"
             for p in _host(x_fixed).reshape(-1, 3)]
    if extra:
        lines.append(json.dumps(extra))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def export_episode(folder: str, recs, tris: np.ndarray,
                   stats: Optional[Dict] = None) -> None:
    """Export one episode's EpisodeRecords (not batched) to `folder/`."""
    if recs.batched:
        raise ValueError("export_episode takes one episode's records; "
                         "export a batch sample by sample")
    os.makedirs(folder, exist_ok=True)
    xs = _host(recs.full_x())
    xf = _host(recs.steps.x_fixed)
    tris = np.asarray(tris)
    for i, x in enumerate(xs):
        objio.save_obj(os.path.join(folder, f"cloth{i}.obj"), x, tris)
        fixed = xf[i - 1] if i > 0 else (xf[0] if len(xf) else
                                         np.zeros((0, 3)))
        export_frame_info(os.path.join(folder, f"info{i}.txt"), fixed)
    st = recs.steps
    log = {
        "n_frames": int(xs.shape[0]),
        "converged": _host(st.converged).astype(int).tolist(),
        "iters": _host(st.iters).astype(int).tolist(),
        "avg_deformation": _host(st.avg_deformation).astype(float).tolist(),
        "max_deformation": _host(st.max_deformation).astype(float).tolist(),
    }
    if stats:
        log.update(stats)
    with open(os.path.join(folder, "episode.json"), "w") as fh:
        json.dump(log, fh, indent=1)


def import_episode(folder: str):
    """Re-import an exported episode folder for replay: (xs (N+1, n, 3),
    tris (T, 3), the episode.json dict or None), the input of
    `io.viewer.render_episode`."""
    xs = objio.import_frames(folder, prefix="cloth")
    files = sorted(f for f in os.listdir(folder)
                   if f.startswith("cloth") and f.endswith(".obj"))
    _, tris = objio.load_obj(os.path.join(folder, files[0]))
    info = None
    meta = os.path.join(folder, "episode.json")
    if os.path.exists(meta):
        with open(meta) as fh:
            info = json.load(fh)
    return xs, tris, info
