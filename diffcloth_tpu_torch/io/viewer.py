"""Offline trajectory viewer: render exported episodes to PNG / GIF.

Counterpart of `diffcloth_tpu/io/viewer.py` (the reference's OpenGL
Viewer, src/code/engine/Viewer.cpp, replaced by offline rendering); pairs
with `io.export.import_episode` for `--mode visualize --exp NAME`
(reference main.cpp:33-45).  Takes host numpy arrays.  matplotlib is
imported inside the functions, so nothing else in the port needs it.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def _setup_axes(ax, xs: np.ndarray, title: str):
    lo = xs.reshape(-1, 3).min(axis=0)
    hi = xs.reshape(-1, 3).max(axis=0)
    c = (lo + hi) / 2
    r = float((hi - lo).max()) / 2 + 1e-6
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[2] - r, c[2] + r)
    ax.set_zlim(c[1] - r, c[1] + r)
    ax.set_title(title)
    ax.set_box_aspect((1, 1, 1))


def render_frame(x: np.ndarray, tris: np.ndarray,
                 out_path: Optional[str] = None,
                 x_fixed: Optional[np.ndarray] = None,
                 obstacles: Optional[Sequence[Tuple[str, np.ndarray]]] = None,
                 title: str = "", elev: float = 12.0, azim: float = -60.0):
    """Render one cloth frame (y-up scene mapped to matplotlib z-up).
    Returns the matplotlib figure; saves to out_path if given."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.asarray(x)
    fig = plt.figure(figsize=(6, 6), dpi=110)
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_trisurf(x[:, 0], x[:, 2], np.asarray(tris), x[:, 1],
                    color=(0.35, 0.55, 0.85, 0.95), edgecolor=(0, 0, 0, 0.08),
                    linewidth=0.2, shade=True)
    if x_fixed is not None and len(x_fixed):
        xf = np.asarray(x_fixed).reshape(-1, 3)
        ax.scatter(xf[:, 0], xf[:, 2], xf[:, 1], color="crimson", s=30,
                   depthshade=False)
    if obstacles:
        for kind, center in obstacles:
            c = np.asarray(center)
            ax.scatter([c[0]], [c[2]], [c[1]], color="gray", s=80, marker="s")
    _setup_axes(ax, x, title)
    ax.view_init(elev=elev, azim=azim)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def render_episode(xs: np.ndarray, tris: np.ndarray, out: str,
                   stride: int = 5, fps: int = 12,
                   x_fixed: Optional[np.ndarray] = None,
                   overlay_pts: Optional[np.ndarray] = None) -> str:
    """Render a trajectory (N,n,3) to an animated GIF (or per-frame PNGs if
    `out` is a directory).  The playback analog of Viewer::startMainLoop.
    `overlay_pts` (P,3): static scene geometry (e.g. sampled obstacle
    surfaces) drawn as gray dots in every frame."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    xs = np.asarray(xs)
    frames = list(range(0, xs.shape[0], max(1, stride)))
    if not out.endswith(".gif"):
        os.makedirs(out, exist_ok=True)
        for i in frames:
            render_frame(xs[i], tris,
                         os.path.join(out, f"frame{i:04d}.png"),
                         x_fixed=None if x_fixed is None else x_fixed[i],
                         title=f"frame {i}")
        return out

    fig = plt.figure(figsize=(6, 6), dpi=90)
    ax = fig.add_subplot(111, projection="3d")
    all_pts = xs if overlay_pts is None else np.concatenate(
        [xs.reshape(-1, 3), np.asarray(overlay_pts)], axis=0)

    def draw(k):
        ax.clear()
        i = frames[k]
        x = xs[i]
        ax.plot_trisurf(x[:, 0], x[:, 2], np.asarray(tris), x[:, 1],
                        color=(0.35, 0.55, 0.85, 0.95),
                        edgecolor=(0, 0, 0, 0.08), linewidth=0.2)
        if overlay_pts is not None:
            op = np.asarray(overlay_pts)
            ax.scatter(op[:, 0], op[:, 2], op[:, 1], color=(0.4, 0.4, 0.4),
                       s=4, alpha=0.6, depthshade=False)
        _setup_axes(ax, all_pts, f"frame {i}/{xs.shape[0] - 1}")
        ax.view_init(elev=12.0, azim=-60.0)
        return []

    anim = animation.FuncAnimation(fig, draw, frames=len(frames), blit=False)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    anim.save(out, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out
