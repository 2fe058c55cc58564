"""Offline trajectory viewer: render exported episodes to PNG / GIF.

Counterpart of `diffcloth_tpu/io/viewer.py` (the reference's OpenGL
Viewer, src/code/engine/Viewer.cpp, replaced by offline rendering); pairs
with `io.export.import_episode` for `--mode visualize --exp NAME`
(reference main.cpp:33-45).  Takes host numpy arrays.  matplotlib is
imported inside the functions, so nothing else in the port needs it;
where it is not installed (the card's machine), `render_episode` draws
with Pillow instead: flat-shaded triangles in an orthographic view from
the same angles.
"""
from __future__ import annotations

import importlib.util
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


def _pil_frames(xs: np.ndarray, tris: np.ndarray, frames, size: int = 480,
                elev: float = 12.0, azim: float = -60.0):
    """Pillow images of the given frames: the cloth's triangles, back to
    front, shaded by the angle of their normal to the view, in one
    orthographic view (y up) fitted to every frame."""
    from PIL import Image, ImageDraw
    a, e = np.radians(azim), np.radians(elev)
    turn = np.array([[np.cos(a), 0.0, -np.sin(a)], [0.0, 1.0, 0.0],
                     [np.sin(a), 0.0, np.cos(a)]])
    tilt = np.array([[1.0, 0.0, 0.0], [0.0, np.cos(e), -np.sin(e)],
                     [0.0, np.sin(e), np.cos(e)]])
    view = tilt @ turn
    pts = xs[frames] @ view.T                       # screen u, v, depth
    lo, hi = pts.reshape(-1, 3).min(0), pts.reshape(-1, 3).max(0)
    scale = 0.9 * size / max(float((hi - lo)[:2].max()), 1e-9)
    mid = (lo + hi) / 2
    tris = np.asarray(tris)
    images = []
    for p in pts:
        tri = p[tris]                                # (T, 3, 3)
        nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        shade = 0.35 + 0.65 * np.abs(nrm[:, 2]) / np.maximum(
            np.linalg.norm(nrm, axis=1), 1e-12)
        uv = np.stack([(tri[..., 0] - mid[0]) * scale + size / 2,
                       size / 2 - (tri[..., 1] - mid[1]) * scale], -1)
        img = Image.new("RGB", (size, size), "white")
        draw = ImageDraw.Draw(img)
        for t in np.argsort(-tri[:, :, 2].mean(1)):
            c = tuple(int(v * shade[t]) for v in (90, 140, 217))
            draw.polygon([tuple(q) for q in uv[t]], fill=c)
        images.append(img)
    return images


def render_episode(xs: np.ndarray, tris: np.ndarray, out: str,
                   stride: int = 5, fps: int = 12,
                   x_fixed: Optional[np.ndarray] = None,
                   overlay_pts: Optional[np.ndarray] = None,
                   backend: Optional[str] = None) -> str:
    """Render a trajectory (N,n,3) to an animated GIF (or per-frame PNGs if
    `out` is a directory).  The playback analog of Viewer::startMainLoop.
    `overlay_pts` (P,3): static scene geometry (e.g. sampled obstacle
    surfaces) drawn as gray dots in every frame.  `backend`: "matplotlib"
    (the default where it is installed) or "pil" (the cloth alone, without
    x_fixed and overlay_pts)."""
    if backend is None:
        backend = ("matplotlib" if importlib.util.find_spec("matplotlib")
                   else "pil")
    xs = np.asarray(xs)
    if backend == "pil":
        frames = list(range(0, xs.shape[0], max(1, stride)))
        images = _pil_frames(xs, tris, frames)
        if not out.endswith(".gif"):
            os.makedirs(out, exist_ok=True)
            for i, img in zip(frames, images):
                img.save(os.path.join(out, f"frame{i:04d}.png"))
            return out
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        images[0].save(out, save_all=True, append_images=images[1:],
                       duration=int(1000 / fps), loop=0)
        return out
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

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
