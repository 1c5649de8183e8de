"""Headless rendering and rollout video recording.

Port of ``opendog_tpu/utils/render.py`` (the reference's interactive
MuJoCo viewer fork, ``test/viewer.py``, and training-time recorder,
``train/VideoRecorderCallback.py:33-77``), without a GL stack: a
matplotlib stick figure over the FK chain (bodies as segments, collision
spheres as discs) and a GIF/MP4 recorder through imageio.  matplotlib and
imageio are imported when a function is called, not with the module: the
card's machine may lack them, and nothing on its path calls these.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..physics import State, dynamics, spatial


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def render_frame(model, state: State, ax=None, plane: str = "xz",
                 show_spheres: bool = True, xlim=(-0.6, 1.2),
                 ylim=(-0.05, 0.7)):
    """Render one frame (a state of one robot, qpos (nq,)) as a 2-D
    projection ('xz' side view or 'yz' front).  Returns the Axes."""
    plt = _plt()
    qpos = torch.as_tensor(state.qpos).to(model.device)
    with torch.no_grad():
        xpos, xquat = dynamics.fk(model, qpos)
        R = spatial.quat_to_mat(xquat).cpu().numpy()
    xpos = xpos.cpu().numpy()
    i0, i1 = (0, 2) if plane == "xz" else (1, 2)
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 3.2), dpi=100)
    ax.clear()
    ax.axhline(0.0, color="#888", lw=1)
    for b in range(model.nbody):
        p = model.body_parent[b]
        if p >= 0:
            ax.plot([xpos[p, i0], xpos[b, i0]], [xpos[p, i1], xpos[b, i1]],
                    "-", color="#2a6", lw=2)
    ax.plot(xpos[:, i0], xpos[:, i1], "o", color="#151", ms=3)
    if show_spheres:
        gb = np.array(model.geom_body_static)
        centers = xpos[gb] + np.einsum("gij,gj->gi", R[gb],
                                       model.numpy("geom_pos"))
        for c, r in zip(centers, model.numpy("geom_radius")):
            ax.add_patch(plt.Circle((c[i0], c[i1]), r, fill=False,
                                    color="#07c", lw=0.6, alpha=0.6))
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_aspect("equal")
    ax.set_title(f"t = {float(state.time):.2f} s")
    return ax


def record_rollout(model, states, path: str, fps: int = 25,
                   plane: str = "xz", follow: bool = True) -> int:
    """Write an MP4/GIF of a state sequence (the VideoRecorderCallback
    analog): a list of :class:`State` or one State with a leading time
    axis.  Returns the number of frames."""
    import imageio

    plt = _plt()
    if not isinstance(states, (list, tuple)):
        states = [State(qpos=states.qpos[t], qvel=states.qvel[t],
                        time=states.time[t])
                  for t in range(states.qpos.shape[0])]
    fig, ax = plt.subplots(figsize=(6, 3.2), dpi=100)
    frames: List[np.ndarray] = []
    for st in states:
        x = float(st.qpos[0])
        xlim = (x - 0.6, x + 1.0) if follow else (-0.6, 1.2)
        render_frame(model, st, ax=ax, plane=plane, xlim=xlim)
        fig.canvas.draw()
        frames.append(np.asarray(fig.canvas.buffer_rgba())[..., :3].copy())
    plt.close(fig)
    imageio.mimsave(path, frames, fps=fps)
    return len(frames)

