"""MPE rendering: world states to RGB frames, gifs and videos.

Port of `onpolicy_tpu/utils/render.py`: the reference's pyglet viewer
(`onpolicy/envs/mpe/rendering.py`, `mpe_runner.render:185-248`) replaced
by a headless matplotlib rasterizer (no GL context needed). The same
colours, sizes and matplotlib calls on the same float32 positions give
the JAX package's frame pixel for pixel.

matplotlib and imageio are imported inside the functions that need them:
without them a call raises ImportError, and importing this module does
not need them.
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

AGENT_COLOR = (0.25, 0.25, 0.75)
ADVERSARY_COLOR = (0.75, 0.25, 0.25)
LANDMARK_COLOR = (0.25, 0.25, 0.25)


def _host(x, env: int) -> np.ndarray:
    """World `env`'s rows of a batched tensor, as numpy on the host."""
    return x[env].detach().cpu().numpy()


def render_frame(spec, state, size: int = 400, bound: float = 1.4,
                 env: int = 0) -> np.ndarray:
    """World `env` of a batched `WorldState` (on any device) → RGB uint8
    [size, size, 3]."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(size / 100, size / 100), dpi=100)
    ax.set_xlim(-bound, bound)
    ax.set_ylim(-bound, bound)
    ax.set_aspect("equal")
    ax.axis("off")
    lm = _host(state.landmark_pos, env)
    for k in range(spec.n_landmarks):
        ax.add_patch(plt.Circle(lm[k], spec.landmark_size[k],
                                color=LANDMARK_COLOR, alpha=0.6))
    ap = _host(state.agent_pos, env)
    for i in range(spec.n_agents):
        color = ADVERSARY_COLOR if spec.agent_adversary[i] else AGENT_COLOR
        ax.add_patch(plt.Circle(ap[i], spec.agent_size[i], color=color,
                                alpha=0.85))
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return buf


def save_gif(frames: Sequence[np.ndarray], path, fps: float = 10.0):
    import imageio
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    imageio.mimsave(str(path), list(frames), duration=1.0 / fps, loop=0)
    return path


def save_video(frames: Sequence[np.ndarray], path, fps: float = 10.0):
    """An mp4 through imageio's ffmpeg plugin (the reference writes .avi
    through the GRF engine, render_football.py:87); a gif beside it, under
    the same name with .gif, where imageio cannot write the video (no
    ffmpeg), as the JAX package does. Returns the path written."""
    import imageio
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    try:
        imageio.mimsave(str(path), list(frames), fps=fps)
        return path
    except Exception:
        alt = str(Path(path).with_suffix(".gif"))
        return save_gif(frames, alt, fps=fps)
