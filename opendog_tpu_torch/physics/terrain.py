"""Procedural heightfield terrain.

Port of ``opendog_tpu/physics/terrain.py:29-97, 159-165`` (the reference's
per-episode generator, ``sim2real/train2.py:203-292``): 50% flat episodes;
otherwise a flat spawn circle (radius U[0.1, 0.4]) around the robot start,
per-cell uniform noise + a per-cell random-frequency sinusoid + 20%
spikes outside it, 1.5x amplification near the circle's edge, 4 masked 3x3
smoothing passes (factor 0.3), then min-max normalisation into [0, 1] and
world height ``base_z + norm * z_extent``.  Flat episodes sit at
normalised 0.5.

The seven random fields are drawn with a ``torch.Generator`` or passed in
as ``draws``: ``torch`` cannot reproduce ``jax.random``, so the tests hand
both packages the same draws.  ``generate_terrain_fractal`` is not ported
yet (ROADMAP M9).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .model import Model, Terrain

MAX_ABS_HEIGHT = 1.5      # train2.py:111
SMOOTH_FACTOR = 0.3       # train2.py:112
SMOOTH_PASSES = 4         # train2.py:113
SPIKE_PROB = 0.2          # train2.py:247
FLAT_PROB = 0.5           # train2.py:206


class TerrainDraws(NamedTuple):
    """The random fields of one terrain, after their scaling (the seven
    ``jax.random`` calls of the JAX generator, in its key order)."""

    flat_radius: torch.Tensor  # () U[0.1, 0.4]
    base_h: torch.Tensor       # (nrow, ncol) U[-1.5, 1.5]
    freq_x: torch.Tensor       # (nrow, ncol) U[0.2, 0.6]
    freq_y: torch.Tensor       # (nrow, ncol) U[0.2, 0.6]
    spike_u: torch.Tensor      # (nrow, ncol) U[0, 1): spike where < 0.2
    spike_h: torch.Tensor      # (nrow, ncol) U[-1.2, 1.2]
    flat_u: torch.Tensor       # () U[0, 1): flat episode where < 0.5


def draw_terrain(model: Model,
                 generator: Optional[torch.Generator] = None,
                 batch_shape=()) -> TerrainDraws:
    """The random fields of one terrain, or of ``batch_shape`` terrains
    (each field then leads with it), drawn with ``generator`` on its
    device (the CPU's default generator when None)."""
    nrow, ncol = model.hfield_nrow, model.hfield_ncol
    dev = generator.device if generator is not None else torch.device("cpu")
    batch_shape = tuple(batch_shape)

    def u(shape, lo=0.0, hi=1.0):
        x = torch.rand(batch_shape + shape, generator=generator, device=dev,
                       dtype=torch.float32)
        return lo + x * (hi - lo)

    grid = (nrow, ncol)
    return TerrainDraws(
        flat_radius=u((), 0.1, 0.4),
        base_h=u(grid, -MAX_ABS_HEIGHT, MAX_ABS_HEIGHT),
        freq_x=u(grid, 0.2, 0.6),
        freq_y=u(grid, 0.2, 0.6),
        spike_u=u(grid),
        spike_h=u(grid, -MAX_ABS_HEIGHT * 0.8, MAX_ABS_HEIGHT * 0.8),
        flat_u=u(()),
    )


def _smooth_pass(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One masked 3x3 mean-blend pass (interior cells only) of the grids
    (..., nrow, ncol)."""
    nrow, ncol = h.shape[-2:]
    p = torch.nn.functional.pad(h.reshape(-1, 1, nrow, ncol), (1, 1, 1, 1),
                                mode="replicate").reshape(
                                    h.shape[:-2] + (nrow + 2, ncol + 2))
    acc = torch.zeros_like(h)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            acc = acc + p[..., 1 + dr:1 + dr + nrow, 1 + dc:1 + dc + ncol]
    avg = acc / 9.0
    blended = h * (1 - SMOOTH_FACTOR) + avg * SMOOTH_FACTOR
    out = torch.where(mask, blended, h)
    # interior only (reference loops r,c in [1, N-2])
    out[..., 0, :], out[..., -1, :] = h[..., 0, :], h[..., -1, :]
    out[..., :, 0], out[..., :, -1] = h[..., :, 0], h[..., :, -1]
    return out


def generate_terrain(model: Model,
                     generator: Optional[torch.Generator] = None,
                     robot_start_xy=(0.0, 0.0),
                     draws: Optional[TerrainDraws] = None,
                     hfield_size=None) -> Terrain:
    """Sample one episode terrain (heights in meters on the model's hfield
    grid; rows follow world y, columns world x), or one per env when the
    draws lead with a batch axis (``draw_terrain(..., batch_shape=(B,))``:
    heights (B, nrow, ncol), each the terrain of its own draws).  The
    heights are computed on the device of the draws (the generator's; the
    CPU by default, so that one seed gives one terrain on every card) and
    returned on the model's device.  ``hfield_size`` (x_radius, y_radius,
    z_extent, base_z) as floats spares the read of the model's sizes back
    to the host, which a CUDA graph capture refuses."""
    nrow, ncol = model.hfield_nrow, model.hfield_ncol
    if nrow <= 0 or ncol <= 0:
        raise ValueError("model has no heightfield scene")
    if draws is None:
        draws = draw_terrain(model, generator)
    dev = draws.base_h.device
    if hfield_size is None:
        hfield_size = model.numpy("hfield_size")
    sx, sy, sz, base = (float(v) for v in hfield_size)

    xs = torch.linspace(-sx, sx, ncol, dtype=torch.float32, device=dev)
    ys = torch.linspace(-sy, sy, nrow, dtype=torch.float32, device=dev)
    wx = xs[None, :]  # (1, ncol)
    wy = ys[:, None]  # (nrow, 1)
    dist = torch.sqrt((wx - robot_start_xy[0]) ** 2
                      + (wy - robot_start_xy[1]) ** 2)  # (nrow, ncol)

    flat_radius = draws.flat_radius.to(dev)[..., None, None]
    outside = dist >= flat_radius
    freq_x, freq_y = draws.freq_x, draws.freq_y
    position_noise = (
        torch.sin(wx * freq_x) * torch.cos(wy * freq_y)
        + torch.sin(wx * freq_x * 2) * torch.cos(wy * freq_y * 2)
    ) * (MAX_ABS_HEIGHT * 0.7)
    spikes = (draws.spike_u < SPIKE_PROB) * draws.spike_h
    raw = (draws.base_h + position_noise + spikes) * outside
    boundary = torch.abs(dist - flat_radius) < 1.0
    raw = torch.where(outside & boundary, raw * 1.5, raw)

    h = raw
    for _ in range(SMOOTH_PASSES):
        h = _smooth_pass(h, outside)

    mn = torch.amin(h, dim=(-2, -1), keepdim=True)
    mx = torch.amax(h, dim=(-2, -1), keepdim=True)
    norm = torch.where(mx <= mn + 1e-4, torch.full_like(h, 0.5),
                       (h - mn) / (mx - mn))
    is_flat = draws.flat_u.to(dev)[..., None, None] < FLAT_PROB
    norm = torch.where(is_flat, torch.full_like(norm, 0.5), norm)
    return Terrain(height=(base + norm * sz).to(model.device))


def flat_terrain(model: Model) -> Terrain:
    """The 'flat episode' terrain: normalised 0.5 everywhere."""
    size = model.numpy("hfield_size")
    h = float(size[3]) + 0.5 * float(size[2])
    return Terrain(height=torch.full((model.hfield_nrow, model.hfield_ncol),
                                     h, dtype=torch.float32,
                                     device=model.device))
