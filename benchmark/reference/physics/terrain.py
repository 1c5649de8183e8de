# Frozen copy of opendog_tpu_torch/physics/terrain.py at commit 9b29168 (the benchmark's reference:
# later changes to the program do not reach it).  Imports rewritten only.
"""Procedural heightfield terrain.

Port of ``opendog_tpu/physics/terrain.py`` (the reference's per-episode
generator, ``sim2real/train2.py:203-292``): 50% flat episodes;
otherwise a flat spawn circle (radius U[0.1, 0.4]) around the robot start,
per-cell uniform noise + a per-cell random-frequency sinusoid + 20%
spikes outside it, 1.5x amplification near the circle's edge, 4 masked 3x3
smoothing passes (factor 0.3), then min-max normalisation into [0, 1] and
world height ``base_z + norm * z_extent``.  Flat episodes sit at
normalised 0.5.  :func:`generate_terrain_fractal` is the second,
independent family (spectral fBm, terraces and craters) that the
cross-family depth eval holds out.

The random fields are drawn with a ``torch.Generator`` or passed in as
``draws``: ``torch`` cannot reproduce ``jax.random``, so the tests hand
both packages the same draws.
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


def linspace(start: float, stop: float, num: int, device=None
             ) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32 as JAX computes it op
    by op, bit for bit: ``start * (1 - s) + stop * s`` with ``s = i / (num
    - 1)`` for the first ``num - 1`` points, then ``stop``.
    ``torch.linspace`` rounds differently (up to 2.4e-7 on ``linspace(0.05,
    4.0, 48)``), which moves a ray march's coarse intervals.  Compiled, XLA
    multiplies by ``1 / (num - 1)`` and may fuse the sum into one rounding:
    up to two ulps of the larger endpoint from this."""
    f32 = dict(dtype=torch.float32, device=device)
    if num == 1:
        return torch.tensor([start], **f32)
    div = num - 1
    s = torch.arange(div, **f32) / torch.tensor(float(div), **f32)
    out = (torch.tensor(start, **f32) * (1 - s)
           + torch.tensor(stop, **f32) * s)
    return torch.cat([out, torch.tensor([stop], **f32)])


class FractalDraws(NamedTuple):
    """The random draws of one fractal terrain, after their scaling (the
    JAX generator's ``keys[0, 1, 2, 6, 7, 4, 5]``; ``keys[3]`` is
    unused)."""

    beta: torch.Tensor      # () U[1.6, 2.4]: spectral exponent
    spec_re: torch.Tensor   # (nrow, ncol) N(0, 1)
    spec_im: torch.Tensor   # (nrow, ncol) N(0, 1)
    steps_u: torch.Tensor   # () U[0, 1): 4 + floor(4 u) terrace levels
    terr_w: torch.Tensor    # () U[0.3, 0.8]: terrace blend weight
    sites: torch.Tensor     # (3, 2) U[-0.7 sx, 0.7 sx]: crater centers
    radii: torch.Tensor     # (3,) U[0.3, 1.0]: crater radii


def draw_terrain_fractal(model: Model,
                         generator: Optional[torch.Generator] = None,
                         batch_shape=()) -> FractalDraws:
    """The draws of one fractal terrain, or of ``batch_shape`` terrains
    (each field then leads with it), with ``generator`` on its device
    (the CPU's default generator when None)."""
    nrow, ncol = model.hfield_nrow, model.hfield_ncol
    sx = float(model.numpy("hfield_size")[0])
    dev = generator.device if generator is not None else torch.device("cpu")
    batch_shape = tuple(batch_shape)
    kw = dict(generator=generator, device=dev, dtype=torch.float32)

    def u(shape, lo=0.0, hi=1.0):
        return lo + torch.rand(batch_shape + shape, **kw) * (hi - lo)

    return FractalDraws(
        beta=u((), 1.6, 2.4),
        spec_re=torch.randn(batch_shape + (nrow, ncol), **kw),
        spec_im=torch.randn(batch_shape + (nrow, ncol), **kw),
        steps_u=u(()),
        terr_w=u((), 0.3, 0.8),
        sites=u((3, 2), -0.7 * sx, 0.7 * sx),
        radii=u((3,), 0.3, 1.0),
    )


def generate_terrain_fractal(model: Model,
                             draws: Optional[FractalDraws] = None,
                             generator: Optional[torch.Generator] = None,
                             robot_start_xy=(0.0, 0.0)) -> Terrain:
    """Second, independent terrain family (``opendog_tpu/physics/
    terrain.py:100-156``): power-law-filtered Fourier noise (a fractal
    Brownian surface, spectral exponent ``beta``), partly quantized into
    terraces, with three Gaussian craters and a flat spawn disk around the
    robot start; normalised into [0, 1] and scaled into the hfield's world
    heights.  Computed on the device of the draws (the generator's; the
    CPU by default) and returned on the model's device; draws with a
    leading batch axis give (B, nrow, ncol) heights."""
    nrow, ncol = model.hfield_nrow, model.hfield_ncol
    if nrow <= 0 or ncol <= 0:
        raise ValueError("model has no heightfield scene")
    if draws is None:
        draws = draw_terrain_fractal(model, generator)
    dev = draws.spec_re.device
    sx, sy, sz, base = (float(v) for v in model.numpy("hfield_size"))

    def scalar(t):  # a () draw, or a (B,) one, against (..., nrow, ncol)
        return t.to(dev)[..., None, None]

    # spectral synthesis: white noise shaped by |k|^-beta
    spec = torch.complex(draws.spec_re, draws.spec_im)
    ky = torch.fft.fftfreq(nrow, dtype=torch.float32, device=dev)[:, None]
    kx = torch.fft.fftfreq(ncol, dtype=torch.float32, device=dev)[None, :]
    kk = torch.sqrt(kx ** 2 + ky ** 2)
    filt = torch.where(kk > 0, kk ** (-scalar(draws.beta)), 0.0)
    h = torch.fft.ifft2(spec * filt).real

    # terracing: blend toward quantized levels (stepped mesas); torch.round
    # rounds half to even, as jnp.round does
    mn = torch.amin(h, dim=(-2, -1), keepdim=True)
    mx = torch.amax(h, dim=(-2, -1), keepdim=True)
    hn = (h - mn) / (mx - mn + 1e-9)
    n_steps = 4.0 + torch.floor(scalar(draws.steps_u) * 4.0)
    terr_w = scalar(draws.terr_w)
    hn = terr_w * torch.round(hn * n_steps) / n_steps + (1 - terr_w) * hn

    # craters: smooth Gaussian depressions at random sites
    xs = linspace(-sx, sx, ncol, dev)[None, :]
    ys = linspace(-sy, sy, nrow, dev)[:, None]
    sites, radii = draws.sites.to(dev), draws.radii.to(dev)
    for i in range(3):
        d2 = ((xs - sites[..., i, 0, None, None]) ** 2
              + (ys - sites[..., i, 1, None, None]) ** 2)
        hn = hn - 0.35 * torch.exp(-d2 / (2 * radii[..., i, None, None] ** 2))

    # flat spawn disk (the robot still needs somewhere to stand)
    dist = torch.sqrt((xs - robot_start_xy[0]) ** 2
                      + (ys - robot_start_xy[1]) ** 2)
    spawn = torch.clamp(dist / 0.35, 0.0, 1.0)
    hn = 0.5 + (hn - 0.5) * spawn
    lo = torch.amin(hn, dim=(-2, -1), keepdim=True)
    hi = torch.amax(hn, dim=(-2, -1), keepdim=True)
    hn = torch.clamp((hn - lo) / (hi - lo + 1e-9), 0.0, 1.0)
    return Terrain(height=(base + hn * sz).to(model.device))


def flat_terrain(model: Model) -> Terrain:
    """The 'flat episode' terrain: normalised 0.5 everywhere."""
    size = model.numpy("hfield_size")
    h = float(size[3]) + 0.5 * float(size[2])
    return Terrain(height=torch.full((model.hfield_nrow, model.hfield_ncol),
                                     h, dtype=torch.float32,
                                     device=model.device))
