"""Monocular depth estimation: a trained predictor for the 2d.py loop.

Port of ``opendog_tpu/apps/mono_depth.py``.  The reference's
``examples/2d.py`` runs Depth-Anything-V2 on webcam frames; ``apps/
depth.py`` carries its display loop with a pluggable predictor, and this
module puts a net trained on sim frames in that seat:

  * ``render_shaded`` -- synthetic camera images from the sim: Lambertian
    shading of the terrain (normal . sun) with distance attenuation and
    sensor noise, aligned pixel for pixel with ground-truth depth from the
    same raycast (``apps/slam.render_depth``); ``render_shaded_overcast``
    is a second, independent appearance model over the same geometry;
  * ``DepthCNN``     -- a small conv net (image -> depth map), NCHW, whose
    parameters start as flax starts them and which
    :func:`load_flax_depth_params` fills from the JAX package's tree;
  * ``train_depth_net`` -- trains on frames from random poses / terrains
    with Adam and reports validation RMSE against the mean-depth baseline;
  * ``make_sim_predictor`` -- wraps a trained net as an ``apps.depth``
    predictor (frame -> depth).

Poses, sensor noise and minibatch indices are the reference's numpy draws,
so both packages see the same frames and batches.  On the card the
convolutions are cuDNN's, in full float32 (``device.use_full_fp32``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..physics.dynamics import _terrain_height_normal
from ..rl.networks import _TRUNC_STD
from .slam import CamConfig, render_depth

SUN = np.array([0.3, 0.2, 0.93])
SUN = SUN / np.linalg.norm(SUN)


def _hit_geometry(model, terrain, pose_xy_yaw, cam: CamConfig):
    """The raycast of ``pose`` as the two renderers read it: world hit
    points (H*W, 3) float64, ray ranges (NaN where no hit), the hit mask
    and the terrain's unit normals under the hits (float32)."""
    pts = render_depth(model, terrain, pose_xy_yaw, cam=cam).cpu().numpy()
    x, y, yaw = (float(v) for v in np.asarray(pose_xy_yaw))
    c, s = np.cos(yaw), np.sin(yaw)
    pw = np.stack([c * pts[:, 0] - s * pts[:, 1] + x,
                   s * pts[:, 0] + c * pts[:, 1] + y,
                   pts[:, 2]], axis=1)
    dev = terrain.height.device
    h0, _ = _terrain_height_normal(
        model, terrain, torch.tensor([[x, y]], dtype=torch.float32,
                                     device=dev))
    origin = np.array([x, y, float(h0[0]) + cam.cam_height])
    rng_ = np.linalg.norm(pw - origin, axis=1)
    hit = np.isfinite(rng_)
    xy = np.where(hit[:, None], pw, 0.0)[:, :2].astype(np.float32)
    _, n = _terrain_height_normal(model, terrain,
                                  torch.from_numpy(xy).to(dev))
    return pw, rng_, hit, n.cpu().numpy()


def render_shaded(model, terrain, pose_xy_yaw,
                  cam: CamConfig = CamConfig(), noise: float = 0.02,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(image (H, W) in [0,1], depth (H, W) ray range in m), numpy.  NaN
    depth (sky) renders bright and is clamped to max_range in the
    target."""
    _, rng_, hit, n = _hit_geometry(model, terrain, pose_xy_yaw, cam)
    lamb = np.clip(n @ SUN, 0.0, 1.0)
    atten = 1.0 / (1.0 + 0.12 * rng_ ** 2)
    img = np.where(hit, 0.15 + 0.85 * lamb * atten, 0.9)
    img = img + np.random.default_rng(seed).normal(0, noise, img.shape)
    depth = np.where(hit, rng_, cam.max_range)
    H, W = cam.height, cam.width
    return (np.clip(img, 0, 1).astype(np.float32).reshape(H, W),
            depth.astype(np.float32).reshape(H, W))


def render_shaded_overcast(model, terrain, pose_xy_yaw,
                           cam: CamConfig = CamConfig(),
                           noise: float = 0.02,
                           seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Second, independent shading family over the same ground-truth
    geometry: overcast sky instead of a directional sun, exponential
    aerial fog instead of inverse-square attenuation, surface-albedo
    texture, shot (Poisson) noise instead of Gaussian, and a lens
    vignette.  A depth net trained on :func:`render_shaded` frames sees a
    different appearance model entirely."""
    pw, rng_, hit, n = _hit_geometry(model, terrain, pose_xy_yaw, cam)
    # overcast dome: irradiance ~ (1 + n_z) / 2 (no sun direction at all)
    sky_vis = 0.5 * (1.0 + n[:, 2])
    # procedural albedo texture (world-anchored, so it parallax-shifts)
    alb = 0.55 + 0.25 * np.sin(7.3 * pw[:, 0]) * np.cos(5.1 * pw[:, 1])
    lum = alb * sky_vis
    # aerial fog toward the sky luminance
    fog = np.exp(-rng_ / 6.0)
    sky_lum = 0.82
    img = np.where(hit, lum * fog + sky_lum * (1.0 - fog), sky_lum)
    H, W = cam.height, cam.width
    img = img.reshape(H, W)
    # lens vignette
    vy = np.linspace(-1, 1, H)[:, None]
    vx = np.linspace(-1, 1, W)[None, :]
    img = img * (1.0 - 0.25 * (vx ** 2 + vy ** 2))
    # shot noise: Poisson with per-pixel rate proportional to intensity
    prng = np.random.default_rng(seed)
    photons = 1.0 / max(noise, 1e-3) ** 2
    img = prng.poisson(np.clip(img, 0, 1) * photons) / photons
    depth = np.where(hit, rng_, cam.max_range)
    return (np.clip(img, 0, 1).astype(np.float32).reshape(H, W),
            depth.astype(np.float32).reshape(H, W))


def _same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's "SAME" padding (low, high) of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class DepthCNN(nn.Module):
    """Tiny encoder-decoder: images (N, 1, H, W) -> depth (N, H, W).

    flax's layer order, which :func:`load_flax_depth_params` follows:
    ``Conv_0`` (3x3, f), ``Conv_1`` (3x3 stride 2, 2f), ``Conv_2`` (3x3,
    2f), a bilinear resize back to (H, W), ``Conv_3`` (3x3, f) over the
    resized features and the image, ``Conv_4`` (3x3, 1).  Parameters start
    as flax starts them: kernels from a normal cut at two standard
    deviations, of standard deviation sqrt(1 / fan_in), biases 0;
    ``generator`` draws them (on the CPU)."""

    def __init__(self, features: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = self.features = int(features)
        self.convs = nn.ModuleList([
            nn.Conv2d(1, f, 3), nn.Conv2d(f, 2 * f, 3, stride=2),
            nn.Conv2d(2 * f, 2 * f, 3), nn.Conv2d(2 * f + 1, f, 3),
            nn.Conv2d(f, 1, 3)])
        with torch.no_grad():
            for conv in self.convs:
                fan_in = conv.in_channels * 9
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                conv.bias.zero_()

    @staticmethod
    def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        s = conv.stride[0]
        (t, b), (l, r) = (_same_pad(n, 3, s) for n in x.shape[-2:])
        return conv(F.pad(x, (l, r, t, b)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.convs
        h = torch.relu(self._conv(c[0], x))
        h = torch.relu(self._conv(c[1], h))
        h = torch.relu(self._conv(c[2], h))
        h = F.interpolate(h, size=x.shape[-2:], mode="bilinear",
                          align_corners=False)
        h = torch.relu(self._conv(c[3], torch.cat([h, x], dim=1)))
        return self._conv(c[4], h)[:, 0]


def load_flax_depth_params(net: DepthCNN, tree: dict) -> DepthCNN:
    """Copies the JAX package's ``DepthCNN`` parameters (the tree of
    ``net.init`` / ``train_depth_net``, numpy or jax arrays, with or
    without its ``"params"`` level) into ``net``: flax kernels (kh, kw,
    in, out) become torch's (out, in, kh, kw)."""
    tree = tree.get("params", tree)
    with torch.no_grad():
        for i, conv in enumerate(net.convs):
            layer = tree[f"Conv_{i}"]
            kernel = np.asarray(layer["kernel"], np.float32)
            conv.weight.copy_(torch.tensor(kernel.transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.tensor(np.asarray(layer["bias"],
                                                    np.float32)))
    return net


def _dataset(model, terrains, n_frames: int, cam: CamConfig, seed: int):
    """(images (n, 1, H, W), depths (n, H, W)) numpy, from the reference's
    pose and noise draws."""
    rng = np.random.default_rng(seed)
    imgs, depths = [], []
    for i in range(n_frames):
        terr = terrains[i % len(terrains)]
        im, d = render_shaded(model, terr, train_box_pose(rng), cam=cam,
                              seed=seed + i)
        imgs.append(im)
        depths.append(d)
    return np.stack(imgs)[:, None], np.stack(depths)


def train_box_pose(rng: np.random.Generator) -> np.ndarray:
    """A pose of the training box (x, y in [-1.5, 1.5] m, any yaw), drawn
    as :func:`_dataset` draws it."""
    return np.array([rng.uniform(-1.5, 1.5), rng.uniform(-1.5, 1.5),
                     rng.uniform(-np.pi, np.pi)], np.float32)


def eval_depth_arm(model, net: "DepthCNN", terrains, n_frames: int,
                   seed: int, renderer=render_shaded,
                   pose_fn=train_box_pose, cam: CamConfig = CamConfig()):
    """One arm of the depth evals (``scripts/depth_{offdist,crossfam}_
    eval.py``): ``n_frames`` frames of ``renderer`` over ``terrains`` in
    turn, poses from ``pose_fn(rng)`` and noise from ``seed`` as the JAX
    scripts draw them; the net runs on its device.  Returns the RMSE of the
    net and of the mean-depth predictor (rounded to 4 decimals) and
    whether the net beats it."""
    rng = np.random.default_rng(seed)
    imgs, depths = [], []
    for i in range(n_frames):
        terr = terrains[i % len(terrains)]
        im, d = renderer(model, terr, pose_fn(rng), cam=cam, seed=seed + i)
        imgs.append(im)
        depths.append(d)
    x = torch.from_numpy(np.stack(imgs)[:, None]).to(
        next(net.parameters()).device)
    y = np.stack(depths)
    with torch.no_grad():
        pred = net(x).cpu().numpy()
    rmse = float(np.sqrt(np.mean((pred - y) ** 2)))
    base = float(np.sqrt(np.mean((y.mean() - y) ** 2)))
    return dict(rmse_m=round(rmse, 4),
                mean_depth_baseline_rmse_m=round(base, 4),
                beats_baseline=bool(rmse < base))


def train_depth_net(model, terrains, n_train: int = 48, n_val: int = 12,
                    steps: int = 300, lr: float = 3e-3,
                    cam: CamConfig = CamConfig(), seed: int = 0,
                    device=None, init_params: Optional[dict] = None):
    """Train DepthCNN on sim frames on ``device`` (CUDA unless the caller
    names another; the terrains are moved there); returns (net,
    metrics).  The net starts from flax's law on a CPU generator seeded
    with ``seed``, or from ``init_params`` (a flax tree, see
    :func:`load_flax_depth_params`).  Adam at optax's defaults
    (betas 0.9 / 0.999, eps 1e-8)."""
    dev = resolve_device(device)
    terrains = [t.to(dev) for t in terrains]
    xi, yi = _dataset(model, terrains, n_train, cam, seed)
    xv, yv = _dataset(model, terrains, n_val, cam, seed + 7777)
    net = DepthCNN(generator=torch.Generator().manual_seed(seed))
    if init_params is not None:
        load_flax_depth_params(net, init_params)
    net.to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    xb_all = torch.from_numpy(xi).to(dev)
    yb_all = torch.from_numpy(yi).to(dev)
    key = np.random.default_rng(seed + 1)
    batch = min(16, n_train)
    loss = None
    for _ in range(steps):
        idx = torch.from_numpy(key.choice(n_train, batch, replace=False)
                               ).to(dev)
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((net(xb_all[idx]) - yb_all[idx]) ** 2)
        loss.backward()
        opt.step()
    with torch.no_grad():
        pred_v = net(torch.from_numpy(xv).to(dev)).cpu().numpy()
    rmse = float(np.sqrt(np.mean((pred_v - yv) ** 2)))
    base = float(np.sqrt(np.mean((yi.mean() - yv) ** 2)))
    metrics = dict(train_frames=n_train, val_frames=n_val, steps=steps,
                   final_train_loss=loss.item(), val_rmse_m=round(rmse, 4),
                   mean_depth_baseline_rmse_m=round(base, 4),
                   beats_baseline=bool(rmse < base))
    return net, metrics


def make_sim_predictor(net: DepthCNN, cam: CamConfig = CamConfig()):
    """A trained net -> ``apps.depth`` predictor: RGB / gray frame in
    (numpy), depth map (H, W) out, computed on the net's device.  The
    frame is resized to the net's input grid with antialiasing, as
    ``jax.image.resize`` does."""
    dev = next(net.parameters()).device

    def predict(frame: np.ndarray) -> np.ndarray:
        f = np.asarray(frame, np.float32)
        if f.ndim == 3:                      # RGB -> gray
            f = f.mean(axis=-1)
        if f.max() > 1.5:                    # 0-255 -> 0-1
            f = f / 255.0
        x = F.interpolate(torch.from_numpy(f).to(dev)[None, None],
                          size=(cam.height, cam.width), mode="bilinear",
                          align_corners=False, antialias=True)
        with torch.no_grad():
            return net(x)[0].cpu().numpy()

    return predict
