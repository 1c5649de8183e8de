"""Policy introspection — per-layer activation capture + dashboards.

Port of ``sim2real/nnvis.py``: the reference instruments its torch
ActorCritic to record every layer's activations during rollout
(nnvis.py:58-100) and renders live matplotlib dashboards
(initialize_intuitive_plots :295, update_intuitive_plots :422).  The
dashboard renders headless to an image/figure.

Port of the JAX package's ``apps/nnvis.py``, which records with flax's
``capture_intermediates``.  Here forward hooks record each layer of the
module's ``flax_layers()`` under flax's own name (``Dense_0/__call__``: a
layer's output before its activation), and the module's outputs as
``__call__`` (``__call__.0``, ``.1``, ... for a tuple), so that the keys
are those of the JAX package.  ``activation_summary`` and
``render_activation_dashboard`` are copies.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def capture_activations(module: torch.nn.Module,
                        obs: torch.Tensor) -> Dict[str, np.ndarray]:
    """Run the module on ``obs`` recording every layer of its
    ``flax_layers()`` and its outputs; returns a flat {layer_path:
    activations} dict of numpy arrays under flax's names."""
    flat = {}
    tree = {}

    def record(name):
        def hook(mod, args, out):
            calls = tree.setdefault(name, {"__call__": ()})
            calls["__call__"] += (out.detach(),)   # one entry per call
        return hook

    hooks = [layer.register_forward_hook(record(name))
             for name, layer in module.flax_layers()]
    try:
        with torch.no_grad():
            out = module(obs)
    finally:
        for h in hooks:
            h.remove()
    tree["__call__"] = (out,)

    def store(path, v):
        if isinstance(v, (tuple, list)):
            if len(v) == 1:
                store(path, v[0])
            else:
                for i, vi in enumerate(v):
                    store(f"{path}.{i}", vi)
        else:
            flat[path] = v.detach().cpu().numpy()

    def walk(tree, prefix):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                store(path, v)

    walk(tree, "")
    return flat


def activation_summary(acts: Dict[str, np.ndarray]) -> Dict[str, Dict]:
    return {
        k: dict(
            mean=float(v.mean()), std=float(v.std()),
            min=float(v.min()), max=float(v.max()),
            saturation=float(np.mean(np.abs(v) > 0.95)),
            shape=list(v.shape),
        )
        for k, v in acts.items()
    }


def render_activation_dashboard(
    acts_over_time: List[Dict[str, np.ndarray]], path: str
) -> None:
    """Heatmap dashboard of layer activations over a rollout (the
    intuitive-plots analog), written to an image file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    keys = sorted(acts_over_time[0].keys())
    fig, axes = plt.subplots(
        len(keys), 1, figsize=(8, 1.6 * len(keys)), dpi=100, squeeze=False
    )
    for ax, k in zip(axes[:, 0], keys):
        mat = np.stack([a[k].reshape(-1) for a in acts_over_time])
        im = ax.imshow(mat.T, aspect="auto", cmap="RdBu_r",
                       vmin=-1.5, vmax=1.5)
        ax.set_ylabel(k.split("/")[-2] if "/" in k else k, fontsize=7)
        ax.set_yticks([])
    axes[-1, 0].set_xlabel("rollout step")
    fig.colorbar(im, ax=axes[:, 0], shrink=0.6)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
