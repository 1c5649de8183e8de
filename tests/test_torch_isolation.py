"""The PyTorch port stands alone: opendog_tpu_torch, chip_smoke.py and the
port's scripts (scripts/torch_*.py) import neither JAX (nor flax / optax)
nor anything of the JAX package."""
import os
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "opendog_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    scripts = os.path.join(REPO, "scripts")
    out += [os.path.join(scripts, f) for f in os.listdir(scripts)
            if f.startswith("torch_") and f.endswith(".py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_imports_without_jax_in_a_fresh_process():
    code = r"""
import importlib, pkgutil, sys
import opendog_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    opendog_tpu_torch.__path__, "opendog_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "opendog_tpu"))
print(len(names), bad)
assert not bad, bad
assert "opendog_tpu_torch.physics.terrain" in names, names
for name in ("parallel", "parallel.mesh", "parallel.rollout",
             "parallel.collectives"):
    assert "opendog_tpu_torch." + name in names, names
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 15  # physics, assets, ops, solvers and their modules


def test_port_sources_name_no_jax_or_jax_package():
    sources = _port_sources()
    for name in ("__init__", "mesh", "rollout", "collectives"):
        assert os.path.join(PKG, "parallel", name + ".py") in sources
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b"
        r"|\bopendog_tpu\.|^\s*(import|from)\s+opendog_tpu\b(?!_torch)",
        re.M)
    hits = []
    for path in sources:
        with open(path) as f:
            for m in pattern.finditer(f.read()):
                hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0)!r}")
    assert not hits, hits
