#!/usr/bin/env python
"""Numerical audit of the op-graph physics step on the card: the
counterpart of scripts/precision_audit.py.

The port keeps float32 products in full float32 (TF32 off,
``device.use_full_fp32``, which ``dynamics.step`` applies at every call:
the JAX package's ``precision="highest"``).  This script measures what
TF32 would cost, against a float32 oracle on the CPU in the same process:

  * the qvel error of one substep over a batch of randomised physical Go1
    states (B = ``--batch``), with TF32 on ("default", the JAX script's
    ``precision=None``) and off ("highest");
  * the error of a 50-tick rollout (10 substeps a tick, held home control)
    under both settings;
  * the throughput of the batched 10-substep tick at B under both
    settings (one CUDA graph replayed per tick, host clock after
    ``torch.cuda.synchronize()``).

TF32 is turned on around the "default" calls only (``dynamics.step``'s own
``use_full_fp32`` held off for them), and off again after each.  On the
CPU the two settings coincide.  Run from the repository root:

    python3 scripts/torch_precision_audit.py              # the card
    python3 scripts/torch_precision_audit.py --device cpu --batch 8 --ticks 2

Writes the JAX script's keys (plus ``device``: the card's name and power
limit, or ``cpu``, and ``seconds``) to ``--out`` (default
``runs/torch_precision_audit/metrics.json``, kept out of git).
"""
import argparse
import contextlib
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_app_common import Replayed, open_device, write_metrics  # noqa

SETTINGS = ("default", "highest")   # TF32 on, TF32 off


@contextlib.contextmanager
def tf32(setting):
    """TF32 on for ``"default"`` (``dynamics.step``'s ``use_full_fp32``
    held off), untouched for ``"highest"``; full float32 again after."""
    import torch
    from opendog_tpu_torch.device import use_full_fp32
    from opendog_tpu_torch.physics import dynamics
    if setting == "highest":
        yield
        return
    dynamics.use_full_fp32 = lambda: None
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        dynamics.use_full_fp32 = use_full_fp32
        use_full_fp32()


def random_batch(model, B, seed=7):
    """Randomised physical states and controls (the recipe of
    tests/test_pallas_core.py), numpy."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(model.numpy("key_qpos")[0], (B, 1)).astype(np.float32)
    qpos[:, :3] += rng.normal(0, 0.01, (B, 3))
    qpos[:, 7:] += rng.normal(0, 0.05, (B, model.nq - 7))
    qvel = rng.normal(0, 0.2, (B, model.nv)).astype(np.float32)
    lo, hi = model.numpy("actuator_ctrlrange").T
    ctrl = rng.uniform(lo, hi, (B, model.nu)).astype(np.float32)
    return qpos, qvel, ctrl


def substep_qvel(model, qpos, qvel, ctrl, setting):
    """qvel after one substep of every state, numpy."""
    import torch
    from opendog_tpu_torch.physics import State, dynamics
    dev = model.device
    st = State(qpos=torch.from_numpy(qpos).to(dev),
               qvel=torch.from_numpy(qvel).to(dev),
               time=torch.zeros(qpos.shape[0], device=dev))
    with tf32(setting):
        out, _ = dynamics.step(model, st, torch.from_numpy(ctrl).to(dev),
                               n_substeps=1)
    return out.qvel.cpu().numpy()


def rollout_qvel(model, ticks, setting):
    """qvel after each of ``ticks`` ticks of 10 substeps from home under
    the home control, (ticks, nv) numpy."""
    from opendog_tpu_torch.physics import dynamics, make_state
    s, home, out = make_state(model, "home"), model.key_ctrl[0], []
    with tf32(setting):
        for _ in range(ticks):
            s, _ = dynamics.step(model, s, home, n_substeps=10)
            out.append(s.qvel.cpu().numpy())
    return np.stack(out)


def throughput(model, qpos, qvel, ctrl, setting, n=20):
    """Env-ticks per second of the batched 10-substep tick."""
    import torch
    from opendog_tpu_torch.physics import State, dynamics
    dev = model.device
    with tf32(setting):
        tick = Replayed(lambda qp, qv, u: dynamics.step(
            model, State(qpos=qp, qvel=qv, time=torch.zeros(
                qp.shape[0], device=dev)), u, n_substeps=10)[0].qpos, dev)
        qp, qv, u = (torch.from_numpy(x).to(dev) for x in (qpos, qvel,
                                                            ctrl))
        tick(qp, qv, u)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            tick(qp, qv, u)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return round(qpos.shape[0] * n / (time.perf_counter() - t0), 1)


def audit(dev, batch, ticks):
    """The JAX script's record on ``dev`` against the CPU oracle."""
    from opendog_tpu_torch.assets import load_go1
    m = load_go1("flat", device=dev)
    oracle = load_go1("flat", device="cpu")
    qpos, qvel, ctrl = random_batch(m, batch)
    ref = substep_qvel(oracle, qpos, qvel, ctrl, "highest")
    ref_traj = rollout_qvel(oracle, ticks, "highest")
    res = {"backend": dev.type, "batch": batch}
    for name in SETTINGS:
        err = np.abs(substep_qvel(m, qpos, qvel, ctrl, name) - ref)
        res[f"substep_qvel_err_median_{name}"] = float(np.median(err))
        res[f"substep_qvel_err_max_{name}"] = float(err.max())
    for name in SETTINGS:
        err = np.abs(rollout_qvel(m, ticks, name) - ref_traj)
        res[f"rollout_qvel_err_final_median_{name}"] = float(
            np.median(err[-1]))
        res[f"rollout_qvel_err_final_max_{name}"] = float(err[-1].max())
    for name in SETTINGS:
        res[f"env_ticks_per_sec_{name}"] = throughput(m, qpos, qvel, ctrl,
                                                      name)
    if res["env_ticks_per_sec_default"] > 0:
        res["highest_throughput_ratio"] = round(
            res["env_ticks_per_sec_highest"]
            / res["env_ticks_per_sec_default"], 3)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="runs/torch_precision_audit/"
                                    "metrics.json")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--ticks", type=int, default=50)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    start = time.perf_counter()
    dev, line = open_device(args.device)
    res = audit(dev, args.batch, args.ticks)
    res.update(device=line, seconds=time.perf_counter() - start)
    write_metrics(args.out, res)


if __name__ == "__main__":
    main()
