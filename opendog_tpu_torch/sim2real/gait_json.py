"""walk.json gait export / import: THE sim2real artifact.

Port of ``opendog_tpu/sim2real/gait_json.py``.  Schema parity with
``sim2real/train.py:600-636``: a JSON list of ``{"duration": seconds,
"targets_deg": {actuator_name: degrees}}`` steps in real-robot degrees,
playable by the robot apps (``examples/udp_walk.py``) and re-importable
into simulation (``sim2real/run.py:60-79``).
"""
from __future__ import annotations

import json
from typing import Callable, Sequence

import numpy as np
import torch

from .calibration import ACTUATOR_NAMES_ORDERED, Calibration

JSON_MAX_STEPS_EPISODIC = 50   # sim2real/train.py:51
JSON_MAX_STEPS_FINAL = 100     # sim2real/train.py:52


def save_gait(path: str, durations: Sequence[float],
              targets_deg: np.ndarray,
              names: Sequence[str] = ACTUATOR_NAMES_ORDERED) -> None:
    """Write a gait: targets_deg (T, 8) in ``names`` order."""
    seq = [
        {
            "duration": round(float(d), 3),
            "targets_deg": {
                n: round(float(v), 2) for n, v in zip(names, row)
            },
        }
        for d, row in zip(durations, np.asarray(targets_deg))
    ]
    with open(path, "w") as f:
        json.dump(seq, f, indent=2)


def load_gait(path: str, names: Sequence[str] = ACTUATOR_NAMES_ORDERED):
    """Read a walk.json; returns (durations (T,), targets_deg (T, 8))."""
    with open(path) as f:
        seq = json.load(f)
    durations = np.array([s["duration"] for s in seq], dtype=np.float64)
    targets = np.array(
        [[s["targets_deg"][n] for n in names] for s in seq], dtype=np.float64
    )
    return durations, targets


def generate_walk_json(policy_fn: Callable[[torch.Tensor], torch.Tensor],
                       env, path: str,
                       num_steps: int = JSON_MAX_STEPS_EPISODIC,
                       draws=None) -> int:
    """Deterministic policy rollout -> real-degree gait file
    (sim2real/train.py:600-636).  ``policy_fn(obs (1, O)) -> action (1,
    A)`` is the policy mean; ``env`` a :class:`~..envs.SymWalkEnv`, reset
    from ``draws`` (``env.draw_reset(None, 1)`` when None).  The
    rollout stops after the step whose episode ends, as the JAX loop
    does: it runs as :class:`~..rl.evaluate.PolicyRollout` (a replayed
    CUDA graph of one step on the card) and keeps the steps up to the
    episode's end.  Returns the number of steps written."""
    from ..rl.evaluate import PolicyRollout

    if draws is None:
        draws = env.draw_reset(None, 1)
    run = PolicyRollout(env, policy_fn, num_steps, env.model.device,
                        info_keys=("real_target_deg",))
    metrics, _, infos = run(draws)
    n = int(metrics["episode_len"])
    if n == 0:
        return 0
    rows = infos["real_target_deg"][:n].cpu().numpy()
    save_gait(path, [env.policy_dt] * n, rows, env.cal.order)
    return n


def transform_gait(targets_deg: np.ndarray, sign=None, offset_deg=None,
                   names: Sequence[str] = ACTUATOR_NAMES_ORDERED,
                   invert: Sequence[str] = ()) -> np.ndarray:
    """Per-channel sign/offset gait transformer (the examples/invert.py and
    invertplay.py utilities generalised): ``invert`` lists actuator names
    whose sign flips (invert.py:5-18 flips the front thigh channels);
    ``sign``/``offset_deg`` apply elementwise."""
    t = np.array(targets_deg, dtype=np.float64)
    if sign is not None:
        t = t * np.asarray(sign, dtype=np.float64)
    if offset_deg is not None:
        t = t + np.asarray(offset_deg, dtype=np.float64)
    for n in invert:
        t[:, list(names).index(n)] *= -1.0
    return t


def gait_to_sim_ctrl(model, durations, targets_deg) -> np.ndarray:
    """Real-deg gait -> per-step sim ctrl vectors in *model* actuator order
    with ctrlrange clamping (the inverse pipeline of sim2real/run.py), in
    float32 as the JAX function computes them."""
    cal = Calibration(model)
    sim_cal = cal.real_deg_to_sim_rad(
        torch.as_tensor(np.asarray(targets_deg, np.float32))).numpy()
    return sim_cal[:, np.argsort(cal.model_actuator_index)]
