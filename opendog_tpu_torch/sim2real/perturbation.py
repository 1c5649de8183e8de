"""Actuator perturbation self-test — the reference's pre-training
characterization of the action expansion + calibration map
(``run_actuator_perturbation_test``, sim2real/train.py:439-496).

Port of the JAX package's ``sim2real/perturbation.py``.  For every policy
channel x sign x gait phase it perturbs one action channel by
``delta_deg`` and tabulates, per actuator: sim home, real home, the applied
sim delta, the resulting sim target (rad) and real target (deg), and the
real-degree delta — the table a human checks before trusting the
sim->real mapping.  Returned as structured rows (and an optional printed
table), so it doubles as an automated invariant check."""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

CHANNEL_NAMES = {  # train.py:446-449
    0: "FR_tigh_delta",
    1: "Knee_P1(FR/BL)_sw_delta",
    2: "FL_tigh_delta",
    3: "Knee_P2(FL/BR)_sw_delta",
}


def actuator_perturbation_table(env, delta_deg: float = 15.0) -> List[dict]:
    """Run the full channel x sign x phase sweep on a ``SymWalkEnv``.

    Returns one row dict per (channel, sign, phase, actuator)."""
    delta_rad = math.radians(delta_deg)
    amp = env.action_amplitude
    cal = env.cal
    dev = env.model.device

    def expand(action, phase):
        return env.expand_action(
            torch.as_tensor(action, device=dev),
            torch.tensor(phase, dtype=torch.int32, device=dev)).cpu().numpy()

    def real_deg(ctrl_model):
        # float32 tensors: torch.rad2deg rounds as jnp.degrees does
        return cal.sim_rad_to_real_deg(torch.from_numpy(
            cal.reorder_from_model(ctrl_model).astype(np.float32))).numpy()

    rows: List[dict] = []
    for ch in range(4):
        for sign in (1, -1):
            for phase in (0, 1):
                action = np.zeros(4, np.float32)
                # env actions are [-1,1] x action_amplitude rad; express
                # the requested rad perturbation in action units
                action[ch] = sign * delta_rad / amp
                # baseline = the UNPERTURBED expansion at this phase (the
                # reference compares against base_policy_outputs_rad=0,
                # train.py:459)
                home_model = expand(np.zeros(4, np.float32),
                                    phase).astype(np.float64)
                ctrl_model = expand(action, phase)
                real = real_deg(ctrl_model)
                real_home = real_deg(home_model)
                sim_cal = cal.reorder_from_model(ctrl_model)
                home_cal = cal.reorder_from_model(home_model)
                for i, name in enumerate(cal.order):
                    rows.append(dict(
                        channel=CHANNEL_NAMES[ch], sign=sign, phase=phase,
                        actuator=name,
                        sim_home_rad=float(home_cal[i]),
                        real_home_deg=float(real_home[i]),
                        applied_sim_delta_rad=float(sim_cal[i]
                                                    - home_cal[i]),
                        sim_target_rad=float(sim_cal[i]),
                        real_target_deg=float(real[i]),
                        real_delta_deg=float(real[i] - real_home[i]),
                    ))
    return rows


def print_table(rows: List[dict]) -> None:  # pragma: no cover - display
    """Console rendering matching the reference's table layout."""
    last = None
    for r in rows:
        key = (r["channel"], r["sign"], r["phase"])
        if key != last:
            last = key
            phase_str = "FR/BL_swing" if r["phase"] == 0 else "FL/BR_swing"
            print(f"\nPerturbing: {r['channel']} by "
                  f"{r['sign'] * 15.0:.1f} deg | Phase: {phase_str}")
            print("  Actuator          |SimHome|RealHome|AppliedSimDelta"
                  "|SimTarget|RealTarget|RealDelta")
        print(f"    {r['actuator']:<18}: {r['sim_home_rad']:6.2f} | "
              f"{r['real_home_deg']:6.1f} | "
              f"{r['applied_sim_delta_rad']:13.2f} | "
              f"{r['sim_target_rad']:6.2f} | {r['real_target_deg']:8.1f} "
              f"| {r['real_delta_deg']:7.1f}")
