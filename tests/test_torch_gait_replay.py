"""The counterpart of
tests/test_golden_gait_replay.py::test_designed_trot_replays_in_both_engines
on the port: the designed trot replays finite with the trunk above 0.03 m,
cut from 12 swing steps to 4 (one substep costs ~7.5 ms on the CPU)."""
import numpy as np
import torch

from opendog_tpu_torch import assets
from opendog_tpu_torch.sim2real import gait_designer, gait_json

torch.set_num_threads(1)


def test_designed_trot_replays_healthy():
    """The designed trot, read back through the real-degree pipeline
    (``gait_json.gait_to_sim_ctrl``), replays finite with the trunk up."""
    m = assets.load_opendog("flat", device="cpu")
    d, _, deg = gait_designer.design_trot(
        m, gait_designer.TrotParams(num_steps=4))
    ctrl_model = gait_json.gait_to_sim_ctrl(m, d, deg)
    cal = gait_designer.Calibration(m)
    out = gait_designer.replay_gait(m, d, cal.reorder_from_model(ctrl_model),
                                    device="cpu")
    assert np.all(np.isfinite(out["trunk"]))
    assert out["trunk"][:, 2].min() > 0.03
    assert np.all(np.isfinite(out["max_joint_err"]))
