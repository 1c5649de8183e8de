"""The port's MPC over the wire: the closed loop of tests/test_mpc_bridge.py
on the port, against two of the port's own firmware-simulator builds on
loopback.  ``RealtimeController.bridge_tick`` (the op-graph step, as
the JAX test's default engine) → ``QuadPilotBody.set_angles`` (UDP/JSON + ACK) → C++
``firmware_sim`` 500 Hz PID servo → broadcast telemetry → measured angles
→ ``DigitalTwin`` state estimate (the op-graph step) → next tick.  Runs
over UDP are not reproducible, so the loop is held to the reference
test's gates, not compared with JAX: joint tracking RMSE under 8 degrees,
the twin healthy and its trunk within 0.03 m of the standing height."""
import time

import numpy as np
import pytest
import torch

from conftest import worker_port_offset
from opendog_tpu_torch.native import build as native

torch.set_num_threads(1)

# a port base that no other test uses (ROADMAP: Rules, "Tests")
LISTEN = 19445 + worker_port_offset()
PORT1, PORT2 = LISTEN + 1, LISTEN + 2


@pytest.fixture(scope="module")
def firmware_pair():
    with native.firmware_pair(PORT1, PORT2, LISTEN) as procs:
        yield procs


def _body():
    from opendog_tpu_torch.sdk import QuadPilotBody

    return QuadPilotBody(ip1="127.0.0.1", ip2="127.0.0.1",
                         port1=PORT1, port2=PORT2,
                         listen_for_broadcasts=True, listen_port=LISTEN)


def _wait_for_telemetry(body):
    deadline = time.time() + 3.0
    while time.time() < deadline:
        if (body.is_data_available_from_esp(0)
                and body.is_data_available_from_esp(1)):
            return
        time.sleep(0.05)


@pytest.mark.parametrize("compensate", [False, True],
                         ids=["plain", "compensated"])
def test_mpc_bridge_closed_loop(firmware_pair, compensate):
    from opendog_tpu_torch.apps.mpc_bridge import MPCBridge
    from opendog_tpu_torch.assets import load_opendog
    from opendog_tpu_torch.solvers import MPPIConfig, costs
    from opendog_tpu_torch.solvers.mpc import RealtimeController

    m = load_opendog("flat", device="cpu")
    cost = costs.standing_cost(
        m, target_height=0.0694, home_joint_qpos=m.key_qpos[0, 7:])
    # the JAX test's MPPIConfig, whose default engine is the op-graph step
    # ("xla" there, "ops" in the port)
    cfg = MPPIConfig(horizon=4, num_samples=16, n_substeps=1,
                     rollout_dt=0.01, noise_sigma=0.05, engine="ops")
    rtc = RealtimeController(m, cost, cfg, lag=1, compensate=compensate,
                             device="cpu",
                             generator=torch.Generator().manual_seed(0))
    body = _body()
    try:
        bridge = MPCBridge(m, rtc, body)
        assert bridge.twin.device.type == "cpu"  # the controller's device
        assert bridge.bring_up(settle_s=1.0), "bring-up not ACKed"
        _wait_for_telemetry(body)
        # prime the pipeline off the clock, then measure a paced loop
        # (run() starts a fresh tracking window on its own)
        for _ in range(3):
            bridge.tick()
            time.sleep(0.02)
        metrics = bridge.run(75, rate_hz=50.0)
    finally:
        body.close()

    assert metrics["ticks"] == 75
    assert np.isfinite(metrics["host_blocking_p99_ms"])
    assert np.isfinite(metrics["joint_track_rmse_deg"])
    assert metrics["joint_track_rmse_deg"] < 8.0, metrics
    assert metrics["joint_track_delay_ticks"] >= 0
    assert metrics["twin_healthy"], metrics
    assert abs(metrics["twin_trunk_z"] - 0.0694) < 0.03
    assert metrics["compensated"] is compensate


def test_measured_angles_shape(firmware_pair):
    from opendog_tpu_torch.apps.mpc_bridge import read_measured_angles

    body = _body()
    try:
        body.set_send_interval(10)
        deadline = time.time() + 3.0
        angles = None
        while time.time() < deadline:
            angles = read_measured_angles(body)
            if angles is not None:
                break
            time.sleep(0.05)
        assert angles is not None
        assert angles.shape == (8,)
        assert np.all(np.isfinite(angles))
    finally:
        body.close()


def test_student_bridge_over_the_wire():
    """scripts/torch_cmd_student_bridge.py's 50 Hz arm on the CPU, its
    schedule cut to 2 ticks per unit: the committed command student
    (read without flax) drives its own firmware pair (ports inside this
    worker's block) and stays upright in every segment."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_cmd_student_bridge.py")
    spec = importlib.util.spec_from_file_location("torch_csb", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    res = script.run(os.path.join(script.REPO, "runs", "distill_cmd_opendog"),
                     LISTEN + 10, 2, (50.0,), device="cpu",
                     log=lambda s: None)
    out = res["rate_50hz"]
    assert [s["ticks"] for s in out["segments"]] == [2, 4, 4, 4, 4, 4, 2]
    assert out["ticks"] == 24 and out["twin_healthy"], out
    assert np.isfinite(out["joint_track_rmse_deg"])
    assert res["summary"]["upright_all"], res["summary"]
    assert set(res["summary"]) == {"upright_all", "stand_holds",
                                   "walks_on_command", "turns_on_command"}
