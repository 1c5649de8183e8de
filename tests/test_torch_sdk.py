"""The port's SDK (opendog_tpu_torch.sdk.QuadPilotBody) against two of the
port's own firmware-simulator builds on loopback (native/build.py): the
cases of tests/test_sdk.py over the real UDP/JSON wire protocol."""
import time

import pytest

from conftest import worker_port_offset
from opendog_tpu_torch.native import build as native

# a port base that no other test uses (ROADMAP: Rules, "Tests")
LISTEN = 19045 + worker_port_offset()
PORT1, PORT2 = LISTEN + 1, LISTEN + 2


@pytest.fixture(scope="module")
def firmware_pair():
    with native.firmware_pair(PORT1, PORT2, LISTEN) as procs:
        yield procs


@pytest.fixture()
def body(firmware_pair):
    from opendog_tpu_torch.sdk import QuadPilotBody

    b = QuadPilotBody(
        ip1="127.0.0.1", ip2="127.0.0.1",
        port1=PORT1, port2=PORT2,
        listen_for_broadcasts=True, listen_port=LISTEN,
    )
    yield b
    b.close()


def test_command_ack_roundtrip(body):
    """Every protocol command must be ACKed by the firmware
    (esp32_motors.ino:422-428)."""
    assert body.set_control_params(0.9, 0.001, 0.3, 10, 5)
    assert body.set_all_pins([(1, 2, 3, 4)] * 8)
    assert body.reset_all()
    assert body.set_send_interval(20)
    assert body.set_control_status(0, True)
    assert body.set_all_control_status(True)


def test_telemetry_broadcast_received(body):
    body.set_send_interval(20)
    deadline = time.time() + 3.0
    while time.time() < deadline:
        if body.is_data_available_from_esp(0) and body.is_data_available_from_esp(1):
            break
        time.sleep(0.05)
    assert body.is_data_available_from_esp(0)
    assert body.is_data_available_from_esp(1)
    data = body.get_latest_motor_data_for_esp(0)
    assert set(data) >= {"angles", "encoderPos", "targetPos", "dmp_ready"}
    assert body.is_dmp_ready_for_esp(0)
    dmp = body.get_latest_dmp_data_for_esp(0)
    assert dmp["quaternion"]["w"] == 1.0


def test_servo_loop_tracks_angle_target(body):
    """The 500 Hz PID servo model must drive the encoder to the commanded
    angle: set_angles(45 deg) -> encoder ~ 45*1975/360 counts
    (esp32_motors.ino:174-182,542-551)."""
    assert body.reset_all()
    assert body.set_all_control_status(True)
    body.set_send_interval(10)
    angles = [45.0, -30.0, 10.0, 0.0] + [20.0, 0.0, -45.0, 5.0]
    assert body.set_angles(angles)
    expected0 = int(45 * 1975 / 360)
    deadline = time.time() + 5.0
    enc = None
    while time.time() < deadline:
        data = body.get_latest_motor_data_for_esp(0)
        if data and data["targetPos"][0] == expected0:
            enc = data["encoderPos"][0]
            if abs(enc - expected0) <= 12:  # dead zone is 10 counts
                break
        time.sleep(0.05)
    assert enc is not None, "no telemetry with the commanded target"
    assert abs(enc - expected0) <= 12, f"servo did not converge: {enc}"
    # second ESP also got its half of the fan-out
    data2 = body.get_latest_motor_data_for_esp(1)
    assert data2["targetPos"][2] == int(-45 * 1975 / 360)


def test_get_imu_data_poll(body):
    """The polled get_imu_data path (quadpilot/body.py:225-240; firmware
    handler esp32_motors.ino:264-291): the firmware answers with a
    dmp_status packet, the SDK returns the dmp_data and folds it into the
    DMP store so the legacy getter sees it too."""
    d = body.get_imu_data(0)
    assert d is not None
    assert d["quaternion"]["w"] == 1.0
    assert set(d["ypr_deg"]) == {"yaw", "pitch", "roll"}
    # legacy deprecated getter (quadpilot/body.py:227-242) now has data
    deadline = time.time() + 3.0
    while time.time() < deadline:
        legacy = body.get_latest_imu_data_for_esp(0)
        if legacy:
            break
        time.sleep(0.05)
    assert legacy["quaternion"]["w"] == 1.0


def test_disabled_motor_does_not_move(body):
    assert body.reset_all()
    assert body.set_all_control_status(False)
    assert body.set_angles([90.0] * 8)
    time.sleep(0.5)
    data = body.get_latest_motor_data_for_esp(0)
    assert abs(data["encoderPos"][0]) < 5  # control disabled -> no motion


def test_firmware_builds_into_the_port_tree(firmware_pair):
    """The binary lives under opendog_tpu_torch/_build/native/, keyed by
    its source hash, and a second call reuses it."""
    import os

    path = native.build("firmware_sim")
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.access(path, os.X_OK)
    assert native.build("firmware_sim") == path


def test_build_raises_without_a_compiler(monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ was not found"):
        native.build("firmware_sim")
    with pytest.raises(ValueError):
        native.build("no_such_sim")
