"""The port's camera client (opendog_tpu_torch.sdk.QuadPilotCamera, on
urllib) against the port's own camera-simulator build on loopback HTTP:
the cases of tests/test_camera.py."""
import json
import urllib.request

import pytest

from conftest import worker_port_offset
from opendog_tpu_torch.native import build as native

# a port base that no other test uses (ROADMAP: Rules, "Tests")
PORT = 19245 + worker_port_offset()


@pytest.fixture(scope="module")
def camera_proc():
    with native.camera(PORT) as proc:
        yield proc


@pytest.fixture()
def cam(camera_proc):
    from opendog_tpu_torch.sdk import QuadPilotCamera

    return QuadPilotCamera("127.0.0.1", port=PORT, timeout=3.0)


def test_imu_and_ads_endpoints(cam):
    imu = cam.get_imu_data()
    assert imu and "accel" in imu and abs(imu["accel"]["z"] - 9.81) < 0.01
    ads = cam.get_ads_data()
    assert ads and set(ads) == {"ch0", "ch1", "ch2", "ch3"}


def test_framesize_control(cam):
    assert cam.change_framesize("QVGA")
    with urllib.request.urlopen(
        f"http://127.0.0.1:{PORT}/status", timeout=3
    ) as r:
        assert json.loads(r.read())["framesize"] == 4


def test_mjpeg_stream_yields_frames(cam):
    frames = []
    for f in cam.stream():
        frames.append(f)
        if len(frames) >= 3:
            cam.stop_stream()
            break
    assert len(frames) >= 3
    raw = frames[0] if isinstance(frames[0], bytes) else None
    if raw is not None:
        assert raw[:2] == b"\xff\xd8" and raw[-2:] == b"\xff\xd9"
    else:  # cv2 decoded
        assert frames[0] is not None


def test_sse_events_stream(camera_proc):
    with urllib.request.urlopen(f"http://127.0.0.1:{PORT}/events",
                                timeout=5) as r:
        lines = []
        for line in r:
            if line.startswith(b"data:"):
                lines.append(line)
                if len(lines) >= 2:
                    break
    payload = json.loads(lines[0][5:])
    assert "imu" in payload and "ads" in payload


def test_raw_stream_yields_jpegs(cam):
    frames = []
    for f in cam.raw_stream():
        frames.append(f)
        if len(frames) >= 2:
            cam.stop_stream()
            break
    assert all(f[:2] == b"\xff\xd8" and f[-2:] == b"\xff\xd9"
               for f in frames)


def test_unreachable_camera_reads_none():
    from opendog_tpu_torch.sdk import QuadPilotCamera

    # a port on which nothing listens: no answer is None, not a raise
    dead = QuadPilotCamera("127.0.0.1", port=PORT + 7, timeout=1.0)
    assert dead.get_imu_data() is None
    assert dead.get_ads_data() is None
