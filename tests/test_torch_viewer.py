"""The port's SimViewer and viewer CLI (``opendog_tpu_torch/telemetry/
viewer.py``, ``apps/viewer_cli.py``) against the JAX package's on OpenDOG
flat, both paused from the home keyframe: the same ticks, pushes, twists
and teleports give states within 1e-4 qpos / 1e-3 qvel and packets within
the same (the JAX viewer jits its step, and jitted XLA fuses a product and
a sum into one rounding: ROADMAP Queue 3); the CLI gives the JAX replies;
the port's MJPEG ``/frame`` serves a JPEG and ``render_video`` records."""
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendog_tpu.apps import viewer_cli as jcli
from opendog_tpu.assets import load_opendog as jload
from opendog_tpu.physics import make_state as jmake_state
from opendog_tpu.telemetry.viewer import SimViewer as JViewer
from opendog_tpu_torch.apps import viewer_cli
from opendog_tpu_torch.assets import load_opendog
from opendog_tpu_torch.physics import make_state
from opendog_tpu_torch.telemetry.viewer import SimViewer

torch.set_num_threads(1)

TOL = {"qpos": 1e-4, "qvel": 1e-3}


@pytest.fixture(scope="module")
def viewers():
    jm = jload("flat")
    hold_j = jnp.asarray(jm.key_ctrl[0])
    jv = JViewer(jm, jmake_state(jm, "home"), lambda st, t: hold_j,
                 telemetry_port=0)
    m = load_opendog("flat", device="cpu")
    hold = m.key_ctrl[0]
    tv = SimViewer(m, make_state(m, "home"), lambda st, t: hold,
                   telemetry_port=0, device="cpu")
    for v in (jv, tv):
        v.pause()
    yield jv, tv
    jv.close()
    tv.close()


def _close(jst, tst, what):
    for f in ("qpos", "qvel"):
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)),
                                   atol=TOL[f], rtol=0, err_msg=f"{what} {f}")
    assert abs(float(tst.time) - float(jst.time)) < 1e-6, what


def _packets_close(jv, tv, what):
    jp, tp = jv._packet(), tv._packet()
    assert (jp is None) == (tp is None), what
    if jp is None:
        return
    assert set(tp) == set(jp) and tp["ncon"] == jp["ncon"], what
    assert abs(tp["time"] - jp["time"]) < 1e-6
    for k, tol in (("qpos", TOL["qpos"]), ("qvel", TOL["qvel"]),
                   ("ctrl", 0.0)):
        np.testing.assert_allclose(tp[k], jp[k], atol=tol, rtol=0,
                                   err_msg=f"{what} {k}")
    assert set(tp["contact_forces"]) == set(jp["contact_forces"])
    for paw, f in jp["contact_forces"].items():
        # a paw force is stiffness x penetration, so it magnifies the
        # states' rounding (6e-4 N apart after 25 ticks on the CPU)
        np.testing.assert_allclose(tp["contact_forces"][paw], f,
                                   atol=2e-2, rtol=1e-3,
                                   err_msg=f"{what} {paw}")


def test_step_push_twist_teleport_match_jax(viewers):
    jv, tv = viewers
    _packets_close(jv, tv, "before the first tick")
    _close(jv.step_once(5), tv.step_once(5), "5 ticks")
    _packets_close(jv, tv, "5 ticks")
    for v in viewers:
        v.apply_wrench(force=(8.0, 0.0, 0.0), duration_s=0.1)
    _close(jv.step_once(3), tv.step_once(3), "push")
    for v in viewers:
        v.apply_wrench(torque=(0.0, 0.0, 0.5), duration_s=0.1)
    _close(jv.step_once(4), tv.step_once(4), "push, then twist")
    _packets_close(jv, tv, "twist")
    q = np.asarray(jv.snapshot().qpos).copy()
    qd = np.asarray(jv.snapshot().qvel).copy()
    q[2], qd[0] = 0.3, 0.2
    for v in viewers:
        v.set_state(qpos=q, qvel=qd)
    _packets_close(jv, tv, "set_state")
    np.testing.assert_array_equal(tv.snapshot().qpos.numpy(), q)
    _close(jv.step_once(3), tv.step_once(3), "after set_state")
    _packets_close(jv, tv, "after set_state")


def test_snapshot_is_a_host_copy(viewers):
    _, tv = viewers
    st = tv.snapshot()
    assert st.qpos.device.type == "cpu"
    st.qpos[2] = 5.0
    assert float(tv.snapshot().qpos[2]) != 5.0


def test_step_once_needs_pause():
    m = load_opendog("flat", device="cpu")
    v = SimViewer(m, make_state(m, "home"), lambda st, t: m.key_ctrl[0],
                  telemetry_port=0, device="cpu")
    try:
        with pytest.raises(RuntimeError):
            v.step_once(1)
    finally:
        v.close()


def test_cli_gives_the_jax_replies():
    """tests/test_viewer.py:107-124's commands on both CLIs' viewers, not
    launched (so that no loop advances time between commands)."""
    jv = jcli.build_viewer("opendog")
    tv = viewer_cli.build_viewer("opendog", device="cpu")
    try:
        for line in ("p", "s 2", "push 5 0 0", "s 1", "twist 0 0 0.5",
                     "s 1", "drop 0.25", "state", "s 1", "state", "r", "q",
                     "bogus", ""):
            assert viewer_cli.handle(tv, line) == jcli.handle(jv, line), line
    finally:
        jv.close()
        tv.close()


def test_mjpeg_frame_is_a_jpeg_and_video_records(tmp_path):
    tv = viewer_cli.build_viewer("opendog", device="cpu")
    try:
        port = tv.start_mjpeg(port=0)
        assert port > 0
        jpg = urllib.request.urlopen(f"http://127.0.0.1:{port}/frame",
                                     timeout=30).read()
        assert jpg[:2] == b"\xff\xd8"
        path = str(tmp_path / "viewer.gif")
        assert tv.render_video(path, seconds=0.2, fps=10) == 2
        assert (tmp_path / "viewer.gif").stat().st_size > 1000
    finally:
        tv.close()


def test_launched_viewer_streams_to_the_jax_client():
    """The loop thread steps and the UDP server streams the schema to the
    JAX package's client (tests/test_viewer.py's first test)."""
    from opendog_tpu.telemetry import TelemetryClient

    tv = viewer_cli.build_viewer("opendog", rate_hz=100.0, device="cpu")
    tv.launch()
    client = TelemetryClient("127.0.0.1", tv.server.port).connect()
    try:
        pkts = []
        for _ in range(200):
            p = client.recv()
            if p is not None:
                pkts.append(p)
            if len(pkts) >= 3 and pkts[-1]["time"] > pkts[0]["time"]:
                break
        assert len(pkts) >= 3 and pkts[-1]["time"] > pkts[0]["time"]
        assert set(pkts[0]) == {"time", "qpos", "qvel", "ctrl",
                                "contact_forces", "ncon"}
        assert len(pkts[0]["qpos"]) == 7 and len(pkts[0]["ctrl"]) == 8
    finally:
        client.close()
        tv.close()
