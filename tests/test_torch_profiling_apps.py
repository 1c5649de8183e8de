"""The port's profiling and compilation-cache counterparts
(``opendog_tpu_torch/utils/profiling.py``, ``compile_cache.py``) and its
copies of the JAX-free apps (``calibration``, ``dashboard``, ``imu_viz``,
``camera_viewer``) against the JAX package on the JAX tests' inputs:
``count_flops`` gives the JAX counts exactly (tests/test_infra.py:183-203's
48 and 120, and more ops), the copies give equal outputs."""
import json
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendog_tpu.apps import calibration as jcal
from opendog_tpu.apps import dashboard as jdash
from opendog_tpu.apps import imu_viz as jimu
from opendog_tpu.utils import profiling as jprof
from opendog_tpu_torch.apps import calibration, dashboard, imu_viz
from opendog_tpu_torch.ops import build
from opendog_tpu_torch.utils import compile_cache, profiling

torch.set_num_threads(1)

# (torch function, its JAX twin, input shapes)
FLOP_CASES = {
    "sqrt": (lambda a, b: torch.sqrt(a * b + a),
             lambda a, b: jnp.sqrt(a * b + a), [(8,), (8,)]),
    "mm": (lambda x, w: x @ w, lambda x, w: x @ w, [(4, 5), (5, 3)]),
    "addmm": (lambda x, w, b: torch.nn.functional.linear(x, w, b),
              lambda x, w, b: x @ w.T + b, [(4, 5), (3, 5), (3,)]),
    "bmm": (lambda x, w: torch.bmm(x, w),
            lambda x, w: jnp.einsum("bik,bkj->bij", x, w),
            [(2, 4, 5), (2, 5, 3)]),
    "transcendental": (lambda a, b: torch.tanh(a) + torch.exp(b) * torch.log(b),
                       lambda a, b: jnp.tanh(a) + jnp.exp(b) * jnp.log(b),
                       [(3, 7), (3, 7)]),
    "minmax": (lambda a, b: torch.maximum(a, b) - torch.minimum(a, -b).abs(),
               lambda a, b: jnp.maximum(a, b) - jnp.abs(jnp.minimum(a, -b)),
               [(6,), (6,)]),
}


@pytest.mark.parametrize("name", sorted(FLOP_CASES))
def test_count_flops_equals_jax(name):
    fn, jfn, shapes = FLOP_CASES[name]
    rng = np.random.default_rng(0)
    args = [rng.uniform(0.5, 1.5, s).astype(np.float32) for s in shapes]
    got = profiling.count_flops(fn, *(torch.from_numpy(a) for a in args))
    assert got == jprof.count_flops(jfn, *(jnp.asarray(a) for a in args))
    assert got > 0


def test_count_flops_of_the_infra_test():
    """tests/test_infra.py:183-203's numbers."""
    assert profiling.count_flops(lambda a, b: torch.sqrt(a * b + a),
                                 torch.ones(8), torch.ones(8)) == 48
    assert profiling.count_flops(lambda x, w: x @ w, torch.ones(4, 5),
                                 torch.ones(5, 3)) == 120


def test_roofline_reads_the_h100_peaks():
    peaks = profiling.CHIP_PEAKS["h100"]
    assert peaks == dict(fp32_flops=67e12, hbm_bytes=3.35e12)
    r = profiling.roofline(measured_s=1e-3, flops=67e9, bytes_moved=6.7e8,
                           chip="h100")
    assert abs(r.flops_bound_s - 1e-3) < 1e-15
    assert abs(r.hbm_bound_s - 2e-4) < 1e-15
    assert abs(r.pct_of_compute_sol - 100.0) < 1e-9
    assert "SoL" in r.report()


def test_substep_bound_gives_the_kernel_tables_counts():
    """``substep_bound`` at the Go1 rollout's shape (K=256 x2 at 10 ms) on
    the flat and the payload kernels gives the kernel table's operations
    and bytes (PERF.md), bound by operations; ``substep_row`` has the keys
    of a row of chip_smoke.py's ``kernels`` line."""
    from opendog_tpu_torch.assets import load_go1
    m = load_go1("flat", device="cpu")
    K = 256
    args = [torch.zeros(m.nq, K), torch.zeros(m.nv, K), torch.zeros(m.nu, K),
            None]
    for payload, ops, nbytes in ((None, 25_131_520, 88_064),
                                 (torch.zeros(1, K), 25_134_080, 89_088)):
        bound = profiling.substep_bound(m, 0.01, 2, (False, payload is not
                                                     None), args + [payload])
        assert bound == (1e3 * ops / 67e12, "operations", ops, nbytes)
    row = profiling.substep_row("substep_payload (rollout)", 25, 0.0, 0.06,
                                1262.4, bound)
    assert set(row) == {"name", "route", "source", "replaces", "launches",
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms"}
    assert row["source"] == "opendog_tpu_torch/csrc/substep_warp.cuh"
    assert row["replaces"] == "opendog_tpu/ops/pallas_step.py:115"
    assert (row["bound_ms"], row["library_ms"]) == (bound[0], None)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert any("mm" in e.key for e in prof.key_averages())


def test_compile_cache_is_the_kernel_build_directory():
    assert compile_cache.enable() == build.BUILD_DIR
    assert os.path.isdir(build.BUILD_DIR)
    assert compile_cache.enable() == build.BUILD_DIR


def test_calibration_copy_gives_jax_outputs():
    """tests/test_calibration_nnvis.py's cases on both packages."""
    g, jg = calibration.PIDGains(), jcal.PIDGains()
    for args in ((5, 0, 0.0, 0.002), (1000, 0, 0.0, 0.002),
                 (40, -0.05, 0.0, 0.002), (60, -0.05, 0.0, 0.002),
                 (-300, 12.0, 4.0, 0.002)):
        assert calibration.firmware_power(g, *args) == \
            jcal.firmware_power(jg, *args)
    for kw in (dict(target_deg=45.0, duration_s=2.0, noise_std=0.5),
               dict(target_deg=45.0, duration_s=1.0)):
        out = calibration.simulate_pid_response(**kw)
        jout = jcal.simulate_pid_response(**kw)
        for k in jout:
            np.testing.assert_array_equal(out[k], jout[k], err_msg=k)
        assert calibration.analyze_response(out["time"], out["angle_deg"],
                                            45.0) == \
            jcal.analyze_response(jout["time"], jout["angle_deg"], 45.0)
    bad = dict(target_deg=45.0, duration_s=1.0)
    out = calibration.simulate_pid_response(
        gains=calibration.PIDGains(p=0.02, i=0.0, d=0.0), **bad)
    jout = jcal.simulate_pid_response(gains=jcal.PIDGains(p=0.02, i=0.0,
                                                          d=0.0), **bad)
    np.testing.assert_array_equal(out["angle_deg"], jout["angle_deg"])


class _FakeBody:
    """tests/test_apps_extra.py:97's stand-in body."""

    def get_latest_motor_data_for_esp(self, i):
        return {"angles": [1.0, 2, 3, 4], "targetPos": [10, 20, 30, 40],
                "encoderPos": [9, 19, 29, 39],
                "esp_control_fully_enabled": True}

    def get_latest_dmp_data_for_esp(self, i):
        return {"ypr_deg": {"yaw": 5.0, "pitch": 0.0, "roll": -2.0}}


def test_dashboard_copy_gives_jax_outputs():
    snap = dashboard.snapshot_from_body(_FakeBody())
    assert snap == jdash.snapshot_from_body(_FakeBody())
    text = dashboard.render_terminal_dashboard(snap)
    assert text == jdash.render_terminal_dashboard(snap)
    assert "ESP0" in text and "yaw=   5.00" in text
    server, thread = dashboard.serve_web_dashboard(lambda: snap)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/data",
                                    timeout=10) as r:
            assert json.loads(r.read()) == json.loads(json.dumps(snap))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=10) as r:
            assert b"OpenDOG" in r.read()
    finally:
        server.shutdown()
        server.server_close()


def test_imu_viz_copy_gives_jax_outputs(tmp_path):
    """tests/test_scope_imu.py:46-81's inputs on both packages."""
    for v in ([0, 0, 1], [1, 0, 0], [0, 1, 0], [3, 4, 0], [0, 0, 0],
              [2.0, -1.0, 9.81]):
        np.testing.assert_array_equal(imu_viz.project_vector(v),
                                      jimu.project_vector(v))
        np.testing.assert_array_equal(imu_viz.normalize(v),
                                      jimu.normalize(v))
        assert imu_viz.render_terminal(v) == jimu.render_terminal(v)
    samples = [{"accel_x": 0.0, "accel_y": 0.0, "accel_z": 9.81},
               {"accel_x": 2.0, "accel_y": -1.0}, None]
    seen = []
    for mod in (imu_viz, jimu):
        it = iter(samples)
        frames = []
        last = mod.run(lambda: next(it), n_frames=3, period_s=0.0,
                       on_frame=lambda v: frames.append(v.copy()))
        seen.append((frames, last))
    for a, b in zip(seen[0][0], seen[1][0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(seen[0][1], [0, 0, 0])
    imu_viz.render_png([1.0, 2.0, 3.0], str(tmp_path / "imu.png"))
    assert (tmp_path / "imu.png").stat().st_size > 1000


def test_camera_viewer_runs_on_the_ports_camera_client():
    """CameraViewer over the port's urllib QuadPilotCamera against a stub
    MJPEG stream: frames reach the sink, framesize switching answers."""
    import http.server
    import threading

    from opendog_tpu_torch.apps.camera_viewer import CameraViewer
    from opendog_tpu_torch.sdk.camera import QuadPilotCamera

    jpeg = b"\xff\xd8" + b"\x00" * 64 + b"\xff\xd9"

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            if self.path.startswith("/stream"):
                self.send_header("Content-Type",
                                 "multipart/x-mixed-replace;boundary=frame")
                self.end_headers()
                for _ in range(5):
                    self.wfile.write(b"--frame\r\nContent-Type: image/jpeg"
                                     b"\r\n\r\n" + jpeg + b"\r\n")
                return
            self.end_headers()
            self.wfile.write(b"OK")

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    frames = []
    cam = QuadPilotCamera("127.0.0.1", port=server.server_address[1])
    viewer = CameraViewer(cam, sink=lambda b, i: frames.append(b))
    try:
        assert viewer.change_framesize("VGA")
        viewer.start()
        viewer._thread.join(timeout=10)
        assert not viewer._thread.is_alive()
        assert frames and all(f == jpeg for f in frames)
        assert viewer.status == "stream ended"
    finally:
        viewer.stop()
        server.shutdown()
        server.server_close()
