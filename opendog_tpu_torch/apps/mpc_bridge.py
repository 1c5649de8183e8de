"""MPC over the wire — the north-star controller driving the robot endpoint.

Port of the JAX package's ``apps/mpc_bridge.py``.  Closes the deepest
full-stack path of the reference (``sim2real/run_robot.py:252-263``: NN →
UDP → firmware → telemetry → NN) with the MPC solver in the policy seat:

    RealtimeController.bridge_tick  (pipelined MPPI solve, solvers/mpc.py)
      → Calibration.sim_rad_to_real_deg → QuadPilotBody.set_angles  (UDP/JSON)
        → C++ firmware_sim 500 Hz PID servo  (native/firmware_sim)
          → broadcast telemetry  (20-100 Hz JSON)
            → measured real-deg angles → DigitalTwin body-state estimate
              → next bridge_tick

The two C++ firmware simulators ARE the joint plant (encoder/PID servo
dynamics over the real wire protocol); the ``DigitalTwin`` supplies the
trunk/body state the firmware cannot observe, advanced by the measured joint
angles exactly as ``sim2real/view.py:268-284`` drives the sim from live
encoders.  Every command crosses the UDP/JSON protocol with ACK+retry —
nothing is short-circuited in Python.

The controller, the twin and the student run on CUDA unless the caller
passes ``device="cpu"``.  On CUDA the twin replays its advance from a CUDA
graph on a stream of its own (:mod:`..sim2real.twin`), beside the
controller's pipelined solve on the default stream.

Metrics: p99 host-blocking time per tick of a loop paced at ``rate_hz``,
and joint tracking error between commanded and telemetry-measured degrees
(reported at the servo delay that minimises it, plus the zero-delay raw
value).

Run against two firmware simulators on loopback:
``python -m opendog_tpu_torch.apps.mpc_bridge --spawn_firmware --lag 3
--compensate``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..sim2real.calibration import Calibration
from ..sim2real.twin import DigitalTwin

BRING_UP_PID = dict(P=0.9, I=0.001, D=0.3, dead_zone=10, pos_thresh=5)
# run_robot.py:300-307 bring-up: params -> pins -> reset -> enable


def read_measured_angles(body) -> Optional[np.ndarray]:
    """Latest 8 real-deg angles (calibration order: motors 0-3 on ESP0,
    4-7 on ESP1 — body.py:55-60)."""
    m0 = body.get_latest_motor_data_for_esp(0)
    m1 = body.get_latest_motor_data_for_esp(1)
    if not (m0 and m1):
        return None
    return np.asarray(list(m0["angles"]) + list(m1["angles"]), np.float32)


class MPCBridge:
    """Wire-level MPC control loop against two firmware endpoints.

    The twin runs on ``device``: the controller's device when the caller
    names none (CUDA for a controller without one)."""

    def __init__(self, model, controller, body, telemetry_interval_ms=10,
                 device=None):
        if device is None:
            device = getattr(controller, "device", None)
        self.device = resolve_device(device)
        self.model = model
        self.controller = controller
        self.body = body
        self.cal = Calibration(model)
        self.twin = DigitalTwin(model, device=self.device)
        self.telemetry_interval_ms = telemetry_interval_ms
        self._commanded = []   # per-tick commanded deg (calibration order)
        self._measured = []    # per-tick measured deg at command time

    # -- bring-up (run_robot.py:300-307 sequence over the real protocol) --
    def bring_up(self, settle_s: float = 1.0,
                 sleep_fn: Callable[[float], None] = time.sleep) -> bool:
        b = self.body
        ok = b.set_control_params(**BRING_UP_PID)
        ok &= b.set_all_pins([(1, 2, 3, 4)] * 8)
        ok &= b.reset_all()
        ok &= b.set_all_control_status(True)
        ok &= b.set_send_interval(self.telemetry_interval_ms)
        # command the home stance and let the servos converge: encoder zero
        # at firmware start is the home pose by convention (the real robot
        # is powered on standing; REAL_HOME_DEG offsets are relative to it),
        # so home targets = calibration home degrees
        ok &= b.set_angles(self.cal.real_home_deg.tolist())
        sleep_fn(settle_s)
        return bool(ok)

    def _estimate_state(self):
        """Measured joints -> twin body state (view.py:268-284 semantics)."""
        angles = read_measured_angles(self.body)
        if angles is not None:
            self.twin.mirror_once(angles, substeps=10)
            self._measured.append(angles)
        else:
            self._measured.append(np.full(8, np.nan, np.float32))
        st = self.twin.snapshot()
        return st.qpos.numpy(), st.qvel.numpy(), float(st.time)

    def _command(self, ctrl) -> np.ndarray:
        """Sim ctrl radians -> calibrated real degrees -> set_angles."""
        sim = np.asarray(ctrl, np.float32)[self.cal.model_actuator_index]
        deg = self.cal.real_home_deg + self.cal.scale * np.degrees(
            sim - self.cal.sim_home_rad)
        self.body.set_angles(deg.tolist())
        # firmware int-rounds degrees (ino:174-182) — record what it got
        self._commanded.append(np.asarray(np.round(deg), np.float32))
        return deg

    def tick(self) -> np.ndarray:
        """One wire tick: estimate -> solve (pipelined) -> command."""
        qpos, qvel, t = self._estimate_state()
        ctrl = self.controller.bridge_tick(qpos, qvel, t)
        return self._command(ctrl)

    def run(self, n_ticks: int, rate_hz: float = 50.0, paced: bool = True,
            sleep_fn: Callable[[float], None] = time.sleep) -> dict:
        # fresh tracking window: metrics describe THIS run only, not
        # bring-up/priming ticks or earlier runs
        self._commanded.clear()
        self._measured.clear()
        period = 1.0 / rate_hz
        lat = np.zeros(n_ticks)
        overruns = 0
        next_t = time.perf_counter()
        for i in range(n_ticks):
            next_t += period
            t0 = time.perf_counter()
            self.tick()
            lat[i] = time.perf_counter() - t0
            if paced:
                rest = next_t - time.perf_counter()
                if rest > 0:
                    sleep_fn(rest)
                else:
                    overruns += 1
                    next_t = time.perf_counter()
        self.controller.drain()
        return self.metrics(lat, overruns, rate_hz)

    def metrics(self, lat: np.ndarray, overruns: int, rate_hz: float) -> dict:
        cmd = np.asarray(self._commanded)
        meas = np.asarray(self._measured)
        n = min(len(cmd), len(meas))
        cmd, meas = cmd[:n], meas[:n]
        # measured(t) responds to commands a few ticks back (wire + servo +
        # telemetry delay): report tracking error at the delay minimising it
        errs = {}
        for d in range(0, 9):
            if n - d - 1 <= 2:
                break
            e = meas[d + 1:] - cmd[1:n - d]  # meas[k+d+1] tracks cmd[k+1]
            e = e[np.isfinite(e).all(axis=1)]
            if len(e):
                errs[d] = float(np.sqrt(np.mean(e ** 2)))
        best_d = min(errs, key=errs.get) if errs else -1
        qpos = self.twin.snapshot().qpos.numpy()
        budget_ms = 1e3 / rate_hz
        p99 = float(np.percentile(lat, 99) * 1e3)
        return {
            "ticks": int(len(lat)),
            "rate_hz": rate_hz,
            "host_blocking_p99_ms": round(p99, 2),
            "host_blocking_median_ms": round(float(np.median(lat) * 1e3), 2),
            "host_blocking_max_ms": round(float(lat.max() * 1e3), 2),
            "meets_budget": bool(p99 < budget_ms),
            "overruns": int(overruns),
            "joint_track_rmse_deg": round(errs.get(best_d, float("nan")), 3),
            "joint_track_delay_ticks": int(best_d),
            "joint_track_rmse_deg_delay0": round(errs.get(0, float("nan")),
                                                 3),
            "control_delay_ticks": int(self.controller.lag),
            "compensated": bool(getattr(self.controller, "compensate",
                                        False)),
            "twin_final_x": round(float(qpos[0]), 4),
            "twin_trunk_z": round(float(qpos[2]), 4),
            "twin_healthy": bool(0.035 < qpos[2] < 0.12),
        }


def make_bridge(body, lag: int = 1, num_samples: int = 256,
                engine: str = "kernel", seed: int = 0,
                compensate: bool = False, device=None) -> MPCBridge:
    """Standard OpenDOG trot-MPC bridge (the distill-zoo recipe's cost):
    MPPI at K=``num_samples``, H=25, 2 x 10 ms on ``engine`` ("kernel":
    the flat substep kernel; "ops": the op-graph step), on ``device``.

    ``compensate``: delay-compensated solves — each plan starts from the
    state predicted at its actual application time (RealtimeController
    ``compensate``)."""
    from dataclasses import replace

    from ..rl.distill_zoo import trot_distill_setup
    from ..solvers.mpc import RealtimeController

    device = resolve_device(device)
    setup = trot_distill_setup("opendog", engine=engine, device=device)
    cfg = replace(setup.mppi_config, num_samples=num_samples)
    rtc = RealtimeController(
        setup.model, setup.cost, cfg, lag=lag, compensate=compensate,
        device=device,
        generator=torch.Generator(device=device).manual_seed(seed))
    return MPCBridge(setup.model, rtc, body, device=device)


class _PolicyShim:
    """Controller stand-in for a feed-forward policy (no pipeline)."""

    lag = 0
    compensate = False

    def drain(self):
        pass


class StudentBridge(MPCBridge):
    """The distilled COMMAND student in the policy seat: the full
    ``run_robot.py:252-263`` deployment path with live (vx, vy,
    yaw_target) command switching —

        student(obs(twin state) ++ prev_ctrl ++ cmd) + u_ref(t, cmd)
          → Calibration → QuadPilotBody.set_angles (UDP/JSON + ACK)
            → C++ firmware_sim 500 Hz PID servo → telemetry
              → DigitalTwin state estimate → next tick

    ``policy`` is ``distill_zoo.load_student(..., command_dim=3)`` on
    ``device`` (the setup's).  On CUDA it replays one CUDA graph per tick
    (captured at the first), the counterpart of the JAX class's jitted
    policy; its inputs are staged in pinned host memory.  The twin
    supplies the body state the firmware cannot observe (the same
    estimator the MPC bridge rehearses); ``set_command`` switches the
    command mid-run exactly as a gamepad/voice command would."""

    def __init__(self, model, policy, body, telemetry_interval_ms=10,
                 device=None):
        super().__init__(model, _PolicyShim(), body,
                         telemetry_interval_ms=telemetry_interval_ms,
                         device=device)
        self._policy = policy
        lo, hi = model.numpy("actuator_ctrlrange").T
        self._prev = np.clip(model.numpy("key_ctrl")[0].astype(np.float32),
                             lo, hi)
        self.cmd = np.zeros(3, np.float32)
        self._graph = None  # the policy's CUDA graph, made at the first act
        self._staged = None

    def set_command(self, cmd) -> None:
        self.cmd = np.asarray(cmd, np.float32)

    def act(self, qpos, qvel, t: float) -> np.ndarray:
        """The student's control for a state, the previous control and the
        command: ``policy`` on batches of one, read to the host."""
        x = [np.asarray(a, np.float32)[None]
             for a in (qpos, qvel, t, self._prev, self.cmd)]
        if self.device.type != "cuda":
            return self._policy(*map(torch.from_numpy, x))[0].numpy()
        if self._staged is None:
            self._staged = tuple(torch.empty(a.shape, pin_memory=True)
                                 for a in x)
        for buf, a in zip(self._staged, x):
            buf.numpy()[...] = a
        if self._graph is None:
            from ..solvers.graph import GraphedTick
            self._graph = GraphedTick(self._policy, self._staged,
                                      self.device)
        # the read waits for the replay, and so for the staged copies:
        # the next act may refill them
        return self._graph(*self._staged)[0].cpu().numpy()

    def tick(self) -> np.ndarray:
        qpos, qvel, t = self._estimate_state()
        ctrl = self.act(qpos, qvel, t)
        self._prev = ctrl
        return self._command(ctrl)

    def run_segments(self, schedule, rate_hz: float = 50.0,
                     sleep_fn: Callable[[float], None] = time.sleep
                     ) -> dict:
        """Paced loop over ``[(cmd, n_ticks), ...]`` with per-segment
        command tracking measured on the twin (heading-frame speed +
        wrapped yaw error, the soak/eval geometry)."""
        from ..physics import spatial
        from ..utils.cmd_tracking import segment_record

        self._commanded.clear()
        self._measured.clear()
        period = 1.0 / rate_hz
        lat, segments = [], []
        overruns = 0
        next_t = time.perf_counter()
        for cmd, n_ticks in schedule:
            self.set_command(cmd)
            xy, zs = [], []
            for _ in range(n_ticks):
                next_t += period
                t0 = time.perf_counter()
                self.tick()
                lat.append(time.perf_counter() - t0)
                q = self.twin.snapshot().qpos.numpy()
                xy.append(q[:2])
                zs.append(q[2])
                rest = next_t - time.perf_counter()
                if rest > 0:
                    sleep_fn(rest)
                else:
                    overruns += 1
                    next_t = time.perf_counter()
            yaw = float(spatial.euler_from_quat(torch.from_numpy(q[3:7]))[2])
            rec = segment_record(np.asarray(xy), yaw, cmd,
                                 dt_tick=period)
            rec["z_min"] = round(float(np.min(zs)), 4)
            rec["ticks"] = n_ticks
            segments.append(rec)
        lat = np.asarray(lat)
        out = self.metrics(lat, overruns, rate_hz)
        out["segments"] = segments
        return out


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ticks", type=int, default=500)
    p.add_argument("--rate_hz", type=float, default=50.0)
    p.add_argument("--lag", type=int, default=3)
    p.add_argument("--compensate", action="store_true",
                   help="delay-compensated solves (plan from the state "
                        "predicted through the in-flight controls)")
    p.add_argument("--samples", type=int, default=256)
    p.add_argument("--port1", type=int, default=12346)
    p.add_argument("--port2", type=int, default=12347)
    p.add_argument("--listen_port", type=int, default=12345)
    p.add_argument("--out", default=None)
    p.add_argument("--spawn_firmware", action="store_true",
                   help="launch the two C++ firmware sims on loopback")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args()

    import contextlib

    from ..native import build as native
    from ..sdk import QuadPilotBody

    firmware = (native.firmware_pair(args.port1, args.port2,
                                     args.listen_port)
                if args.spawn_firmware else contextlib.nullcontext())
    body = None
    # never leak the spawned firmware (they keep the UDP ports bound)
    with firmware:
        try:
            body = QuadPilotBody(ip1="127.0.0.1", ip2="127.0.0.1",
                                 port1=args.port1, port2=args.port2,
                                 listen_for_broadcasts=True,
                                 listen_port=args.listen_port)
            bridge = make_bridge(body, lag=args.lag,
                                 num_samples=args.samples,
                                 compensate=args.compensate,
                                 device=args.device)
            if not bridge.bring_up():
                raise RuntimeError("bring-up failed (firmware not "
                                   "responding?)")
            # prime the graphs + pipeline off the clock
            for _ in range(bridge.controller.lag + 2):
                bridge.tick()
                time.sleep(1.0 / args.rate_hz)
            m = bridge.run(args.ticks, rate_hz=args.rate_hz)
            print(json.dumps(m))
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                            exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(m, f, indent=1)
        finally:
            if body is not None:
                body.close()


if __name__ == "__main__":
    main()
