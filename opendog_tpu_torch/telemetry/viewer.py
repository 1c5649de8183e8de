"""Simulation viewer service — the reference's forked interactive viewer
with the embedded telemetry server (``test/viewer.py:382-387``), headless.

Port of the JAX package's ``telemetry/viewer.py``.  Runs a physics/control
loop in a thread, streams the msgpack telemetry schema over UDP
(``wireless_comunication/server.py``) and can dump rendered frames /
videos on demand.

Interactive surface (the displayless analog of the GUI viewer's
pause/step/perturb controls):
  * ``pause()`` / ``resume()`` / ``step_once(n)`` — freeze the loop and
    single-step it (the viewer's space/right-arrow);
  * ``apply_wrench(force, torque, duration_s)`` — external trunk wrench
    integrated as velocity impulses per tick (the viewer's mouse drag;
    approximation documented at the method);
  * ``set_state(qpos, qvel)`` — teleport (the viewer's joint sliders);
  * ``start_mjpeg(port)`` — live MJPEG HTTP stream of the rendered frame
    (multipart/x-mixed-replace, the camera firmware's stream pattern,
    esp32cam.ino:70-126), so a browser is the display.
A keyboard CLI driver lives in ``apps/viewer_cli.py``.

The viewer steps the op-graph step (``physics/dynamics.py::step`` with
``n_substeps=frame_skip``) and reads the paws' forces with
``foot_contact_summary``.  It runs on CUDA unless the caller passes
``device="cpu"``.  The JAX viewer jits its step; here, on CUDA, each tick
(the step and the paws' forces) replays one CUDA graph
(:class:`~..solvers.graph.GraphedTick`), captured at the first tick:
eager, a 10-substep OpenDOG tick issues ~12,000 small kernels from the
host.  ``ctrl_fn`` runs in Python outside the graph.  The viewer's work
runs on a CUDA stream of its own, from whichever thread calls it (the
loop's, the telemetry server's, the caller's).  The state lives on the
device; the wrench impulse and ``set_state`` write into its tensors in
place, and :meth:`snapshot` reads it to host memory.
"""
from __future__ import annotations

import contextlib
import io
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..physics import State, dynamics
from ..solvers.graph import GraphedTick
from .server import TelemetryServer, simulation_packet


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class SimViewer:
    def __init__(
        self,
        model,
        initial_state: State,
        ctrl_fn: Callable[[State, float], torch.Tensor],
        rate_hz: float = 50.0,
        frame_skip: int = 10,
        telemetry_port: int = 9870,
        device=None,
        graphs: bool = True,
    ):
        """``graphs=False`` steps eagerly on CUDA too (the same
        operations: bit for bit the replayed tick)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.state = State(*(torch.as_tensor(x, dtype=torch.float32).to(
            self.device).clone() for x in (initial_state.qpos,
                                           initial_state.qvel,
                                           initial_state.time)))
        self.ctrl_fn = ctrl_fn
        self.period = 1.0 / rate_hz
        self.frame_skip = frame_skip
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._last_contact = None    # (paw forces (nfeet, 3), ncon)
        self._stream = None
        self._graph = None
        self._graphs = graphs and self.device.type == "cuda"
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self.server = TelemetryServer(
            self._packet, port=telemetry_port
        )
        self._thread: Optional[threading.Thread] = None
        # interactive state
        self._paused = threading.Event()
        self._wrench = None          # (force(3), torque(3), ticks_left)
        self._mjpeg = None           # http.server instance
        self._mjpeg_thread = None
        self._mass = float(np.sum(self.model.numpy("body_mass")))
        self._inv_inertia = np.linalg.inv(       # the trunk's, body 0
            self.model.numpy("body_inertia")[0] + 1e-9 * np.eye(3))
        # FL, FR, BL, BR ordering for the wire schema: our foot order is
        # model-dependent; map via body names
        names = [self.model.body_names[b] for b in self.model.foot_body]
        order = []
        for want in ("FL", "FR", "BL", "BR", "RL", "RR"):
            for i, n in enumerate(names):
                if n.startswith(want) and i not in order:
                    order.append(i)
        self._paw_order = (order + list(range(len(names))))[:4]

    def _on_stream(self):
        """The viewer's device and stream, from any thread."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _advance(self, qpos, qvel, t, ctrl):
        """One control tick of physics: ``frame_skip`` substeps, then the
        paws' world forces and the number of geoms in contact."""
        st, info = dynamics.step(self.model, State(qpos=qpos, qvel=qvel,
                                                   time=t),
                                 ctrl, n_substeps=self.frame_skip)
        fw, _, _ = dynamics.foot_contact_summary(self.model, info.contact)
        return st.qpos, st.qvel, st.time, fw, info.contact.in_contact.sum()

    def _packet(self):
        with self._lock, self._on_stream():
            st, last = self.state, self._last_contact
            if last is None:
                return None
            qpos, qvel, t = _host(st.qpos), _host(st.qvel), float(st.time)
            fw, ncon = _host(last[0]), int(last[1])
            ctrl = _host(self.ctrl_fn(st, t))
        return simulation_packet(t, qpos, qvel, ctrl, fw[self._paw_order],
                                 ncon)

    def launch(self):
        """Start the sim loop + telemetry server (viewer.launch parity)."""
        self.server.start_server()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _tick_once(self):
        """One control tick: pending wrench impulse + controller + step."""
        with self._lock, self._on_stream():
            st = self.state
            if self._wrench is not None:
                f, tau, left = self._wrench
                dt = float(self.model.timestep) * self.frame_skip
                dv = f * np.float32(dt / self._mass)
                dw = (self._inv_inertia @ tau * dt).astype(np.float32)
                st.qvel[:6] += torch.from_numpy(
                    np.concatenate([dv, dw])).to(self.device)
                self._wrench = (f, tau, left - 1) if left > 1 else None
            ctrl = self.ctrl_fn(st, float(st.time))
            if not self._graphs:
                out = self._advance(st.qpos, st.qvel, st.time, ctrl)
            else:
                if self._graph is None:
                    self._graph = GraphedTick(
                        self._advance, (st.qpos, st.qvel, st.time, ctrl),
                        self.device)
                # the graph's outputs are static: keep copies
                out = [x.clone() for x in self._graph(st.qpos, st.qvel,
                                                      st.time, ctrl)]
            self.state = State(qpos=out[0], qvel=out[1], time=out[2])
            self._last_contact = (out[3], out[4])

    def _loop(self):
        next_t = time.time()
        while not self._stop.is_set():
            if self._paused.is_set():
                next_t = time.time()
                time.sleep(0.01)
                continue
            self._tick_once()
            next_t += self.period
            time.sleep(max(0.0, next_t - time.time()))

    # ---------------- interactive surface ------------------------------
    def pause(self):
        """Freeze the sim loop (telemetry/MJPEG keep serving the frozen
        state) — the GUI viewer's spacebar."""
        self._paused.set()

    def resume(self):
        self._paused.clear()

    @property
    def paused(self) -> bool:
        return self._paused.is_set()

    def step_once(self, n: int = 1):
        """Advance ``n`` control ticks while paused (right-arrow)."""
        if not self.paused:
            raise RuntimeError("step_once is for the paused state")
        for _ in range(n):
            self._tick_once()
        return self.snapshot()

    def apply_wrench(self, force=(0.0, 0.0, 0.0), torque=(0.0, 0.0, 0.0),
                     duration_s: float = 0.1):
        """External trunk wrench for ``duration_s`` (the viewer's mouse
        perturbation).  Approximation: integrated as per-tick velocity
        impulses on the free joint (linear: F/m_total; angular: trunk
        inertia^-1 tau in the qvel[3:6] frame) rather than as a force term
        inside the dynamics — equivalent for perturbation purposes at
        50 Hz tick granularity."""
        ticks = max(1, int(round(duration_s / self.period)))
        with self._lock:
            self._wrench = (np.asarray(force, np.float32),
                            np.asarray(torque, np.float32), ticks)

    def set_state(self, qpos=None, qvel=None):
        """Teleport (the viewer's joint sliders / reset)."""
        with self._lock, self._on_stream():
            for dst, src in ((self.state.qpos, qpos),
                             (self.state.qvel, qvel)):
                if src is not None:
                    dst.copy_(torch.as_tensor(np.asarray(src, np.float32)))
            self._last_contact = None

    # ---------------- MJPEG display stream -----------------------------
    def render_jpeg(self, plane: str = "xz", xlim=None) -> bytes:
        """Render the current state to one JPEG frame."""
        from PIL import Image

        from ..utils.render import _plt, render_frame

        plt = _plt()
        st = self.snapshot()
        x = float(st.qpos[0])
        lim = xlim or (x - 0.8, x + 0.8)
        fig, ax = plt.subplots(figsize=(6, 3.2), dpi=80)
        try:
            render_frame(self.model, st, ax=ax, plane=plane, xlim=lim)
            fig.canvas.draw()
            img = Image.fromarray(np.asarray(fig.canvas.buffer_rgba()))
            jb = io.BytesIO()
            img.convert("RGB").save(jb, "JPEG", quality=80)
            return jb.getvalue()
        finally:
            plt.close(fig)

    def start_mjpeg(self, port: int = 8081, fps: float = 10.0) -> int:
        """Serve ``/stream`` as multipart/x-mixed-replace MJPEG and
        ``/frame`` as a single JPEG — the camera firmware's HTTP pattern
        (esp32cam.ino:70-126) reused as the headless viewer's display.
        Returns the port it serves on (``port=0`` takes a free one)."""
        import http.server

        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/frame"):
                    jpg = viewer.render_jpeg()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpg)))
                    self.end_headers()
                    self.wfile.write(jpg)
                    return
                if not self.path.startswith("/stream"):
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace;boundary=frame")
                self.end_headers()
                try:
                    while not viewer._stop.is_set():
                        jpg = viewer.render_jpeg()
                        self.wfile.write(b"--frame\r\n")
                        self.wfile.write(b"Content-Type: image/jpeg\r\n")
                        self.wfile.write(
                            f"Content-Length: {len(jpg)}\r\n\r\n".encode())
                        self.wfile.write(jpg)
                        self.wfile.write(b"\r\n")
                        time.sleep(1.0 / fps)
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self._mjpeg = http.server.ThreadingHTTPServer(("0.0.0.0", port),
                                                      Handler)
        self._mjpeg_thread = threading.Thread(
            target=self._mjpeg.serve_forever, daemon=True)
        self._mjpeg_thread.start()
        return self._mjpeg.server_address[1]

    def snapshot(self) -> State:
        """The viewer's state, read to host memory (CPU tensors)."""
        with self._lock, self._on_stream():
            st = self.state
            return State(*(x.to("cpu", copy=True)
                           for x in (st.qpos, st.qvel, st.time)))

    def render_video(self, path: str, seconds: float = 2.0, fps: int = 25):
        from ..utils.render import record_rollout

        states = []
        n = int(seconds * fps)
        for _ in range(n):
            states.append(self.snapshot())
            time.sleep(1.0 / fps)
        return record_rollout(self.model, states, path, fps=fps)

    def close(self):
        self._stop.set()
        if self._mjpeg is not None:
            self._mjpeg.shutdown()
            self._mjpeg.server_close()
            self._mjpeg = None
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        self.server.stop()
