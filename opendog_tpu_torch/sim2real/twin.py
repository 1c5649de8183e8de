"""Hardware → simulation digital twin.

Port of the JAX package's ``sim2real/twin.py`` (itself a port of
``sim2real/view.py``): live robot encoder angles drive the sim's actuator
targets so the simulated robot mirrors the physical one
(view.py:268-284).  The channel mapping is the calibration map (the same
real-deg → sim-rad conversion the trained pipeline uses) plus an optional
per-channel sign/offset override table for hardware quirks.

The twin advances the op-graph step (:func:`..physics.dynamics.step`), as
the JAX twin does.  It runs on CUDA unless the caller passes
``device="cpu"``.  On CUDA each substep count's advance (the angle map and
``substeps`` substeps) is one CUDA graph, captured at its first use: the
counterpart of the JAX twin's jitted step per count.  Its input is a static
buffer of angles, filled from pinned host memory; the graph reads nothing
from the host.  It replays on a stream of its own, so that a mirror tick
does not queue behind work the caller has in flight on the default stream
(a controller's pipelined solve).  Only :meth:`snapshot` reads to the host.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..physics import State, dynamics, make_state
from ..solvers.graph import GraphedTick
from .calibration import Calibration


class DigitalTwin:
    def __init__(
        self,
        model,
        sign: Optional[Sequence[float]] = None,
        offset_deg: Optional[Sequence[float]] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cal = Calibration(self.model)
        self.sign = np.asarray(
            sign if sign is not None else np.ones(8), np.float32
        )
        self.offset_deg = np.asarray(
            offset_deg if offset_deg is not None else np.zeros(8), np.float32
        )
        self.state = make_state(self.model, "home")
        self._cal = self.cal.on(self.device)
        self._graphs = {}
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            # the corrected angles of a mirror tick, copied to the card
            # without blocking; the event guards the buffer's reuse
            self._angles = torch.empty(8, pin_memory=True)
            self._copied = torch.cuda.Event()
            self._copied.record(self._stream)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _corrected(self, angles_deg: Sequence[float]) -> np.ndarray:
        return self.sign * np.asarray(angles_deg, np.float32) + \
            self.offset_deg

    def _to_ctrl(self, corrected: torch.Tensor) -> torch.Tensor:
        return self.cal.real_deg_to_sim_rad(corrected)[self._cal["inv"]]

    def real_angles_to_ctrl(self, angles_deg: Sequence[float]) -> torch.Tensor:
        """Real encoder degrees (calibration order) → clamped sim ctrl in
        model order (view.py:268-284 + run.py:60-79), on the twin's
        device."""
        corrected = torch.from_numpy(self._corrected(angles_deg))
        return self._to_ctrl(corrected.to(self.device))

    def _advance(self, substeps: int) -> GraphedTick:
        """The CUDA graph of one ``substeps``-substep advance from the
        corrected angles (one per count, captured at its first use)."""
        if substeps not in self._graphs:
            def fn(qpos, qvel, t, corrected):
                st, _ = dynamics.step(
                    self.model, State(qpos=qpos, qvel=qvel, time=t),
                    self._to_ctrl(corrected), n_substeps=substeps)
                return st.qpos, st.qvel, st.time

            self._graphs[substeps] = GraphedTick(
                fn, (self.state.qpos, self.state.qvel, self.state.time,
                     self._angles), self.device)
        return self._graphs[substeps]

    def mirror_once(self, angles_deg: Sequence[float], substeps: int = 8):
        """Apply one angle snapshot and advance the sim."""
        with self._lock:
            if self._stream is None:
                ctrl = self.real_angles_to_ctrl(angles_deg)
                self.state, _ = dynamics.step(self.model, self.state, ctrl,
                                              n_substeps=substeps)
                return self.state
            with torch.cuda.stream(self._stream):
                self._copied.synchronize()  # the last tick's copy is done
                self._angles.numpy()[:] = self._corrected(angles_deg)
                graph = self._advance(substeps)
                qpos, qvel, t = graph(self.state.qpos, self.state.qvel,
                                      self.state.time, self._angles)
                self._copied.record(self._stream)
            self.state = State(qpos=qpos, qvel=qvel, time=t)
            return self.state

    def snapshot(self) -> State:
        """The twin's state, read to host memory (CPU tensors)."""
        with self._lock:
            st = self.state
            if self._stream is None:
                return State(qpos=st.qpos.clone(), qvel=st.qvel.clone(),
                             time=st.time.clone())
            nq, nv = self.model.nq, self.model.nv
            with torch.cuda.stream(self._stream):
                x = torch.cat([st.qpos, st.qvel, st.time[None]]).cpu()
            return State(qpos=x[:nq], qvel=x[nq:nq + nv], time=x[nq + nv])

    # -- live mirroring from a QuadPilotBody telemetry store --------------
    def start_mirroring(self, body, rate_hz: float = 50.0):
        def loop():
            period = 1.0 / rate_hz
            while not self._stop.is_set():
                m0 = body.get_latest_motor_data_for_esp(0)
                m1 = body.get_latest_motor_data_for_esp(1)
                if m0 and m1:
                    angles = list(m0["angles"]) + list(m1["angles"])
                    self.mirror_once(angles)
                time.sleep(period)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
