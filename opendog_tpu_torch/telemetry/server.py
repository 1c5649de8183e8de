"""Sim telemetry UDP/msgpack server.

Behavioural port of the reference's viewer-embedded telemetry server
(``Code/mujoco/wireless_comunication/server.py``): waits for a client hello
datagram, registers the sender (server.py:54-58), then streams msgpack dicts
at a fixed rate with the same schema (server.py:108-118):
  time, qpos (trunk 7), qvel (trunk 6), ctrl, per-paw contact forces
  {FL,FR,BL,BR}, ncon.

Instead of locking a live MuJoCo viewer, the server reads from a
``SimSource`` callback that the owner (viewer loop, env runner, MPC loop)
updates — lock-free snapshot via an atomic swap.

The JAX package's ``telemetry/server.py``, writing with the plain-Python
encoder of :mod:`.wire`, which gives ``msgpack.packb(packet,
use_bin_type=True)``'s bytes.
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from . import wire

PAW_KEYS = ("FL", "FR", "BL", "BR")


def simulation_packet(
    sim_time: float,
    qpos,
    qvel,
    ctrl,
    paw_forces,  # (4, 3) world-frame forces in FL,FR,BL,BR order
    ncon: int,
) -> Dict:
    """Build the wire dict (schema parity with server.py:108-118)."""
    qpos = np.asarray(qpos, dtype=float)
    qvel = np.asarray(qvel, dtype=float)
    return {
        "time": float(sim_time),
        "qpos": qpos[:7].tolist(),
        "qvel": qvel[:6].tolist(),
        "ctrl": np.asarray(ctrl, dtype=float).tolist(),
        "contact_forces": {
            k: np.asarray(f, dtype=float).tolist()
            for k, f in zip(PAW_KEYS, paw_forces)
        },
        "ncon": int(ncon),
    }


class TelemetryServer:
    """30 Hz default stream rate (server.py:20,27)."""

    def __init__(
        self,
        source: Callable[[], Optional[Dict]],
        host: str = "0.0.0.0",
        port: int = 9870,
        rate_hz: float = 30.0,
    ):
        self.source = source
        self.addr = (host, port)
        self.period = 1.0 / rate_hz
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(self.addr)
        self._sock.settimeout(0.2)
        self._client = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def start_server(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        # wait for the client hello (server.py:54-58)
        while not self._stop.is_set() and self._client is None:
            try:
                _, addr = self._sock.recvfrom(1024)
                self._client = addr
            except socket.timeout:
                continue
            except OSError:
                return
        next_t = time.time()
        while not self._stop.is_set():
            packet = self.source()
            if packet is not None and self._client is not None:
                try:
                    self._sock.sendto(
                        wire.dumps(packet), self._client
                    )
                except OSError:
                    pass
            next_t += self.period
            time.sleep(max(0.0, next_t - time.time()))

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        self._sock.close()
