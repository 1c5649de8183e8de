"""QuadPilotBody — host-side SDK for the two-ESP motor-controller robot.

A copy of the JAX package's ``sdk/body.py`` (which imports no JAX).

Behavioural re-implementation of the reference SDK
(``Code/quadpilot/body.py``): motors 0-3 live on the first endpoint, 4-7 on
the second (body.py:55-60); every command is sent as UDP JSON and retried
until the firmware's ``{"status": "OK"}`` ACK arrives (body.py:62-94); an
optional background listener ingests the firmware's periodic telemetry
broadcasts into thread-safe stores (body.py:96-194); dual-endpoint commands
dispatch on parallel threads (body.py:261-271).

Differences from the reference (documented):
  * endpoints are (ip, port) pairs so two loopback firmware simulators can
    stand in for the two ESPs in tests (the reference hard-codes port 12345
    and distinguishes ESPs by IP only);
  * a dedicated ACK socket per command avoids the reference's shared-socket
    race between ACK waits and broadcast ingestion.
"""
from __future__ import annotations

import atexit
import json
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_PORT = 12345  # esp32_motors.ino:14


def _default_dmp() -> Dict:
    return {
        "quaternion": {"w": 0.0, "x": 0.0, "y": 0.0, "z": 0.0},
        "world_accel_mps2": {"ax": 0.0, "ay": 0.0, "az": 0.0},
        "ypr_deg": {"yaw": 0.0, "pitch": 0.0, "roll": 0.0},
    }


class QuadPilotBody:
    def __init__(
        self,
        ip1: str = "192.168.137.100",
        ip2: str = "192.168.137.101",
        listen_for_broadcasts: bool = False,
        port1: int = DEFAULT_PORT,
        port2: int = DEFAULT_PORT,
        listen_port: int = DEFAULT_PORT,
    ):
        self.endpoints: List[Tuple[str, int]] = [(ip1, port1), (ip2, port2)]
        self._is_closed = False
        self._lock = threading.Lock()

        self._dmp: Dict[Tuple[str, int], Dict] = {
            ep: _default_dmp() for ep in self.endpoints
        }
        self._motor: Dict[Tuple[str, int], Dict] = {
            ep: {
                "angles": [0.0] * 4,
                "encoderPos": [0] * 4,
                "targetPos": [0] * 4,
                "dmp_ready": False,
                "esp_control_fully_enabled": False,
                "last_packet_received_timestamp_esp": 0.0,
            }
            for ep in self.endpoints
        }
        self._received: Dict[Tuple[str, int], bool] = {
            ep: False for ep in self.endpoints
        }

        self._listener_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._listen_sock: Optional[socket.socket] = None
        if listen_for_broadcasts:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.settimeout(0.1)
            s.bind(("0.0.0.0", listen_port))
            self._listen_sock = s
            self._listener_thread = threading.Thread(
                target=self._listener_loop, daemon=True
            )
            self._listener_thread.start()
        atexit.register(self.close)

    # ------------------------------------------------------------------
    def _endpoint_for_motor(self, motor_idx: int) -> Tuple[str, int]:
        if not 0 <= motor_idx <= 7:
            raise ValueError("Motor index must be 0-7")
        return self.endpoints[0] if motor_idx < 4 else self.endpoints[1]

    def _send_and_wait_ok(
        self, endpoint: Tuple[str, int], command: dict,
        retries: int = 3, timeout_per_retry: float = 0.5,
    ) -> bool:
        """Retry-with-ACK reliability (body.py:62-94)."""
        if self._is_closed:
            return False
        message = json.dumps(command).encode()
        for attempt in range(retries):
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.settimeout(timeout_per_retry)
                try:
                    s.sendto(message, endpoint)
                    deadline = time.time() + timeout_per_retry
                    while time.time() < deadline:
                        try:
                            data, addr = s.recvfrom(2048)
                        except socket.timeout:
                            break
                        if addr[0] != endpoint[0]:
                            continue
                        try:
                            resp = json.loads(data.decode())
                        except json.JSONDecodeError:
                            continue
                        if resp.get("status") == "OK":
                            return True
                except OSError:
                    pass
            if attempt + 1 < retries:
                time.sleep(0.05)
        return False

    def _listener_loop(self):
        while not self._stop.is_set():
            try:
                data, addr = self._listen_sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                break
            # the firmware sends telemetry from its bound command port, so
            # the source (ip, port) identifies the endpoint — which also
            # disambiguates two loopback simulators
            ep = next((e for e in self.endpoints if e == addr), None)
            if ep is None:
                ep = next(
                    (e for e in self.endpoints if e[0] == addr[0]), None
                )
            if ep is None:
                continue
            try:
                payload = json.loads(data.decode())
            except json.JSONDecodeError:
                continue
            with self._lock:
                self._received[ep] = True
                store = self._motor[ep]
                store["last_packet_received_timestamp_esp"] = time.time()
                if "angles" in payload and "encoderPos" in payload:
                    if len(payload["angles"]) == 4:
                        store["angles"] = payload["angles"]
                        store["encoderPos"] = payload["encoderPos"]
                        store["targetPos"] = payload.get(
                            "targetPos", store["targetPos"]
                        )
                store["esp_control_fully_enabled"] = payload.get(
                    "esp_control_fully_enabled", False
                )
                dmp_ready = payload.get("dmp_ready", False)
                store["dmp_ready"] = dmp_ready
                if dmp_ready and "dmp_data" in payload:
                    d = payload["dmp_data"]
                    dst = self._dmp[ep]
                    for k in ("quaternion", "world_accel_mps2", "ypr_deg"):
                        if k in d:
                            dst[k] = d[k]
                elif not dmp_ready:
                    self._dmp[ep] = _default_dmp()

    def _parallel(self, cmd1: dict, cmd2: dict, retries: int,
                  timeout_per_retry: float, join_timeout: float) -> bool:
        """Dual-endpoint parallel dispatch (body.py:261-271)."""
        results = [False, False]

        def task(i, cmd):
            results[i] = self._send_and_wait_ok(
                self.endpoints[i], cmd, retries, timeout_per_retry
            )

        t1 = threading.Thread(target=task, args=(0, cmd1))
        t2 = threading.Thread(target=task, args=(1, cmd2))
        t1.start(); t2.start()
        t1.join(join_timeout); t2.join(join_timeout)
        return all(results)

    # ---------------- public API (body.py:273-333) --------------------
    def set_control_params(self, P, I, D, dead_zone, pos_thresh) -> bool:
        cmd = {"command": "set_control_params", "P": P, "I": I, "D": D,
               "dead_zone": dead_zone, "pos_thresh": pos_thresh}
        return self._parallel(dict(cmd), dict(cmd), 5, 1.0, 5.5)

    def set_angles(self, angles: Sequence[float]) -> bool:
        """The realtime path: 8 int-rounded degrees, 1 retry, 0.1 s timeout
        (body.py:278-284)."""
        if len(angles) != 8:
            raise ValueError("Exactly 8 angles must be provided")
        ints = [int(round(a)) for a in angles]
        return self._parallel(
            {"command": "set_angles", "angles": ints[:4]},
            {"command": "set_angles", "angles": ints[4:]},
            1, 0.1, 0.3,
        )

    def set_all_pins(self, pins_config: Sequence[Tuple[int, int, int, int]]) -> bool:
        if len(pins_config) != 8:
            raise ValueError("Exactly 8 pin configs must be provided")
        cmds = [{"command": "set_all_pins"}, {"command": "set_all_pins"}]
        for half, cmd in enumerate(cmds):
            for i, p in enumerate(pins_config[half * 4 : half * 4 + 4]):
                cmd[f"ENCODER_A{i}"], cmd[f"ENCODER_B{i}"] = p[0], p[1]
                cmd[f"IN1_{i}"], cmd[f"IN2_{i}"] = p[2], p[3]
        return self._parallel(cmds[0], cmds[1], 5, 1.0, 5.5)

    def set_control_status(self, motor_idx: int, status: bool) -> bool:
        ep = self._endpoint_for_motor(motor_idx)
        cmd = {"command": "set_control_status", "motor": motor_idx % 4,
               "status": 1 if status else 0}
        return self._send_and_wait_ok(ep, cmd, 3, 0.5)

    def set_all_control_status(self, status: bool) -> bool:
        results = [False, False]

        def task(i):
            ok = True
            for motor in range(4):
                cmd = {"command": "set_control_status", "motor": motor,
                       "status": 1 if status else 0}
                if not self._send_and_wait_ok(self.endpoints[i], cmd, 3, 0.5):
                    ok = False
                    break
                time.sleep(0.02)
            results[i] = ok

        t1 = threading.Thread(target=task, args=(0,))
        t2 = threading.Thread(target=task, args=(1,))
        t1.start(); t2.start()
        t1.join(7.2); t2.join(7.2)
        return all(results)

    def reset_all(self) -> bool:
        cmd = {"command": "reset_all"}
        return self._parallel(dict(cmd), dict(cmd), 5, 1.0, 5.5)

    def set_send_interval(self, interval_ms: int) -> bool:
        cmd = {"command": "set_send_interval", "interval": max(1, interval_ms)}
        return self._parallel(dict(cmd), dict(cmd), 3, 0.5, 2.0)

    def get_imu_data(self, ip_index: int, retries: int = 3,
                     timeout_per_retry: float = 0.5) -> Optional[Dict]:
        """Poll one endpoint's DMP state with the ``get_imu_data`` command
        (quadpilot/body.py:225-240; firmware handler esp32_motors.ino:
        264-291).  The firmware answers with a ``dmp_status`` packet
        ("ready" + dmp_data, or "not_ready") followed by the usual OK ACK.
        Returns the dmp_data dict when ready, ``None`` when not ready or
        on timeout.  The returned data is also folded into the DMP store
        so the passive getters see it."""
        if self._is_closed:
            return None
        endpoint = self.endpoints[ip_index]
        message = json.dumps({"command": "get_imu_data"}).encode()
        for attempt in range(retries):
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.settimeout(timeout_per_retry)
                try:
                    s.sendto(message, endpoint)
                    deadline = time.time() + timeout_per_retry
                    while time.time() < deadline:
                        try:
                            data, addr = s.recvfrom(2048)
                        except socket.timeout:
                            break
                        if addr[0] != endpoint[0]:
                            continue
                        try:
                            resp = json.loads(data.decode())
                        except json.JSONDecodeError:
                            continue
                        if "dmp_status" not in resp:
                            continue  # OK ACK / stray broadcast
                        if resp["dmp_status"] != "ready":
                            return None
                        d = resp.get("dmp_data", {})
                        with self._lock:
                            self._motor[endpoint]["dmp_ready"] = True
                            dst = self._dmp[endpoint]
                            for k in ("quaternion", "ypr_deg"):
                                if k in d:
                                    dst[k] = d[k]
                            # the firmware handler historically sent either
                            # key name (quadpilot/body.py:158-161)
                            if "world_accel_mps2" in d:
                                dst["world_accel_mps2"] = d["world_accel_mps2"]
                            elif "world_accel" in d:
                                dst["world_accel_mps2"] = d["world_accel"]
                        return d
                except OSError:
                    pass
            if attempt + 1 < retries:
                time.sleep(0.05)
        return None

    # ---------------- getters (body.py:197-259) ------------------------
    def get_latest_motor_data_for_esp(self, ip_index: int):
        ep = self.endpoints[ip_index]
        with self._lock:
            return dict(self._motor[ep]) if self._received[ep] else None

    def get_latest_dmp_data_for_esp(self, ip_index: int):
        ep = self.endpoints[ip_index]
        with self._lock:
            if self._received[ep]:
                return {k: dict(v) for k, v in self._dmp[ep].items()}
        return _default_dmp()

    def get_latest_imu_data_for_esp(self, ip_index: int) -> Dict:
        """DEPRECATED legacy getter (quadpilot/body.py:227-242): prefer
        ``get_latest_dmp_data_for_esp``.  Returns the broadcast DMP data
        when the endpoint reports dmp_ready, else an empty dict."""
        ep = self.endpoints[ip_index]
        with self._lock:
            if self._received[ep] and self._motor[ep].get("dmp_ready"):
                return {k: dict(v) for k, v in self._dmp[ep].items()}
        return {}

    def is_dmp_ready_for_esp(self, ip_index: int) -> bool:
        ep = self.endpoints[ip_index]
        with self._lock:
            return bool(self._motor[ep].get("dmp_ready", False))

    def is_esp_control_reported_on(self, ip_index: int) -> bool:
        ep = self.endpoints[ip_index]
        with self._lock:
            return bool(self._motor[ep].get("esp_control_fully_enabled", False))

    def is_data_available_from_esp(self, ip_index: int) -> bool:
        ep = self.endpoints[ip_index]
        with self._lock:
            return self._received[ep]

    def get_last_packet_received_timestamp_for_esp(self, ip_index: int) -> float:
        ep = self.endpoints[ip_index]
        with self._lock:
            return self._motor[ep]["last_packet_received_timestamp_esp"]

    # ------------------------------------------------------------------
    def close(self):
        if self._is_closed:
            return
        self._is_closed = True
        self._stop.set()
        if self._listener_thread and self._listener_thread.is_alive():
            self._listener_thread.join(timeout=1.0)
        if self._listen_sock is not None:
            try:
                self._listen_sock.close()
            except OSError:
                pass
        try:
            atexit.unregister(self.close)
        except Exception:
            pass

    def __del__(self):
        self.close()
