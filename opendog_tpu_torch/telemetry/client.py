"""Sim telemetry UDP/msgpack client (port of
``Code/mujoco/wireless_comunication/client.py``: hello -> receive loop).
The matplotlib live-plotting of the reference is optional; the core client
exposes an iterator of decoded packets.

The JAX package's ``telemetry/client.py``, reading with the plain-Python
decoder of :mod:`.wire` in place of ``msgpack.unpackb(data, raw=False)``."""
from __future__ import annotations

import socket
from typing import Iterator, Optional

from . import wire


class TelemetryClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 9870,
                 timeout: float = 2.0):
        self.server = (host, port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.settimeout(timeout)

    def connect(self):
        """Send the hello datagram that registers this client
        (client.py / server.py:54-58)."""
        self._sock.sendto(b"hello", self.server)
        return self

    def recv(self) -> Optional[dict]:
        try:
            data, _ = self._sock.recvfrom(65536)
        except socket.timeout:
            return None
        return wire.loads(data)

    def packets(self) -> Iterator[dict]:
        while True:
            p = self.recv()
            if p is None:
                return
            yield p

    def close(self):
        self._sock.close()
