"""Live rolling contact-force scope.

Behavioural port of the reference's two live force plotters:
``Code/mujoco/test/RealTimePlotter.py:9-45`` (pyqtgraph 4-panel rolling
scope: buffer 500, roll-by-one per sample, one panel per paw) and
``Code/mujoco/wireless_comunication/client.py:67-100`` (matplotlib live
plots fed by the msgpack telemetry stream).

This image is headless, so the scope separates the testable core (rolling
buffers + stream pump) from the rendering:

* ``ForceScope``            — rolling per-paw sample buffers with the exact
                              roll-by-one update semantics of the reference;
* ``ForceScope.render_terminal`` — 4-panel unicode sparkline scope for a
                              terminal (the dasht.py-style deployment here);
* ``ForceScope.render_png`` — 4-subplot matplotlib Agg figure, the
                              RealTimePlotter panel layout, written to disk;
* ``watch``                 — pump a ``TelemetryClient`` packet stream into
                              the scope live (client.py's receive loop).

A copy of the JAX package's ``telemetry/scope.py`` (which imports no JAX).
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Iterable, Optional

import numpy as np

from .server import PAW_KEYS

# RealTimePlotter.py:18 panel titles, mapped onto our FL,FR,BL,BR key order
PAW_TITLES = ("Front Left", "Front Right", "Back Left", "Back Right")
_SPARK = " ▁▂▃▄▅▆▇█"


class ForceScope:
    """Rolling 4-paw force buffers (RealTimePlotter.py:16-34 semantics:
    fixed-size window, roll left by one, append at the end)."""

    def __init__(self, buffer_size: int = 500, component: str = "z"):
        self.buffer_size = int(buffer_size)
        # which force component to scope; the reference plots Z
        # (RealTimePlotter.py:21 'Force (Z)')
        self.component = {"x": 0, "y": 1, "z": 2}[component]
        self.data = np.zeros((4, self.buffer_size), dtype=np.float32)
        self.n_samples = 0

    def update(self, new_samples) -> None:
        """One scalar per paw, FL,FR,BL,BR (RealTimePlotter.update_plot)."""
        s = np.asarray(new_samples, dtype=np.float32)
        assert s.shape == (4,), s.shape
        self.data = np.roll(self.data, -1, axis=1)
        self.data[:, -1] = s
        self.n_samples += 1

    def update_from_packet(self, packet: dict) -> None:
        """Feed one telemetry wire dict (server schema: ``contact_forces``
        maps paw key -> [fx, fy, fz]; client.py:67-100 consumes the same)."""
        forces = packet.get("contact_forces", {})
        self.update([
            float(forces.get(k, (0.0, 0.0, 0.0))[self.component])
            for k in PAW_KEYS
        ])

    # ---------------- rendering ----------------
    def render_terminal(self, width: int = 60, y_max: float = 20.0) -> str:
        """4-panel sparkline scope; ``y_max`` mirrors the reference's fixed
        setYRange(0, 20) (RealTimePlotter.py:23)."""
        lines = []
        tail = self.data[:, -width:]
        for title, row in zip(PAW_TITLES, tail):
            levels = np.clip(row / y_max, 0.0, 1.0)
            spark = "".join(
                _SPARK[int(v * (len(_SPARK) - 1))] for v in levels)
            lines.append(f"{title:>12} |{spark}| {row[-1]:6.2f} N")
        return "\n".join(lines)

    def render_png(self, path: str, y_max: float = 20.0) -> str:
        """RealTimePlotter's 4-panel layout via matplotlib Agg."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 2, figsize=(12, 8))
        fig.suptitle("Real-time Contact Forces")
        for ax, title, row in zip(axes.ravel(), PAW_TITLES, self.data):
            ax.plot(row, color="y", lw=2, label="Actual")
            ax.set_title(title)
            ax.set_ylabel("Force (Z)")
            ax.set_xlabel("Samples")
            ax.set_ylim(0, y_max)
            ax.legend(loc="upper right")
        fig.tight_layout()
        fig.savefig(path, dpi=80)
        plt.close(fig)
        return path


def watch(
    packets: Iterable[dict],
    scope: Optional[ForceScope] = None,
    on_frame: Optional[Callable[[ForceScope], None]] = None,
    max_packets: Optional[int] = None,
    render_every: int = 1,
) -> ForceScope:
    """Pump a telemetry packet stream into the scope (client.py's
    recv->update loop).  ``on_frame`` defaults to an in-place terminal
    redraw; pass ``max_packets`` for bounded (testable) runs."""
    scope = scope or ForceScope()
    for i, pkt in enumerate(packets):
        scope.update_from_packet(pkt)
        if i % render_every == 0:
            if on_frame is not None:
                on_frame(scope)
            else:
                sys.stdout.write(
                    "\x1b[H\x1b[2J" + scope.render_terminal() + "\n")
                sys.stdout.flush()
        if max_packets is not None and i + 1 >= max_packets:
            break
    return scope


def main(host: str = "127.0.0.1", port: int = 9870,
         duration_s: float = 30.0):  # pragma: no cover - live app wrapper
    """Live scope against a running sim telemetry server."""
    from .client import TelemetryClient

    client = TelemetryClient(host, port).connect()
    t_end = time.time() + duration_s
    scope = ForceScope()
    try:
        for pkt in client.packets():
            scope.update_from_packet(pkt)
            sys.stdout.write("\x1b[H\x1b[2J" + scope.render_terminal() + "\n")
            sys.stdout.flush()
            if time.time() > t_end:
                break
    finally:
        client.close()
    return scope


if __name__ == "__main__":  # pragma: no cover
    main(*sys.argv[1:])
