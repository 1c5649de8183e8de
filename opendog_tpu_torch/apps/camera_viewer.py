"""Camera stream viewer — the ``Code/main.py`` Tkinter app, headless.

The reference viewer (``Code/main.py:11-95``) shows the ESP32-CAM MJPEG
stream in a Tk window with a framesize dropdown and an FPS/status label.
Without a display, this headless version keeps the same
moving parts — background stream thread, JPEG boundary scanning (the SDK
generator), runtime framesize switching, live FPS/status — and renders to
a pluggable sink: save every Nth frame to disk, or print a terminal
status line.  Drives either the real camera or the loopback C++ camera
simulator (native/camera_sim).

A copy of the JAX package's ``apps/camera_viewer.py`` (which imports no
JAX), on the port's ``sdk/camera.py`` (``urllib`` in place of
``requests``).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from ..sdk.camera import QuadPilotCamera

FRAMESIZES = [  # the reference dropdown's option list (main.py:22-26)
    "96X96", "QQVGA", "128X128", "QCIF", "HQVGA", "240X240", "QVGA",
    "320X320", "CIF", "HVGA", "VGA", "SVGA", "XGA", "HD", "SXGA", "UXGA",
]


class CameraViewer:
    """Headless stream viewer: background thread consumes the MJPEG
    stream, tracks FPS, and hands each JPEG to ``sink(jpeg_bytes, i)``."""

    def __init__(
        self,
        camera: QuadPilotCamera,
        sink: Optional[Callable[[bytes, int], None]] = None,
        save_dir: Optional[str] = None,
        save_every: int = 30,
    ):
        self.camera = camera
        self.save_dir = save_dir
        self.save_every = save_every
        self._sink = sink
        self.frames = 0
        self.fps = 0.0
        self.status = "idle"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- reference API surface -----------------------------------------
    def change_framesize(self, framesize: str) -> bool:
        """Dropdown handler parity (main.py:60-70)."""
        assert framesize in FRAMESIZES, framesize
        ok = self.camera.change_framesize(framesize)
        self.status = (f"framesize={framesize}" if ok
                       else f"framesize change failed: {framesize}")
        return ok

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self.camera.stop_stream()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.status = "stopped"

    # -- internals ------------------------------------------------------
    def _handle(self, jpeg: bytes, i: int):
        if self._sink is not None:
            self._sink(jpeg, i)
        if self.save_dir is not None and i % self.save_every == 0:
            os.makedirs(self.save_dir, exist_ok=True)
            with open(os.path.join(self.save_dir, f"frame_{i:06d}.jpg"),
                      "wb") as f:
                f.write(jpeg)

    def _loop(self):
        self.status = "streaming"
        t0 = time.time()
        n0 = 0
        try:
            for jpeg in self.camera.raw_stream():
                if self._stop.is_set():
                    break
                self._handle(jpeg, self.frames)
                self.frames += 1
                dt = time.time() - t0
                if dt >= 1.0:  # FPS label refresh (main.py status label)
                    self.fps = (self.frames - n0) / dt
                    t0, n0 = time.time(), self.frames
        except Exception as e:  # stream drop -> status, like the Tk app
            self.status = f"stream error: {e}"
        else:
            self.status = "stream ended"


def main():  # pragma: no cover - thin CLI
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=81)
    p.add_argument("--framesize", default="VGA")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args()
    cam = QuadPilotCamera(args.ip, port=args.port)
    viewer = CameraViewer(cam, save_dir=args.save_dir)
    viewer.change_framesize(args.framesize)
    viewer.start()
    end = time.time() + args.seconds
    while time.time() < end:
        time.sleep(1.0)
        print(f"[viewer] {viewer.frames} frames, {viewer.fps:.1f} fps, "
              f"{viewer.status}", flush=True)
    viewer.stop()


if __name__ == "__main__":
    main()
