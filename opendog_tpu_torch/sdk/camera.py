"""QuadPilotCamera — HTTP client for the ESP32-CAM firmware.

The JAX package's ``sdk/camera.py`` on the standard library: the same
requests and answers over ``urllib.request`` in place of the ``requests``
package, which not every machine the port runs on has.

Behavioural port of ``Code/quadpilot/camera.py``: MJPEG multipart frame
streaming from ``:81/stream`` (camera firmware ``esp32cam.ino:70-126``),
runtime framesize control via ``/control?var=framesize&val=N``
(esp32cam.ino:129-168), raw-IMU JSON from ``/imu_data`` (:171-190) and
ADS1115 readings from ``/ads_data`` (:193-211).  cv2 decoding is optional —
without it the frame generator yields raw JPEG bytes.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Iterator, Optional

try:
    import cv2
    import numpy as np

    HAVE_CV2 = True
except ImportError:  # pragma: no cover
    HAVE_CV2 = False

FRAMESIZES = {
    "QQVGA": 0, "QVGA": 4, "VGA": 6, "SVGA": 7, "XGA": 8, "SXGA": 9,
    "UXGA": 10,
}


class QuadPilotCamera:
    def __init__(self, ip: str, port: int = 81, timeout: float = 5.0):
        self.base = f"http://{ip}:{port}"
        self.timeout = timeout
        self._streaming = False

    def _frame_generator(self) -> Iterator[bytes]:
        """Yield JPEG frames from the multipart MJPEG stream
        (camera.py:25-54).  An HTTP error status raises."""
        with urllib.request.urlopen(f"{self.base}/stream",
                                    timeout=self.timeout) as resp:
            buf = b""
            while True:
                chunk = resp.read1(4096)
                if not chunk or not self._streaming:
                    return
                buf += chunk
                while True:
                    start = buf.find(b"\xff\xd8")
                    end = buf.find(b"\xff\xd9", start + 2)
                    if start == -1 or end == -1:
                        break
                    yield buf[start : end + 2]
                    buf = buf[end + 2 :]

    def stream(self, callback=None):
        """Iterate decoded frames (or raw JPEG bytes without cv2);
        stops when ``stop_stream`` is called (camera.py:56-68)."""
        self._streaming = True
        for jpeg in self._frame_generator():
            if HAVE_CV2:
                frame = cv2.imdecode(
                    np.frombuffer(jpeg, dtype=np.uint8), cv2.IMREAD_COLOR
                )
            else:
                frame = jpeg
            if callback is not None:
                callback(frame)
            else:
                yield frame
            if not self._streaming:
                break

    def raw_stream(self) -> Iterator[bytes]:
        """Iterate raw JPEG bytes (no decode); stops on stop_stream()."""
        self._streaming = True
        yield from self._frame_generator()

    def stop_stream(self):
        self._streaming = False

    def _get(self, path: str, params: Optional[dict] = None):
        url = f"{self.base}{path}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        return urllib.request.urlopen(url, timeout=self.timeout)

    def change_framesize(self, framesize) -> bool:
        """camera.py:75-88."""
        val = FRAMESIZES.get(framesize, framesize)
        try:
            with self._get("/control", {"var": "framesize",
                                        "val": val}) as r:
                return r.status == 200
        except urllib.error.HTTPError as e:
            return e.code == 200

    def _get_json(self, path: str) -> Optional[dict]:
        try:
            with self._get(path) as r:
                return json.loads(r.read()) if r.status == 200 else None
        except (OSError, ValueError):  # no answer, an error status, bad JSON
            return None

    def get_imu_data(self) -> Optional[dict]:
        """camera.py:90-100."""
        return self._get_json("/imu_data")

    def get_ads_data(self) -> Optional[dict]:
        return self._get_json("/ads_data")
