"""Monocular depth estimation for the perception stack.

A copy of ``opendog_tpu/apps/depth.py``, which imports no JAX.
Reference: ``Code/examples/2d.py`` — a webcam loop that runs the
HuggingFace ``depth-estimation`` pipeline (Depth-Anything-V2-Small) per
frame and shows the min-max-normalised depth map.  Here the model is a
pluggable predictor so the same loop serves three deployments:

* a HuggingFace pipeline when its weights are available locally
  (``make_hf_predictor`` — gated import, no downloads are attempted),
* any callable ``frame_rgb (H, W, 3) uint8 -> depth (H, W) float``
  (e.g. :func:`.mono_depth.make_sim_predictor`),
* tests, via a deterministic synthetic predictor.

The post-processing (normalisation to uint8, the part 2d.py does with
cv2.normalize) is pure numpy and always available.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np

DepthPredictor = Callable[[np.ndarray], np.ndarray]


def normalize_depth(depth: np.ndarray) -> np.ndarray:
    """Min-max normalise a depth map to uint8 for display
    (2d.py:42-44)."""
    depth = np.asarray(depth, dtype=np.float32)
    lo, hi = float(depth.min()), float(depth.max())
    if hi - lo < 1e-12:
        return np.zeros(depth.shape, dtype=np.uint8)
    return ((depth - lo) * (255.0 / (hi - lo))).astype(np.uint8)


def make_hf_predictor(
    model_id: str = "depth-anything/Depth-Anything-V2-Small-hf",
) -> DepthPredictor:
    """HuggingFace depth-estimation pipeline predictor (2d.py:15-22).
    Requires the model weights to already be present in the local HF
    cache; raises RuntimeError otherwise (this image has no egress)."""
    try:
        from transformers import pipeline  # local import: heavy
        from PIL import Image
    except Exception as e:  # pragma: no cover - env-dependent
        raise RuntimeError(f"transformers/PIL unavailable: {e}") from e
    try:
        pipe = pipeline(task="depth-estimation", model=model_id, device=-1)
    except Exception as e:
        raise RuntimeError(
            f"depth model '{model_id}' not in local cache: {e}"
        ) from e

    def predict(frame_rgb: np.ndarray) -> np.ndarray:
        out = pipe(Image.fromarray(frame_rgb))["depth"]
        return np.asarray(out, dtype=np.float32)

    return predict


def depth_stream(
    frames: Iterable[np.ndarray],
    predictor: DepthPredictor,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(depth_float, depth_uint8)`` per input RGB frame — the
    2d.py webcam loop (2d.py:30-47) with the I/O factored out."""
    for frame in frames:
        depth = np.asarray(predictor(np.asarray(frame)), dtype=np.float32)
        yield depth, normalize_depth(depth)


def webcam_frames(camera_index: int = 0) -> Iterator[np.ndarray]:
    """RGB frame generator from a local webcam (2d.py:25-37); requires
    cv2 + a camera device."""
    import cv2  # gated: not part of the baked image's core deps

    cap = cv2.VideoCapture(camera_index)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open camera {camera_index}")
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                return
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def run(camera_index: int = 0,
        predictor: Optional[DepthPredictor] = None) -> None:
    """Live loop: webcam -> depth -> display window (q to quit)."""
    import cv2

    predictor = predictor or make_hf_predictor()
    for _depth, depth_u8 in depth_stream(webcam_frames(camera_index),
                                         predictor):
        cv2.imshow("Depth Estimation", depth_u8)
        if cv2.waitKey(1) & 0xFF == ord("q"):
            break
    cv2.destroyAllWindows()
