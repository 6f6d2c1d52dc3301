"""Frame-sequence to MP4 encoding through an ffmpeg pipe.

The port's copy of the JAX package's ``utils/images2mp4.py``.

Behavioral parity target: the reference ships a video writer that pipes raw
RGB frames into libx264 and integer-upsamples tiny puzzle renders so the
output is at least ~100 px on each side with even dimensions
(reference: python3/src/pushworld/utils/images2mp4.py:22-117).

This implementation keeps the same public signature but delegates the
upsampling to ffmpeg itself (`scale` filter with nearest-neighbor
interpolation): frames cross the pipe at their native size, which is both
less Python work and less pipe traffic than host-side pixel replication.
"""

import shutil
import subprocess
from typing import List, Sequence

import numpy as np


def _output_dims(h: int, w: int, min_side: int) -> "tuple[int, int]":
    """Smallest integer multiple of (h, w) with both sides >= min_side,
    bumped once more if needed so both sides are even (yuv420p chroma
    subsampling requires even dimensions)."""
    scale = max(1, -(-min_side // min(h, w)))  # ceil division
    if (h * scale) % 2 or (w * scale) % 2:
        scale += 1
    return h * scale, w * scale


def images2mp4(
    video_file_path: str,
    images: Sequence[np.ndarray],
    color_axis: int = 2,
    fps: float = 30.0,
    min_video_size: int = 100,
) -> None:
    """Encodes a sequence of same-shaped uint8 RGB frames into an .mp4.

    Args:
        video_file_path: output path; ``.mp4`` is appended when missing.
        images: frames, each ``(H, W, 3)`` (``color_axis=2``) or ``(3, H, W)``
            (``color_axis=0``).
        color_axis: which axis carries the color channels (0 or 2).
        fps: output frame rate.
        min_video_size: frames are integer-upscaled (nearest neighbor, by
            ffmpeg) until both sides are at least this many pixels.
    """
    if color_axis not in (0, 2):
        raise ValueError("color_axis must either be 0 or 2")
    if len(images) < 2:
        raise ValueError(f"Cannot save a video with only {len(images)} frames")
    if not video_file_path.lower().endswith(".mp4"):
        video_file_path += ".mp4"

    first = images[0]
    if first.ndim != 3:
        raise ValueError(f"Expected 3-D frames, got shape {first.shape}")
    h, w = (first.shape[0], first.shape[1]) if color_axis == 2 else first.shape[1:]
    out_h, out_w = _output_dims(h, w, min_video_size)

    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            "Converting images into an mp4 video requires `ffmpeg` to be "
            "installed. See https://ffmpeg.org/"
        )

    argv = [
        "ffmpeg",
        "-nostats", "-loglevel", "error", "-y",
        "-f", "rawvideo",
        "-pix_fmt", "rgb24",
        "-s:v", f"{w}x{h}",
        "-r", str(fps),
        "-i", "pipe:0",
        "-vf", f"scale={out_w}:{out_h}:flags=neighbor",
        "-vcodec", "libx264",
        "-pix_fmt", "yuv420p",
        video_file_path,
    ]
    with subprocess.Popen(argv, stdin=subprocess.PIPE) as proc:
        assert proc.stdin is not None
        for frame in images:
            if color_axis == 0:
                frame = np.moveaxis(frame, 0, -1)
            if frame.shape != (h, w, 3):
                raise ValueError(
                    f"Frame shape {frame.shape} differs from the first "
                    f"frame's ({h}, {w}, 3)"
                )
            proc.stdin.write(np.ascontiguousarray(frame, dtype=np.uint8).tobytes())
        proc.stdin.close()
        if proc.wait() != 0:
            raise RuntimeError("ffmpeg failed to encode the video")
