"""Video -> frame extraction and offline crop tools.

Equivalents of the reference's ffmpeg frame dumps
(H36M-Toolbox/video_to_images.py:39-45 `-qscale:v 3`;
ContextPose_mpi/dataset/data_util/video_to_images.py:31-37) and the 3DHP
pre-crop step (convert_to_small{,_test}.py:245-294), which warps every frame
to the 192x256 training crop once offline so the runtime loader only decodes.
Unlike convert_to_small.py:282-289 this NEVER deletes originals unless
explicitly asked (the reference's in-place os.remove is a data hazard).

The port's copy of ``contextaware_poseformer_tpu/data/preprocess/frames.py``
(held to it by ``tests/test_torch_copies.py``).
"""

from __future__ import annotations

import os
import subprocess
from typing import Iterable

import numpy as np

from contextaware_poseformer_tpu_torch.utils import geometry

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def extract_frames(
    video_path: str,
    out_dir: str,
    name_format: str = "%06d.jpg",
    qscale: int = 3,
    ffmpeg: str = "ffmpeg",
) -> None:
    """ffmpeg -i video -qscale:v 3 out/prefix_%06d.jpg (video_to_images.py:39-45)."""
    os.makedirs(out_dir, exist_ok=True)
    subprocess.run(
        [ffmpeg, "-nostats", "-loglevel", "error", "-i", video_path,
         "-qscale:v", str(qscale), os.path.join(out_dir, name_format)],
        check=True,
    )


def crop_frames(
    image_paths: Iterable[str],
    centers: np.ndarray,
    scales: np.ndarray,
    out_dir: str,
    crop_wh: tuple[int, int] = (192, 256),
    jpeg_quality: int = 100,
    remove_originals: bool = False,
) -> list[str]:
    """Warp frames to fixed crops (convert_to_small.py:245-289 equivalent)."""
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("cv2 required for offline cropping")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i, path in enumerate(image_paths):
        img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is None:
            raise FileNotFoundError(path)
        trans = geometry.get_affine_transform(centers[i], scales[i], crop_wh)
        crop = cv2.warpAffine(img, trans, crop_wh, flags=cv2.INTER_LINEAR)
        out_path = os.path.join(out_dir, os.path.basename(path))
        cv2.imwrite(out_path, crop, [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality])
        written.append(out_path)
        if remove_originals and os.path.abspath(out_path) != os.path.abspath(path):
            os.remove(path)
    return written
