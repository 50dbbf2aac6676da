"""Visualization: 2D overlays, deformable-offset debugging, and 3D skeleton
rendering.

Covers the reference's visual-debug surface (SURVEY.md sections 2.2/2.4):
- draw_offsets: deformable sampling positions/weights painted on the crop
  (mvn/utils/img.py:208-247 draw_pic);
- draw_pose_2d: keypoint/limb overlay;
- render_pose_3d / render_prediction_grid: matplotlib 3D skeletons
  (ContextPose_mpi/common/visualization.py renderers, reduced to the pieces
  actually useful for single-frame models: no video animation dependency).

All functions take/return numpy; matplotlib is imported lazily with the Agg
backend so headless use (this image) works.

The port's copy of ``contextaware_poseformer_tpu/utils/visualization.py``
(held to it by ``tests/test_torch_copies.py``).
"""

from __future__ import annotations

import numpy as np

from contextaware_poseformer_tpu_torch.utils import skeleton

# parent -> child limb pairs for H36M-17 drawing
H36M_LIMBS = (
    (0, 1), (1, 2), (2, 3), (0, 4), (4, 5), (5, 6), (0, 7), (7, 8),
    (8, 9), (9, 10), (8, 11), (11, 12), (12, 13), (8, 14), (14, 15), (15, 16),
)


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def draw_pose_2d(
    image_bgr: np.ndarray,
    keypoints_xy: np.ndarray,
    limbs=H36M_LIMBS,
    radius: int = 2,
) -> np.ndarray:
    """Paint keypoints + limbs onto a copy of the crop (pure numpy)."""
    img = np.ascontiguousarray(image_bgr).copy()
    h, w = img.shape[:2]

    def disk(cx, cy, color):
        x0, x1 = max(int(cx) - radius, 0), min(int(cx) + radius + 1, w)
        y0, y1 = max(int(cy) - radius, 0), min(int(cy) + radius + 1, h)
        img[y0:y1, x0:x1] = color

    def line(p, q, color):
        n = int(max(abs(q[0] - p[0]), abs(q[1] - p[1]), 1)) * 2
        for t in np.linspace(0, 1, n):
            x = int(round(p[0] + t * (q[0] - p[0])))
            y = int(round(p[1] + t * (q[1] - p[1])))
            if 0 <= x < w and 0 <= y < h:
                img[y, x] = color

    left = set(skeleton.H36M_JOINTS_LEFT)
    for a, b in limbs:
        line(keypoints_xy[a], keypoints_xy[b], (0, 200, 0))
    for j, (x, y) in enumerate(keypoints_xy):
        color = (255, 80, 0) if j in left else (0, 80, 255)
        disk(x, y, color)
    return img


def draw_offsets(
    image_bgr: np.ndarray,
    ref_xy: np.ndarray,  # (J, 2) crop pixels
    sample_xy: np.ndarray,  # (J, S, 2) crop pixels (deformable positions)
    weights: np.ndarray | None = None,  # (J, S) softmax weights
    joint: int | None = None,
) -> np.ndarray:
    """Deformable-offset visualizer (mvn/utils/img.py:208-247 draw_pic):
    reference points in blue, sampling points sized/shaded by weight."""
    img = np.ascontiguousarray(image_bgr).copy()
    h, w = img.shape[:2]
    joints = range(len(ref_xy)) if joint is None else [joint]
    if weights is None:
        weights = np.full(sample_xy.shape[:2], 1.0 / sample_xy.shape[1])
    wmax = max(float(weights.max()), 1e-6)
    for j in joints:
        for s in range(sample_xy.shape[1]):
            x, y = sample_xy[j, s]
            if not (0 <= x < w and 0 <= y < h):
                continue
            r = 1 + int(2 * weights[j, s] / wmax)
            x0, x1 = max(int(x) - r, 0), min(int(x) + r + 1, w)
            y0, y1 = max(int(y) - r, 0), min(int(y) + r + 1, h)
            shade = int(255 * weights[j, s] / wmax)
            img[y0:y1, x0:x1] = (0, shade, 255 - shade)
        x, y = ref_xy[j]
        if 0 <= x < w and 0 <= y < h:
            x0, x1 = max(int(x) - 2, 0), min(int(x) + 3, w)
            y0, y1 = max(int(y) - 2, 0), min(int(y) + 3, h)
            img[y0:y1, x0:x1] = (255, 0, 0)
    return img


def render_pose_3d(
    pose_3d: np.ndarray,  # (17, 3) root-relative
    out_path: str | None = None,
    gt_3d: np.ndarray | None = None,
    elev: float = 15.0,
    azim: float = 70.0,
):
    """Single 3D skeleton plot (prediction red, optional GT gray)."""
    plt = _mpl()
    fig = plt.figure(figsize=(4, 4))
    ax = fig.add_subplot(111, projection="3d")
    ax.view_init(elev=elev, azim=azim)

    def plot(p, color, alpha):
        for a, b in H36M_LIMBS:
            ax.plot(
                [p[a, 0], p[b, 0]], [p[a, 2], p[b, 2]], [-p[a, 1], -p[b, 1]],
                color=color, alpha=alpha, linewidth=2,
            )

    if gt_3d is not None:
        plot(np.asarray(gt_3d), "gray", 0.6)
    plot(np.asarray(pose_3d), "tab:red", 0.95)
    r = float(np.abs(pose_3d).max()) * 1.1 + 1e-6
    ax.set_xlim(-r, r), ax.set_ylim(-r, r), ax.set_zlim(-r, r)
    ax.set_box_aspect((1, 1, 1))
    if out_path:
        fig.savefig(out_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def render_prediction_grid(
    images_bgr: np.ndarray,  # (N, H, W, 3)
    keypoints_2d_crop: np.ndarray,  # (N, 17, 2)
    preds_3d: np.ndarray,  # (N, 17, 3)
    out_path: str,
    gts_3d: np.ndarray | None = None,
    max_rows: int = 4,
) -> str:
    """Input crop + 2D overlay + 3D prediction, one row per sample."""
    plt = _mpl()
    n = min(len(images_bgr), max_rows)
    fig = plt.figure(figsize=(6, 3 * n))
    for i in range(n):
        ax = fig.add_subplot(n, 2, 2 * i + 1)
        ax.imshow(draw_pose_2d(images_bgr[i], keypoints_2d_crop[i])[..., ::-1])
        ax.axis("off")
        ax3 = fig.add_subplot(n, 2, 2 * i + 2, projection="3d")
        p = preds_3d[i]
        for a, b in H36M_LIMBS:
            ax3.plot([p[a, 0], p[b, 0]], [p[a, 2], p[b, 2]],
                     [-p[a, 1], -p[b, 1]], color="tab:red", linewidth=2)
        if gts_3d is not None:
            g = gts_3d[i]
            for a, b in H36M_LIMBS:
                ax3.plot([g[a, 0], g[b, 0]], [g[a, 2], g[b, 2]],
                         [-g[a, 1], -g[b, 1]], color="gray", alpha=0.6)
        ax3.set_axis_off()
    fig.savefig(out_path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return out_path


def render_animation(
    poses_3d: np.ndarray,  # (T, 17, 3) root-relative sequence
    out_path: str,  # .gif always works (PIL); .mp4 needs ffmpeg
    frames_bgr: np.ndarray | None = None,  # optional (T, H, W, 3) inputs
    gts_3d: np.ndarray | None = None,
    fps: int = 25,
    elev: float = 15.0,
    azim: float = 70.0,
) -> str:
    """Sequence renderer — the equivalent of the reference's vendored
    VideoPose3D render_animation (ContextPose_mpi/common/visualization.py:
    65-689): input frame beside the animated 3D skeleton (prediction red,
    optional GT gray). Writes .gif via PIL (always available here) or .mp4
    when an ffmpeg binary is on PATH.
    """
    from PIL import Image

    plt = _mpl()
    t_total = len(poses_3d)
    r = float(np.abs(poses_3d).max()) * 1.1 + 1e-6
    cols = 2 if frames_bgr is not None else 1

    rendered = []
    for t in range(t_total):
        fig = plt.figure(figsize=(4 * cols, 4))
        if frames_bgr is not None:
            ax = fig.add_subplot(1, cols, 1)
            ax.imshow(np.asarray(frames_bgr[t])[..., ::-1])
            ax.axis("off")
        ax3 = fig.add_subplot(1, cols, cols, projection="3d")
        ax3.view_init(elev=elev, azim=azim)

        def plot(p, color, alpha):
            for a, b in H36M_LIMBS:
                ax3.plot(
                    [p[a, 0], p[b, 0]], [p[a, 2], p[b, 2]],
                    [-p[a, 1], -p[b, 1]], color=color, alpha=alpha,
                    linewidth=2,
                )

        if gts_3d is not None:
            plot(np.asarray(gts_3d[t]), "gray", 0.6)
        plot(np.asarray(poses_3d[t]), "tab:red", 0.95)
        ax3.set_xlim(-r, r), ax3.set_ylim(-r, r), ax3.set_zlim(-r, r)
        ax3.set_box_aspect((1, 1, 1))
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        rendered.append(Image.fromarray(buf.copy()))
        plt.close(fig)

    if out_path.endswith(".mp4"):
        import shutil
        import subprocess
        import tempfile

        if shutil.which("ffmpeg") is None:
            raise RuntimeError("mp4 output needs ffmpeg; use .gif instead")
        with tempfile.TemporaryDirectory() as td:
            for i, im in enumerate(rendered):
                im.save(f"{td}/{i:06d}.png")
            subprocess.run(
                ["ffmpeg", "-y", "-loglevel", "error", "-framerate", str(fps),
                 "-i", f"{td}/%06d.png", "-pix_fmt", "yuv420p", out_path],
                check=True,
            )
    else:
        rendered[0].save(
            out_path, save_all=True, append_images=rendered[1:],
            duration=int(1000 / fps), loop=0,
        )
    return out_path
