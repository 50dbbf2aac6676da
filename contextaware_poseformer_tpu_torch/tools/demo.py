"""End-to-end demo: frames -> streaming lifter -> rendered 3D predictions.

The port's counterpart of the JAX package's ``tools/demo.py``: random
weights from a seed and the synthetic geometric dataset (no dataset is
needed), lifted through ``models.streaming.StreamingLifter`` (the
detections in full-frame pixels, each frame's crop box from its
keypoints), rendered by ``utils/visualization.render_prediction_grid``::

  python -m contextaware_poseformer_tpu_torch.tools.demo --out demo.png
  python -m contextaware_poseformer_tpu_torch.tools.demo --tiny \\
      --device cpu --out demo.png

``--preset`` is any preset (default ``h36m_hrnet_32``, the float serving
slice, ``serve.slice_config``); ``--tiny`` cuts it as ``train_h36m --tiny``
does (a width-8 HRNet, lifter embed 32 depth 2, 64x64 frames); ``--bf16``
runs the backbone in bf16. Where matplotlib is not installed the grid is
drawn in numpy instead (``render_flat``: the crop with its keypoints, then
the pose's front and side views) and written by PIL.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

IMAGE_WH = (1000, 1000)  # the synthetic frames' full-frame size


def crop_boxes(keypoints_full: np.ndarray, image_shape) -> tuple:
    """(centers, scales) (N, 2) of boxes around each frame's keypoints,
    grown by a quarter and to the crop's aspect ratio."""
    from contextaware_poseformer_tpu_torch.utils import geometry

    h, w = image_shape
    lo, hi = keypoints_full.min(axis=1), keypoints_full.max(axis=1)
    pad = 0.25 * (hi - lo)
    boxes = np.concatenate([lo - pad, hi + pad], axis=1)
    pairs = [geometry.bbox_center_scale(b, w / h) for b in boxes]
    return (np.stack([c for c, _ in pairs]).astype(np.float32),
            np.stack([s for _, s in pairs]).astype(np.float32))


def render_flat(images_bgr: np.ndarray, keypoints_2d_crop: np.ndarray,
                preds_3d: np.ndarray, out_path: str,
                gts_3d: np.ndarray | None = None) -> str:
    """One row a frame: the crop with its 2D keypoints, then the 3D pose's
    front (x, y) and side (z, y) views on blank panels of the crop's size
    (prediction in colour, ground truth in grey), drawn by
    ``visualization.draw_pose_2d``; written as a PNG by PIL."""
    from PIL import Image

    from contextaware_poseformer_tpu_torch.utils import visualization as vis

    h, w = images_bgr.shape[1:3]
    rows = []
    for i, image in enumerate(images_bgr):
        panels = [vis.draw_pose_2d(image, keypoints_2d_crop[i])]
        poses = [(preds_3d[i], False)]  # (pose, drawn in grey)
        if gts_3d is not None:
            poses.insert(0, (gts_3d[i], True))
        r = max(max(float(np.abs(p).max()) for p, _ in poses), 1e-6) * 1.1
        for axes in ((0, 1), (2, 1)):
            panel = np.full((h, w, 3), 255, np.uint8)
            for pose, grey in poses:
                xy = (pose[:, axes] / r * 0.5 + 0.5) * [w - 1, h - 1]
                drawn = vis.draw_pose_2d(panel, xy)
                if grey:
                    drawn[(drawn != panel).any(-1)] = 160
                panel = drawn
            panels.append(panel)
        rows.append(np.concatenate(panels, axis=1))
    Image.fromarray(np.concatenate(rows)[..., ::-1]).save(out_path)
    return out_path


def render(images_bgr, keypoints_2d_crop, preds_3d, out_path, gts_3d=None):
    """``visualization.render_prediction_grid`` where matplotlib is
    installed, else ``render_flat``."""
    from contextaware_poseformer_tpu_torch.utils import visualization as vis

    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return render_flat(images_bgr, keypoints_2d_crop, preds_3d,
                           out_path, gts_3d)
    return vis.render_prediction_grid(images_bgr, keypoints_2d_crop,
                                      preds_3d, out_path, gts_3d=gts_3d)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="demo.png")
    p.add_argument("--preset", default="h36m_hrnet_32")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for a smoke run)")
    args = p.parse_args(argv)

    from contextaware_poseformer_tpu_torch import serve
    from contextaware_poseformer_tpu_torch.data.synthetic import (
        SyntheticPoseDataset,
    )
    from contextaware_poseformer_tpu_torch.models import bridge
    from contextaware_poseformer_tpu_torch.models.streaming import (
        StreamingConfig,
        StreamingLifter,
    )
    from contextaware_poseformer_tpu_torch.train import train_h36m
    from contextaware_poseformer_tpu_torch.utils import geometry

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"demo: --device {args.device}: no CUDA device here")
    cfg = serve.slice_config(args.preset)
    if args.tiny:
        cfg = train_h36m.tiny(cfg)
    model_cfg = cfg.model
    # random weights from the seed, as the JAX package's flax variables
    variables = bridge.variables_to_jax(serve.build_model(
        model_cfg, torch.float32, "cpu",
        generator=torch.Generator().manual_seed(args.seed)))
    lifter = StreamingLifter(model_cfg, variables,
                             StreamingConfig(batch_size=args.n,
                                             use_bf16=args.bf16),
                             device=args.device)

    ds = SyntheticPoseDataset(size=args.n, image_shape=model_cfg.image_shape,
                              seed=7)
    frames = np.stack([ds.load_image(i) for i in range(args.n)])
    full = geometry.image_coordinates(ds.joints_2d[:args.n], *IMAGE_WH)
    centers, scales = crop_boxes(full, model_cfg.image_shape)
    preds = lifter.lift_batch(frames, full, IMAGE_WH, centers, scales)
    _, crop = lifter._preprocess(full, IMAGE_WH, centers, scales)
    path = render(frames, crop, preds, args.out,
                  gts_3d=ds.joints_3d[:args.n])
    print(f"wrote {path} | preds {preds.shape} finite: "
          f"{bool(np.isfinite(preds).all())}")
    return path, preds


if __name__ == "__main__":
    main()
