"""Losses and evaluation errors.

Port of ``contextaware_poseformer_tpu/train/losses.py:21-197``: the
training losses in PyTorch (``LOSSES``, ``n_mpjpe``, ``limb_length_error``,
``uncertainty_loss``, ``volumetric_ce_loss``) and the host-side evaluation
errors in numpy, exactly as the JAX package keeps them (``p_mpjpe``,
``mpjve``), since that module imports JAX. The COCO losses come with their
slice.
"""

from __future__ import annotations

import numpy as np
import torch


def mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error: mean L2 over the last axis
    (loss.py:16-22)."""
    if pred.shape != gt.shape:
        raise ValueError(f"mpjpe: {tuple(pred.shape)} vs {tuple(gt.shape)}")
    return torch.linalg.vector_norm(pred - gt, dim=-1).mean()


def n_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Scale-normalized MPJPE (loss.py:71-85): the optimal per-sample scale
    is applied to the prediction before MPJPE."""
    norm_pred = (pred ** 2).sum(-1, keepdim=True).mean(-2, keepdim=True)
    norm_gt = (gt * pred).sum(-1, keepdim=True).mean(-2, keepdim=True)
    return mpjpe(norm_gt / norm_pred * pred, gt)


def _masked_mean(err, validity, dim):
    if validity is None:
        return err.mean()
    return (err * validity).sum() / (dim * validity.sum().clamp(min=1.0))


def keypoints_mse(pred, gt, validity=None):
    """Masked MSE (loss.py:104-115)."""
    return _masked_mean((pred - gt) ** 2, validity, pred.shape[-1])


def keypoints_mse_smooth(pred, gt, validity=None, threshold: float = 400.0):
    """Smooth-clipped MSE (loss.py:118-131): above ``threshold`` the squared
    error is compressed to e^0.1 * t^0.9."""
    diff2 = (pred - gt) ** 2
    diff2 = torch.where(diff2 > threshold,
                        diff2 ** 0.1 * threshold ** 0.9, diff2)
    return _masked_mean(diff2, validity, pred.shape[-1])


def keypoints_mae(pred, gt, validity=None):
    """Masked MAE (loss.py:134-141)."""
    return _masked_mean((pred - gt).abs(), validity, pred.shape[-1])


def keypoints_l2(pred, gt, validity=None):
    """Masked mean L2 distance (loss.py:144-147)."""
    dist = ((pred - gt) ** 2).sum(-1).sqrt()
    if validity is None:
        return dist.mean()
    v = validity.squeeze(-1) if validity.dim() == dist.dim() + 1 else validity
    return (dist * v).sum() / v.sum().clamp(min=1.0)


# the reference's CONNECTIVITY_DICT (loss.py:185), legacy joint order
REFERENCE_CONNECTIVITY = (
    (0, 1), (1, 2), (2, 6), (5, 4), (4, 3), (3, 6), (6, 7), (7, 8),
    (8, 16), (9, 16), (8, 12), (11, 12), (10, 11), (8, 13), (13, 14), (14, 15),
)


def limb_length_error(pred, gt, pairs=REFERENCE_CONNECTIVITY):
    """Mean |limb length difference| over limb pairs (loss.py:181-201)."""
    a = [p[0] for p in pairs]
    b = [p[1] for p in pairs]
    lp = torch.linalg.vector_norm(pred[..., a, :] - pred[..., b, :], dim=-1)
    lg = torch.linalg.vector_norm(gt[..., a, :] - gt[..., b, :], dim=-1)
    return (lp - lg).abs().mean()


LOSSES = {
    "MPJPE": mpjpe,
    "MSE": keypoints_mse,
    "MSESmooth": keypoints_mse_smooth,
    "MAE": keypoints_mae,
    "L2": keypoints_l2,
}


def p_mpjpe(pred: np.ndarray, gt: np.ndarray) -> float:
    """Procrustes-aligned MPJPE, "Protocol #2" (loss.py:25-68): the optimal
    similarity transform per sample via SVD, on the host in numpy."""
    if pred.shape != gt.shape or pred.ndim != 3:
        raise ValueError(f"p_mpjpe: (N, J, 3) arrays, got {pred.shape} and "
                         f"{gt.shape}")
    mu_x = np.mean(gt, axis=1, keepdims=True)
    mu_y = np.mean(pred, axis=1, keepdims=True)
    x0 = gt - mu_x
    y0 = pred - mu_y
    norm_x = np.sqrt(np.sum(x0 ** 2, axis=(1, 2), keepdims=True))
    norm_y = np.sqrt(np.sum(y0 ** 2, axis=(1, 2), keepdims=True))
    x0 /= norm_x
    y0 /= norm_y

    h = np.matmul(x0.transpose(0, 2, 1), y0)
    u, s, vt = np.linalg.svd(h)
    v = vt.transpose(0, 2, 1)
    r = np.matmul(v, u.transpose(0, 2, 1))
    # fix improper rotations (reflections)
    sign_det = np.sign(np.expand_dims(np.linalg.det(r), axis=1))
    v[:, :, -1] *= sign_det
    s[:, -1] *= sign_det.flatten()
    r = np.matmul(v, u.transpose(0, 2, 1))

    tr = np.expand_dims(np.sum(s, axis=1, keepdims=True), axis=2)
    a = tr * norm_x / norm_y
    t = mu_x - a * np.matmul(mu_y, r)
    aligned = a * np.matmul(pred, r) + t
    return float(np.mean(np.linalg.norm(aligned - gt, axis=-1)))


def mpjve(pred: np.ndarray, gt: np.ndarray) -> float:
    """Mean per-joint velocity error: MPJPE of the first temporal derivative
    (loss.py:87-101). Inputs ordered along axis 0 by time."""
    if pred.shape != gt.shape:
        raise ValueError(f"mpjve: {pred.shape} vs {gt.shape}")
    if pred.shape[0] < 2:
        return 0.0
    vel_p = np.diff(pred, axis=0)
    vel_g = np.diff(gt, axis=0)
    return float(np.mean(np.linalg.norm(vel_p - vel_g, axis=-1)))


def uncertainty_loss(sigma_list, pred, gt):
    """Heteroscedastic uncertainty loss (loss.py:8-13 UNCERTAINTY): L2 scaled
    by per-joint sigma plus a log-sigma regularizer."""
    diff = pred - gt
    total = 0.0
    for sigma in sigma_list:
        total = total + (
            torch.linalg.vector_norm(diff / (sigma + 1e-6), dim=-1).mean()
            + 0.01 * torch.log(sigma + 1e-6).mean()
        )
    return total


def volumetric_ce_loss(coord_volumes, volumes_pred, keypoints_gt, validity):
    """Volumetric cross-entropy (loss.py:150-178 VolumetricCELoss, the legacy
    ContextPose volumetric head): -log of the predicted probability at the
    voxel nearest each GT joint, masked by validity.

    coord_volumes: (b, X, Y, Z, 3); volumes_pred: (b, j, X, Y, Z) softmaxed;
    keypoints_gt: (b, j, 3); validity: (b, j, 1).
    """
    b, j = keypoints_gt.shape[:2]
    coords = coord_volumes.reshape(b, 1, -1, 3)
    dists = ((coords - keypoints_gt[:, :, None, :]) ** 2).sum(-1)  # (b, j, XYZ)
    idx = dists.argmin(-1)  # (b, j)
    flat = volumes_pred.reshape(b, j, -1)
    picked = torch.gather(flat, -1, idx[..., None])[..., 0]
    losses_ = -torch.log(picked + 1e-6) * validity[..., 0]
    return losses_.sum() / (b * j)
