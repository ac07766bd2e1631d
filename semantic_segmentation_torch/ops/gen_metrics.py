"""Generative-quality evaluation — the port of
``semantic_segmentation_tpu/ops/gen_metrics.py``:

- FID (``BBDM/evaluation/FID.py``): the Frechet distance between Gaussian
  fits of two feature sets (``frechet_distance``, ``fid_from_features``,
  numpy and scipy, identical to the JAX package's and to
  pytorch_fid.fid_score), on the pool3 features of the port's
  ``models/extractors.InceptionV3Pool3`` (``inception_features``,
  ``fid``);
- LPIPS (``BBDM/evaluation/LPIPS.py``): ``lpips`` on the port's
  ``AlexNetFeatures`` with its learned linear weights, and
  ``lpips_distance``, the numpy form over any extractor's features;
- BBDM's sample diversity (``BBDM/evaluation/diversity.py``);
- the volume metrics (``GenSeg-3D/util/evaluation.py``): masked MAE / MSE /
  PSNR and a windowed SSIM, written to CSV (the reference writes an Excel
  sheet).

The feature nets' real weights (``utils/torch_port.port_inception_v3``,
``port_alexnet_lpips``) are not in the repository: with random weights
FID and LPIPS run and their values mean nothing.
"""

from __future__ import annotations

import csv

import numpy as np
import torch


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6):
    """d^2 = |mu1 - mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)) (pytorch_fid)."""
    from scipy import linalg
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray):
    mu1, s1 = feats_a.mean(0), np.cov(feats_a, rowvar=False)
    mu2, s2 = feats_b.mean(0), np.cov(feats_b, rowvar=False)
    return frechet_distance(mu1, s1, mu2, s2)


def lpips_distance(feats_a: list, feats_b: list,
                   lin_weights: list | None = None):
    """Sum over layers of mean((w * (norm(fa) - norm(fb)))^2). ``feats_*``
    are lists of (N, H, W, C) layer activations; ``lin_weights`` the
    learned per-channel weights, else uniform."""
    total = 0.0
    for li, (fa, fb) in enumerate(zip(feats_a, feats_b)):
        na = fa / (np.linalg.norm(fa, axis=-1, keepdims=True) + 1e-10)
        nb = fb / (np.linalg.norm(fb, axis=-1, keepdims=True) + 1e-10)
        d = (na - nb) ** 2
        if lin_weights is not None:
            d = d * lin_weights[li].reshape(1, 1, 1, -1)
        total += d.sum(axis=-1).mean(axis=(1, 2))
    return total


def _device_of(net: torch.nn.Module):
    return next(net.parameters()).device


@torch.no_grad()
def inception_features(inception, images: np.ndarray,
                       batch_size: int = 16) -> np.ndarray:
    """pool3 features (N, 2048) of NHWC ``images`` in [0, 1], through the
    port's ``InceptionV3Pool3`` ``inception`` on its device, in float32,
    ``batch_size`` images a call."""
    dev = _device_of(inception)
    out = [inception(torch.as_tensor(np.asarray(
               images[i:i + batch_size], np.float32), device=dev)).cpu()
           for i in range(0, len(images), batch_size)]
    return torch.cat(out).numpy()


def fid(inception, images_a: np.ndarray, images_b: np.ndarray,
        batch_size: int = 16) -> float:
    """FID between two NHWC [0, 1] image sets (pytorch_fid.fid_score,
    ``BBDM/evaluation/FID.py:11-17``)."""
    fa = inception_features(inception, images_a, batch_size)
    fb = inception_features(inception, images_b, batch_size)
    return fid_from_features(fa, fb)


@torch.no_grad()
def lpips(alex, lin_weights, images_a, images_b,
          batch_size: int = 16) -> np.ndarray:
    """LPIPS(alex) per pair (``BBDM/evaluation/LPIPS.py:10-30``) through
    the port's ``AlexNetFeatures`` ``alex`` on its device: NHWC inputs in
    [0, 1], ``batch_size`` pairs a call. Returns (N,)."""
    from semantic_segmentation_torch.models.extractors import lpips_alex
    dev = _device_of(alex)

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    out = [lpips_alex(alex, lin_weights, put(images_a[i:i + batch_size]),
                      put(images_b[i:i + batch_size])).cpu()
           for i in range(0, len(images_a), batch_size)]
    return torch.cat(out).numpy()


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         k1: float = 0.01, k2: float = 0.03, win: int = 7):
    """Simple windowed SSIM (uniform window) for volume/image QA."""
    from numpy.lib.stride_tricks import sliding_window_view
    aw = sliding_window_view(a, (win,) * a.ndim)
    bw = sliding_window_view(b, (win,) * b.ndim)
    wa = tuple(range(a.ndim, 2 * a.ndim))
    mu_a, mu_b = aw.mean(axis=wa), bw.mean(axis=wa)
    var_a, var_b = aw.var(axis=wa), bw.var(axis=wa)
    cov = (aw * bw).mean(axis=wa) - mu_a * mu_b
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / \
        ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))
    return float(s.mean())


def volume_metrics(fake: np.ndarray, real: np.ndarray,
                   mask: np.ndarray | None = None):
    """ExcelEvaluate-style metrics (GenSeg-3D/util/evaluation.py:7-99)."""
    if mask is not None:
        sel = mask.astype(bool)
        f, r = fake[sel], real[sel]
    else:
        f, r = fake.ravel(), real.ravel()
    mae = float(np.mean(np.abs(f - r)))
    mse = float(np.mean((f - r) ** 2))
    rng = float(real.max() - real.min()) or 1.0
    psnr = float(10.0 * np.log10(rng ** 2 / mse)) if mse > 0 else float("inf")
    return {"mae": mae, "mse": mse, "psnr": psnr,
            "ssim": ssim(fake.squeeze(), real.squeeze())}


def sample_diversity(samples: np.ndarray) -> float:
    """diversity.py: mean pixel std over repeated samples per condition.
    ``samples`` shape (n_conditions, n_samples, H, W, C)."""
    return float(np.mean(np.std(samples, axis=1)))


def write_metrics_csv(rows: list[dict], path: str):
    """CSV stand-in for the reference's Excel sheet writer."""
    if not rows:
        return
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
