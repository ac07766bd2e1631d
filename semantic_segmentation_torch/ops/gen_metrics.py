"""Generative-quality evaluation — the port of the volume metrics of
``semantic_segmentation_tpu/ops/gen_metrics.py``
(``GenSeg-3D/util/evaluation.py``): masked MAE / MSE / PSNR and a windowed
SSIM between generated and real volumes, written to CSV (the reference
writes an Excel sheet); and BBDM's sample diversity
(``BBDM/evaluation/diversity.py``). numpy, identical to the JAX package's.
FID and LPIPS come with ROADMAP.md section 1, item 12.
"""

from __future__ import annotations

import csv

import numpy as np


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
