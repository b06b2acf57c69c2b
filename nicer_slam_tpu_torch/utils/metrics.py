"""Image quality metrics: PSNR, SSIM and LPIPS (counterpart of
nicer_slam_tpu/utils/metrics.py; reference: utils/rend_util.py:23-31,
utils/SSIM/__init__.py, evaluation/eval_rendering.py:43-47). PSNR and SSIM
are numpy/scipy on the host; LPIPS is this package's AlexNet-LPIPS
(models/lpips.py) unless a callable is injected.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """-10 log10(mse) for [0,1] images (rend_util.py:23-31)."""
    mse = float(np.mean((np.asarray(img1, np.float64)
                         - np.asarray(img2, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return -10.0 * np.log10(mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def ssim(img1: np.ndarray, img2: np.ndarray, data_range: float = 1.0,
         win_size: int = 11, sigma: float = 1.5) -> float:
    """Classic windowed SSIM (utils/SSIM/__init__.py semantics: gaussian
    11x11 window, C1=(0.01 R)^2, C2=(0.03 R)^2, mean over channels)."""
    from scipy.signal import fftconvolve

    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 2:
        img1 = img1[..., None]
        img2 = img2[..., None]
    K = _gaussian_kernel(win_size, sigma)[..., None]
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2

    def filt(x):
        return np.stack([fftconvolve(x[..., c], K[..., 0], mode="valid")
                         for c in range(x.shape[-1])], -1)

    mu1 = filt(img1)
    mu2 = filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    ssim_map = (((2 * mu12 + C1) * (2 * s12 + C2))
                / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)))
    return float(ssim_map.mean())


_lpips_fn = None


def set_lpips_fn(fn) -> None:
    """Inject an LPIPS callable (img1, img2 in [0,1] HWC) -> float."""
    global _lpips_fn
    _lpips_fn = fn


def lpips(img1: np.ndarray, img2: np.ndarray, device=None) -> Optional[float]:
    """LPIPS perceptual distance (reference: eval_rendering.py:43-47).

    Resolution order: an injected callable (set_lpips_fn), else this
    package's AlexNet-LPIPS (models/lpips.py) with a converted checkpoint
    when `lpips_alex.npz` exists at the repo root (tools/convert_lpips.py),
    falling back to its deterministic random-feature variant (values then
    NOT comparable to official LPIPS; see models/lpips.py docstring). The
    package's metric runs on ``device`` when one is given (the CPU
    otherwise); an injected callable is called as it is."""
    global _lpips_fn
    from ..models.lpips import LPIPSMetric

    if _lpips_fn is None:
        import os

        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        _lpips_fn = LPIPSMetric(os.path.join(root, "lpips_alex.npz"))
    if device is not None and isinstance(_lpips_fn, LPIPSMetric):
        _lpips_fn.to(device)
    return float(_lpips_fn(img1, img2))
