"""Frechet Inception Distance (twin of cogview_tpu/eval_utils/fid.py): the
TTUR-derived math of the reference (eval_utils/fid_score.py) with a
pluggable feature extractor.  Features are computed on the device, the
statistics on the host in float64.

Extractors:

  * :class:`InceptionFeatures`: pool3 2048-d InceptionV3 features; pass a
    torchvision ``inception_v3`` state-dict file for published-comparable
    FID.  Without one it draws its own seeded random network
    (``inception.init_model(0)``, not the JAX package's ``PRNGKey(0)``
    numbers) and says so in ``pretrained`` (False): the architecture runs,
    the numbers are not comparable to published ones.
  * :class:`VQEncoderFeatures`: an offline proxy, the VQ-VAE encoder's
    spatially pooled pre-quantization features; relative comparisons only.

or pass any callable ``images [n,h,w,3] float in [0,1] -> features [n,d]``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
from scipy import linalg


def compute_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


class StreamingStats:
    """Accumulate (mu, sigma) from feature batches without holding the
    corpus: n, sum, and sum-of-outer-products in float64.  Finalizes to the
    same unbiased covariance as ``np.cov`` (ddof=1); fewer than two
    samples raise."""

    def __init__(self):
        self.n = 0
        self._sum = None
        self._outer = None

    def update(self, features: np.ndarray) -> None:
        f = np.asarray(features, np.float64)
        if f.ndim != 2:
            raise ValueError(f"features must be [n, d], got {f.shape}")
        if self._sum is None:
            self._sum = np.zeros(f.shape[1])
            self._outer = np.zeros((f.shape[1], f.shape[1]))
        self.n += f.shape[0]
        self._sum += f.sum(axis=0)
        self._outer += f.T @ f

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.n < 2:
            raise ValueError(f"need >=2 samples for covariance, got {self.n}")
        mu = self._sum / self.n
        sigma = (self._outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, sigma


def statistics_from_batches(image_batches, extractor) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) over a stream of image batches [b,h,w,3] in [0,1]."""
    stats = StreamingStats()
    for batch in image_batches:
        stats.update(np.asarray(extractor(batch)))
    return stats.finalize()


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)) (fid_score.py math)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    # the JAX package passes disp=False, which newer SciPy removed; without
    # it both return the root alone
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real

    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    mu1, s1 = compute_statistics(feats1)
    mu2, s2 = compute_statistics(feats2)
    return frechet_distance(mu1, s1, mu2, s2)


def fid_from_images(
    images1: np.ndarray,
    images2: np.ndarray,
    extractor: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 32,
) -> float:
    def feats(images):
        out = []
        for i in range(0, len(images), batch_size):
            out.append(np.asarray(extractor(images[i : i + batch_size])))
        return np.concatenate(out, axis=0)

    return fid_from_features(feats(images1), feats(images2))


class InceptionFeatures:
    """pool3 (2048-d) InceptionV3 features on ``device``.

    ``weights_path``: a torchvision ``inception_v3`` state-dict file; when
    None, a seeded random network (``self.pretrained`` records which).
    """

    def __init__(self, weights_path=None, model=None, device=None):
        from . import inception

        self.device = torch.device(device if device is not None else "cpu")
        if model is not None:
            self.pretrained = True
        elif weights_path is not None:
            model = inception.load_model(weights_path)
            self.pretrained = True
        else:
            model = inception.init_model(0, with_fc=False)
            self.pretrained = False
        self.model = model.to(self.device)
        self._fn = inception.pool3_features

    def __call__(self, images: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        return self._fn(self.model, x).cpu().numpy()


class VQEncoderFeatures:
    """Offline proxy extractor: pooled VQ-VAE encoder features.

    images in [0,1] -> normalize -> encoder -> spatial mean [n, embed_dim].
    """

    def __init__(self, vq_params, mean=None, std=None, device=None):
        from ..models import vqvae

        self.device = torch.device(device if device is not None else "cpu")
        self.params = vq_params
        self.mean = torch.tensor(mean if mean is not None else vqvae.IMG_MEAN, device=self.device)
        self.std = torch.tensor(std if std is not None else vqvae.IMG_STD, device=self.device)
        self._encode = vqvae.encode_features

    @torch.no_grad()
    def __call__(self, images: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        z = self._encode(self.params, (x - self.mean) / self.std)
        return torch.mean(z, dim=(1, 2)).cpu().numpy()
