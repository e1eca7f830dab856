"""Generative-quality metrics: FID, KID, IS, with pluggable feature extractors.

Port of ``ivid_tpu/evals/metrics.py``; the statistics are numpy copies of
its own. The reference delegates to torch-fidelity's InceptionV3 pipeline
(reference: eval.py:133-137); no pretrained weights ship with the
repository, so the feature extractor is pluggable:

- ``inception:<path>``: a local InceptionV3 weight file (the torch
  state_dict of torch-fidelity's feature extractor,
  :mod:`ivid_tpu_torch.evals.inception`), for torch-fidelity-comparable FID;
- ``randconv`` (default): a fixed-seed random convolutional feature network.
  Its weights are the JAX package's own draws (:mod:`.threefry` reproduces
  them bit for bit), so both packages score in one feature space. It is a
  deterministic RELATIVE metric: it ranks checkpoints and detects drift,
  but its absolute scale is NOT comparable to Inception-FID.

The extractors compute in float32 with TF32 off for convolutions and matrix
products alike, so the card's features follow the CPU's.
"""

from __future__ import annotations

import contextlib
import hashlib
import inspect
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ivid_tpu_torch.evals import threefry

# ---------------------------------------------------------------- statistics


def feature_statistics(features: np.ndarray):
    """Mean and covariance in float64, like torch-fidelity."""
    features = np.asarray(features, np.float64)
    return features.mean(axis=0), np.cov(features, rowvar=False)


def _sqrtm(m: np.ndarray) -> np.ndarray:
    """scipy's matrix square root without its error printout: ``disp=False``
    where SciPy has the argument (it returns the root and an error estimate
    then); SciPy 1.18 dropped it and returns the root alone."""
    import scipy.linalg

    if "disp" in inspect.signature(scipy.linalg.sqrtm).parameters:
        return scipy.linalg.sqrtm(m, disp=False)[0]
    return scipy.linalg.sqrtm(m)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two feature Gaussians (Heusel et al. 2017)."""
    import scipy.linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def kernel_inception_distance(feats1: np.ndarray, feats2: np.ndarray, subset_size: int = 1000,
                              num_subsets: int = 100, seed: int = 0) -> Dict[str, float]:
    """Unbiased MMD² with the torch-fidelity polynomial kernel
    ``(x·y/d + 1)³`` over random subsets."""
    rng = np.random.default_rng(seed)
    d = feats1.shape[1]
    n = min(subset_size, len(feats1), len(feats2))
    mmds = []
    for _ in range(num_subsets):
        x = feats1[rng.choice(len(feats1), n, replace=False)].astype(np.float64)
        y = feats2[rng.choice(len(feats2), n, replace=False)].astype(np.float64)
        kxx = (x @ x.T / d + 1) ** 3
        kyy = (y @ y.T / d + 1) ** 3
        kxy = (x @ y.T / d + 1) ** 3
        sum_xx = (kxx.sum() - np.trace(kxx)) / (n * (n - 1))
        sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
        mmds.append(sum_xx + sum_yy - 2 * kxy.mean())
    mmds = np.asarray(mmds)
    return {"mean": float(mmds.mean()), "std": float(mmds.std())}


def inception_score(logits: np.ndarray, splits: int = 10) -> Dict[str, float]:
    """IS from classifier logits: exp(E_x KL(p(y|x) || p(y)))."""
    logits = logits - logits.max(axis=1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)
    scores = []
    for chunk in np.array_split(probs, min(splits, len(probs))):
        if len(chunk) == 0:
            continue
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = (chunk * (np.log(chunk + 1e-12) - np.log(marginal + 1e-12))).sum(axis=1)
        scores.append(np.exp(kl.mean()))
    return {"mean": float(np.mean(scores)), "std": float(np.std(scores))}


# ----------------------------------------------------------- feature network


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions and matrix products without TF32 (cuDNN's
    convolutions allow it by default)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def pad_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """XLA's ``"SAME"`` padding of an NCHW tensor for a ``k``-wide window
    at ``stride``: the output has ceil(n / stride) positions, and an odd
    total pad puts the extra row or column at the end (with stride 2 and
    k = 3, (0, 1) on even sizes)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class RandConvFeatures:
    """Fixed-seed random convolutional feature extractor: 5 stride-2 3x3
    conv stages with leaky-relu down to a 2048-d global-average feature,
    plus a 1008-d random logit head (the Inception feature and logit
    widths, so downstream code is drop-in). The weights are
    ``jax.random.normal`` draws from ``PRNGKey(seed)``, as the JAX package
    makes them; ``image_size`` is accepted for the extractor interface and
    unused (the network is global-average pooled)."""

    feature_dim = 2048
    logit_dim = 1008
    widths = (64, 128, 256, 512, 2048)

    def __init__(self, seed: int = 0, image_size: int = 128, device="cuda"):
        key = threefry.prng_key(seed)
        params, c_in = [], 3
        for w in self.widths:
            key, k1 = threefry.split(key)
            params.append(threefry.normal(k1, (3, 3, c_in, w)) * np.float32(np.sqrt(2.0 / (9 * c_in))))
            c_in = w
        key, k2 = threefry.split(key)
        head = threefry.normal(k2, (self.feature_dim, self.logit_dim)) * np.float32(
            np.sqrt(1.0 / self.feature_dim))
        self.load_arrays(params, head, device)

    @classmethod
    def from_arrays(cls, params, head, device="cuda") -> "RandConvFeatures":
        """An extractor with the given weights: ``params`` the five HWIO
        kernels and ``head`` [2048, 1008], as numpy arrays (the JAX
        extractor's ``params`` and ``head``)."""
        ext = cls.__new__(cls)
        ext.load_arrays(params, head, device)
        return ext

    def load_arrays(self, params, head, device):
        self.device = torch.device(device)
        self.kernels = [torch.from_numpy(np.asarray(k, np.float32).transpose(3, 2, 0, 1).copy())
                        .to(self.device) for k in params]
        self.head = torch.from_numpy(np.array(head, np.float32)).to(self.device)

    def forward(self, imgs: torch.Tensor):
        """imgs [B,H,W,3] in [0,1] → (features [B,2048], logits [B,1008])."""
        x = imgs.permute(0, 3, 1, 2) * 2 - 1
        for kern in self.kernels:
            x = F.leaky_relu(F.conv2d(pad_same(x, 3, 2), kern, stride=2), 0.2)
        feats = x.mean(dim=(2, 3))
        return feats, feats @ self.head

    def __call__(self, images: np.ndarray, batch: int = 64):
        return run_batches(self.forward, images, self.device, batch)


def run_batches(forward, images: np.ndarray, device, batch: int):
    """``forward`` over ``images`` [N,H,W,3] in batches on ``device``, in
    float32 without TF32; numpy (features, logits)."""
    feats, logits = [], []
    with torch.no_grad(), no_tf32():
        for i in range(0, len(images), batch):
            x = torch.from_numpy(np.ascontiguousarray(images[i:i + batch], np.float32)).to(device)
            f, lg = forward(x)
            feats.append(f.cpu().numpy())
            logits.append(lg.cpu().numpy())
    return np.concatenate(feats), np.concatenate(logits)


def get_extractor(name: str, image_size: int = 128, device="cuda"):
    if name == "randconv":
        return RandConvFeatures(image_size=image_size, device=device)
    if name.startswith("inception:"):
        from ivid_tpu_torch.evals.inception import InceptionFeatures

        return InceptionFeatures(name.split(":", 1)[1], device=device)
    raise ValueError(f"unknown extractor {name!r}")


def extract_features(images: np.ndarray, ext, cache_path: Optional[str] = None):
    """Run (or load cached) features+logits for an image set. The feature
    cache mirrors the reference's torch-fidelity stat caching
    (reference: eval.py:11-23): real-set features are reused across evals.

    Staleness is checked by a content fingerprint of the image set (sampled
    pixel hash + shape), not just the image count: a regenerated set with the
    same count under the same cache name must not score stale features."""
    fp = _image_set_fingerprint(images)
    if cache_path and os.path.exists(cache_path):
        z = np.load(cache_path)
        if "fingerprint" in z and str(z["fingerprint"]) == fp:
            return z["feats"], z["logits"]
    feats, logits = ext(images)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez_compressed(cache_path, feats=feats, logits=logits, fingerprint=fp)
    return feats, logits


def _image_set_fingerprint(images: np.ndarray) -> str:
    """Cheap content hash: shape + sha1 over <=256 deterministically sampled
    images (the JAX package's string, so either package's cache serves the
    other)."""
    n = len(images)
    idx = np.linspace(0, n - 1, num=min(n, 256), dtype=np.int64) if n else []
    h = hashlib.sha1()
    h.update(repr((images.shape, str(images.dtype))).encode())
    for i in idx:
        h.update(np.ascontiguousarray(images[i]).tobytes())
    return h.hexdigest()


def _safe_tag(extractor: str) -> str:
    return extractor.replace("/", "_").replace(":", "-")


def compute_metrics(fake_images: np.ndarray, real_images: np.ndarray,
                    extractor: str = "randconv", isc: bool = True, fid: bool = True,
                    kid: bool = True, cache_dir: Optional[str] = None,
                    fake_name: Optional[str] = None, real_name: Optional[str] = None,
                    device="cuda") -> Dict[str, float]:
    """Images are [N,H,W,3] float in [0,1]. Returns a torch-fidelity-shaped
    metrics dict with the extractor recorded. With ``cache_dir`` + names set,
    extracted features are cached as ``<cache_dir>/<name>-feats-<ext>.npz``.
    The extractor runs on ``device``."""
    ext = get_extractor(extractor, image_size=fake_images.shape[1], device=device)

    def cpath(name):
        if cache_dir is None or name is None:
            return None
        return os.path.join(cache_dir, f"{name}-feats-{_safe_tag(extractor)}.npz")

    f_fake, l_fake = extract_features(fake_images, ext, cpath(fake_name))
    f_real, _ = extract_features(real_images, ext, cpath(real_name))
    out: Dict[str, float] = {"feature_extractor": extractor}
    if fid:
        out["frechet_inception_distance"] = frechet_distance(
            *feature_statistics(f_fake), *feature_statistics(f_real))
    if kid:
        k = kernel_inception_distance(f_fake, f_real)
        out["kernel_inception_distance_mean"] = k["mean"]
        out["kernel_inception_distance_std"] = k["std"]
    if isc:
        s = inception_score(l_fake)
        out["inception_score_mean"] = s["mean"]
        out["inception_score_std"] = s["std"]
    return out
