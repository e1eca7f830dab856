"""Generative-quality metrics (FID, KID, IS) and their feature extractors."""

from ivid_tpu_torch.evals.metrics import (
    compute_metrics,
    frechet_distance,
    inception_score,
    kernel_inception_distance,
)

__all__ = [
    "compute_metrics",
    "frechet_distance",
    "inception_score",
    "kernel_inception_distance",
]
