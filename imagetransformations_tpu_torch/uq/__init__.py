"""Uncertainty quantification (PyTorch): the logit metrics, calibration and
ranking metrics, ODIN, Mahalanobis, Monte-Carlo sampling (``mc``), the
SWAG and SGLD posteriors, the last-layer Laplace approximation and deep
k-NN. Counterpart of ``imagetransformations_tpu/uq``."""

from imagetransformations_tpu_torch.uq import calibration, mc, metrics  # noqa: F401
from imagetransformations_tpu_torch.uq.metrics import (  # noqa: F401
    doctor_alpha,
    doctor_beta,
    energy_score,
    least_confidence,
    margin,
    max_logit,
    msp,
    ratio,
    renyi_entropy,
    shannon_entropy,
    tsallis_entropy,
)
