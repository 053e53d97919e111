"""Uncertainty quantification (PyTorch): the logit metrics, calibration and
ranking metrics, ODIN and Mahalanobis. Counterpart of
``imagetransformations_tpu/uq``; ``mc``, ``knn``, ``laplace``, ``swag`` and
``sgld`` are not ported yet (ROADMAP A.5)."""

from imagetransformations_tpu_torch.uq import calibration, metrics  # noqa: F401
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
