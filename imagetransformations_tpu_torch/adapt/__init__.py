"""Test-time adaptation, augmentation, calibration and input refinement
(PyTorch): reverse-FGSM refinement (``refine``), TENT (``tent``), the
entropy gate (``conditional``), TTA (``tta``), MATTA / VATTA (``matta``),
post-hoc calibration (``posthoc``), AugMix (``augmix``), angelic patches
(``patches``) and the evolutionary transform search (``evolution``): every
module of ``imagetransformations_tpu/adapt``."""

from imagetransformations_tpu_torch.adapt import (  # noqa: F401
    augmix,
    conditional,
    evolution,
    matta,
    patches,
    posthoc,
    refine,
    tent,
    tta,
)
