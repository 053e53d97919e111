"""Test-time adaptation, augmentation, calibration and input refinement
(PyTorch): reverse-FGSM refinement (``refine``), TENT (``tent``), the
entropy gate (``conditional``), TTA (``tta``), MATTA / VATTA (``matta``),
post-hoc calibration (``posthoc``) and AugMix (``augmix``). Partial:
``patches`` and ``evolution`` of ``imagetransformations_tpu/adapt`` are not
ported yet (ROADMAP A.8 (c))."""

from imagetransformations_tpu_torch.adapt import (  # noqa: F401
    augmix,
    conditional,
    matta,
    posthoc,
    refine,
    tent,
    tta,
)
