"""Test-time adaptation and input refinement (PyTorch). Partial: only
``refine`` (reverse-FGSM refinement) is ported; ``tent``, ``tta``,
``augmix``, ``matta``, ``conditional``, ``posthoc``, ``patches`` and
``evolution`` of ``imagetransformations_tpu/adapt`` are not yet (ROADMAP
A.8)."""

from imagetransformations_tpu_torch.adapt import refine  # noqa: F401
