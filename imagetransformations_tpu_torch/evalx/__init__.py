"""Evaluation (PyTorch): the corruption dispatch and sweep harness
(``harness``), reports (``report``) and flip analysis with failure heads
(``analysis``)."""

from imagetransformations_tpu_torch.evalx.harness import (  # noqa: F401
    CORRUPTIONS,
    analyze_uncertainty_thresholds,
    corrupt,
    corruption_sweep,
    evaluate_batched,
    evaluate_sharded,
)
