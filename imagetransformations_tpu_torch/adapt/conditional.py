"""Image-entropy-conditioned transforms (PyTorch).

Counterpart of ``imagetransformations_tpu/adapt/conditional.py``: each
image's 256-bin pixel-histogram Shannon entropy (``ops.histogram
.image_entropy``) decides whether a corrective chain applies to it (the
reference's rule-based experiments, fall_2025/Initial_Experiments.py), and
the fraction above a threshold is conditional TENT's batch gate
(TENT_Pipelines.py:239-303).

The chain runs on the whole batch through ``build_chain_fn`` (its kernels:
the fused blur -> rotation -> grayscale chain on the luma kernel), and a
mask selects between it and the input, as in JAX. The port's entropy is
summed in f64 where JAX sums f32 terms (1.4e-6 bits apart at most on the
CPU tests' images), so an image whose entropy lies that close to the
threshold may fall on the other side.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import entry_device, to_device
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.ops.histogram import image_entropy
from imagetransformations_tpu_torch.pipeline.chain import Chain, build_chain_fn


def apply_if_entropy(
    images_u8,
    chain: Chain,
    threshold: float = 1.16,
    above: bool = True,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply ``chain`` only to the images whose pixel entropy crosses
    ``threshold``: above it with ``above`` (noisy images), else below it
    (flat or degraded ones). Returns (the mixed batch, the flagged mask).
    ``generator`` feeds the chain's noise ops. Runs on ``device`` (None
    means "cuda", which raises without a GPU)."""
    dev = entry_device(device, "apply_if_entropy")
    x = to_device(images_u8, dev)
    ent = image_entropy(x)
    flagged = ent > threshold if above else ent < threshold
    transformed = build_chain_fn(chain, device=dev)(x, generator)
    return torch.where(flagged.reshape(-1, 1, 1, 1), transformed, x), flagged


def batch_gate_fraction(images_u8: torch.Tensor, threshold: float = 1.16) -> torch.Tensor:
    """Fraction of the batch above the pixel-entropy threshold, f32 on the
    batch's device: conditional TENT adapts iff it is > 0.5
    (TENT_Pipelines.py:270-303). The count times f32(1 / n), as XLA takes
    JAX's mean (and PyTorch's CUDA mean; its CPU mean divides)."""
    above = (image_entropy(images_u8) > threshold).to(torch.float32)
    return torch.sum(above) * float(np.float32(1.0) / np.float32(above.shape[0]))


def conditional_transform_eval(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    to_model_space: Callable[[torch.Tensor], torch.Tensor],
    images_u8,
    labels,
    chain: Chain,
    threshold: float = 1.16,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Initial_Experiments-style comparison: accuracy without and with the
    entropy-gated corrective chain (``apply_if_entropy``), one forward of
    the whole batch each. Returns ``{"n_flagged", "accuracy_base",
    "accuracy_conditional"}``. Runs on ``device`` (None means "cuda")."""
    dev = entry_device(device, "conditional_transform_eval")
    x, y = to_device(images_u8, dev), to_device(labels, dev)
    mixed, flagged = apply_if_entropy(x, chain, threshold, generator=generator, device=dev)

    def acc(batch):
        with torch.no_grad(), full_f32():
            pred = torch.argmax(model_fn(to_model_space(batch)), dim=-1)
        return float(torch.mean((pred == y).to(torch.float32)))

    return {"n_flagged": int(torch.sum(flagged)), "accuracy_base": acc(x),
            "accuracy_conditional": acc(mixed)}
