"""SGLD (stochastic gradient Langevin dynamics) posterior sampling (PyTorch).

Counterpart of ``imagetransformations_tpu/uq/sgld.py:25-52``, after
pipeline/metrics/sgsc.py:28-57: an SGD step plus Gaussian noise of
deviation sqrt(2 lr T); weight snapshots collected every K steps; the
predictive entropy over the snapshot ensemble (:103-135).

The JAX package's optax transformation becomes a ``torch.optim.Optimizer``
whose noise comes from a ``torch.Generator`` (``step(noise=...)`` takes it
explicitly instead); snapshots stack to ``{name: [S, *shape]}`` for
``predictive_logits``, which is ``swag.bma_logits``.
"""

from __future__ import annotations

import torch

from imagetransformations_tpu_torch.uq.swag import bma_logits


class SGLD(torch.optim.Optimizer):
    """``p += -lr * grad + sqrt(2 lr T) * z``, z ~ N(0, 1) a parameter."""

    def __init__(self, params, lr: float, temperature: float = 1.0,
                 generator: torch.Generator | None = None):
        super().__init__(params, {"lr": lr, "temperature": temperature})
        self.generator = generator

    @torch.no_grad()
    def step(self, closure=None, noise: list[torch.Tensor] | None = None):
        """One step over the parameters with a gradient. ``noise``: the
        standard normals, one tensor a parameter in the optimizer's order
        (every parameter of every group); else drawn from the generator."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        i = 0
        for group in self.param_groups:
            lr = group["lr"]
            for p in group["params"]:
                if p.grad is not None:
                    z = noise[i] if noise is not None else torch.randn(
                        p.shape, generator=self.generator, device=p.device, dtype=p.dtype)
                    # jnp.sqrt of the f32-rounded 2 lr T, as the JAX package
                    std = torch.sqrt(torch.tensor(2.0 * lr * group["temperature"],
                                                  dtype=p.dtype, device=p.device))
                    p.add_(-lr * p.grad + std * z)
                i += 1
        return loss


def stack_snapshots(snapshots: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """List of parameter dicts -> one dict stacked on a leading sample axis."""
    return {k: torch.stack([s[k].detach() for s in snapshots]) for k in snapshots[0]}


#: [S, B, C] logits over SGLD weight samples, one forward a sample
predictive_logits = bma_logits
