"""What the port's models share with flax: its initializers, its BatchNorm
rule and its dropout."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from imagetransformations_tpu_torch.core.mesh import all_reduce_sum, current_batch_mesh


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and state_dict keys) that
    trains by flax's rule, as the JAX models do (``nn.BatchNorm(momentum=0.9,
    epsilon=1e-5)``): in training the batch is normalized by its mean and its
    biased variance, and the running variance is updated with that same
    biased variance (torch's own layer updates it with the unbiased one).
    The variance is taken in two passes, ``E[(x - E[x])²]``: flax's one-pass
    ``E[x²] - E[x]²`` has the same value to f32 rounding, but its gradient in
    PyTorch's autograd cancels where the mean is large (SimpleCNN's second
    convolution, of ReLU outputs: an error of 7% of the largest entry of
    conv2's weight gradient against f64, where JAX's is 1e-6). Nor is it
    ``F.batch_norm`` in training mode: its CPU backward put SimpleCNN's conv1
    weight gradient 1.5e-3 (1.2% of the largest entry) from JAX's and
    f64's, where this form is within 5e-7.
    ``forward(x, train)`` takes the mode as the JAX ``__call__`` does;
    ``self.training`` is not read. Inside ``core.mesh.batch_mesh``
    (a training step given a batch sharded over a process mesh) ``x`` is
    this rank's shard, and the mean and then the variance are sums over
    every rank's shard (a differentiable ``all_reduce`` each) over the
    global count, as GSPMD takes JAX's BatchNorm over a sharded batch: every
    rank moves its running statistics alike."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1, device=device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        dims = (0, 2, 3)
        mesh = current_batch_mesh()
        if mesh is None:
            mean = x.mean(dims)
            centered = x - mean[:, None, None]
            var = (centered * centered).mean(dims)
        else:  # x is this rank's shard: the statistics of every rank's
            n = torch.tensor(float(x.numel() // x.shape[1] * mesh.size), device=x.device)
            mean = all_reduce_sum(x.sum(dims)) / n
            centered = x - mean[:, None, None]
            var = all_reduce_sum((centered * centered).sum(dims)) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return centered * mul[:, None, None] + self.bias[:, None, None]


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` with ``deterministic=False``: keep each value
    with probability ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``.
    The mask comes from ``generator`` (a ``torch.Generator`` on ``x``'s device),
    which ``F.dropout`` cannot take."""
    if generator is None:
        raise ValueError("dropout draws its mask from a generator: pass generator=")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / torch.tensor(keep, dtype=x.dtype, device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def init_like_flax(model: nn.Module) -> nn.Module:
    """flax's default initializers in place of torch's, as the JAX models are
    built: every convolution and dense kernel ``lecun_normal`` (a normal of
    variance 1 / fan_in truncated at two deviations, its deviation scaled up
    by 1 / 0.8796 to make up for the cut), every bias 0 (BatchNorm: scale 1,
    bias 0, as torch's). With torch's defaults the demo recipe's ResNet-20
    (3 epochs of 512 synthetic images) reaches 0.426 test accuracy on the
    CPU, with these 0.547 (the JAX recipe: 0.5625; ``tools/
    demo_accuracy.py``). Draws from the default
    generator of the parameters' device; returns ``model``."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std)
                if m.bias is not None:
                    m.bias.zero_()
    return model
