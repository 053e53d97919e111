"""Bayes-by-backprop CNN (PyTorch): reparameterized weights with a KL term
to a N(0, prior_sigma²) prior.

Counterpart of ``imagetransformations_tpu/models/bayesian.py:21-113``
(pipeline/metrics/baysian.py:32-130): each weight is ``mu +
softplus(rho) * eps`` with ``eps ~ N(0, 1)`` drawn from the generator passed
to the forward (the JAX model's "sample" rng), weights before biases,
layer by layer. Each layer keeps the KL term of its last forward in
``self.kl`` (flax's ``sow("losses", "kl")``); ``kl_loss`` sums them.
Parameters are torch-shaped (``mu`` OIHW for the convolutions, [out, in]
for the dense layers); ``models.convert`` maps them to and from the JAX
package's HWIO / [in, out] and permutes ``fc1``'s rows between the port's
CHW flatten and JAX's HWC one (``BayesianCNN.FLATTEN_CHW``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imagetransformations_tpu_torch.core.image import entry_device
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.models._layers import BatchNorm


def _kl_normal(mu, sigma, prior_sigma: float):
    """KL( N(mu, sigma^2) || N(0, prior_sigma^2) ), summed."""
    var_ratio = (sigma / prior_sigma) ** 2
    return 0.5 * torch.sum(var_ratio + (mu / prior_sigma) ** 2 - 1.0 - torch.log(var_ratio))


class _Bayesian(nn.Module):
    """``mu`` ~ N(0, 0.1²), ``rho`` = -3, ``bias_mu`` = 0, ``bias_rho`` = -3
    (the JAX initializers)."""

    def __init__(self, shape, features: int, prior_sigma: float, device):
        super().__init__()
        self.prior_sigma = prior_sigma
        self.mu = nn.Parameter(0.1 * torch.randn(shape, device=device))
        self.rho = nn.Parameter(torch.full(shape, -3.0, device=device))
        self.bias_mu = nn.Parameter(torch.zeros(features, device=device))
        self.bias_rho = nn.Parameter(torch.full((features,), -3.0, device=device))
        self.kl = None

    def sample(self, generator: torch.Generator | None):
        """(w, b) drawn for one forward; records the layer's KL term."""
        sigma, bsigma = F.softplus(self.rho), F.softplus(self.bias_rho)
        eps_w = torch.randn(self.mu.shape, generator=generator, device=self.mu.device)
        eps_b = torch.randn(self.bias_mu.shape, generator=generator, device=self.mu.device)
        self.kl = (_kl_normal(self.mu, sigma, self.prior_sigma)
                   + _kl_normal(self.bias_mu, bsigma, self.prior_sigma))
        return self.mu + sigma * eps_w, self.bias_mu + bsigma * eps_b


class BayesianConv(_Bayesian):
    def __init__(self, cin: int, features: int, kernel_size, padding: int = 0,
                 prior_sigma: float = 1.0, device=None):
        kh, kw = kernel_size
        super().__init__((features, cin, kh, kw), features, prior_sigma, device)
        self.padding = padding

    def forward(self, x, generator=None):
        w, b = self.sample(generator)
        return F.conv2d(x, w, b, padding=self.padding)


class BayesianDense(_Bayesian):
    def __init__(self, cin: int, features: int, prior_sigma: float = 1.0, device=None):
        super().__init__((features, cin), features, prior_sigma, device)

    def forward(self, x, generator=None):
        w, b = self.sample(generator)
        return F.linear(x, w, b)


class BayesianCNN(nn.Module):
    """conv5x5(64, pad 2)+BN+pool / conv5x5(128, pad 2)+BN+pool / fc
    256-128-10 with Bayesian layers (baysian.py:32-130)."""

    #: (c, h, w) of the map fc1 flattens, for a 32x32 input
    FLATTEN_CHW = (128, 8, 8)

    def __init__(self, num_classes: int = 10, prior_sigma: float = 1.0, device=None):
        super().__init__()
        dev = entry_device(device, "BayesianCNN")
        self.conv1 = BayesianConv(3, 64, (5, 5), 2, prior_sigma, dev)
        self.bn1 = BatchNorm(64, dev)
        self.conv2 = BayesianConv(64, 128, (5, 5), 2, prior_sigma, dev)
        self.bn2 = BatchNorm(128, dev)
        self.fc1 = BayesianDense(128 * 8 * 8, 256, prior_sigma, dev)
        self.fc2 = BayesianDense(256, 128, prior_sigma, dev)
        self.fc3 = BayesianDense(128, num_classes, prior_sigma, dev)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        g = generator
        with full_f32():
            x = F.max_pool2d(torch.relu(self.bn1(self.conv1(x, g), train)), 2)
            x = F.max_pool2d(torch.relu(self.bn2(self.conv2(x, g), train)), 2)
            x = x.flatten(1)  # [N, 128*8*8], CHW order
            x = torch.relu(self.fc1(x, g))
            x = torch.relu(self.fc2(x, g))
            return self.fc3(x, g)


def kl_loss(model: nn.Module) -> torch.Tensor:
    """Sum of the KL terms the model's Bayesian layers recorded in their last
    forward (get_kl_loss parity, baysian.py:126-130); 0 before any."""
    terms = [m.kl for m in model.modules() if isinstance(m, _Bayesian) and m.kl is not None]
    return sum(terms) if terms else torch.zeros(())


def predictive_samples(model: BayesianCNN, x: torch.Tensor, generator: torch.Generator,
                       num_samples: int = 50, train: bool = False) -> torch.Tensor:
    """[T, N, C] logits from T weight samples drawn from ``generator``, one
    forward a sample."""
    return torch.stack([model(x, train, generator) for _ in range(num_samples)])
