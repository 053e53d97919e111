"""SimpleCNN — the reference's deep-ensemble member architecture (PyTorch).

Counterpart of ``imagetransformations_tpu/models/simple_cnn.py:17-34``
(pipeline/metrics/ensemble.py:28-47): conv5x5(64)+BN+pool,
conv5x5(128)+BN+pool (VALID padding, torch's default), then a 256-128-10
MLP. The port flattens NCHW, as the reference's torch net does; the JAX
model flattens NHWC, so ``models.convert`` permutes ``fc1``'s 3200 input
rows between the two (``FLATTEN_CHW``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from imagetransformations_tpu_torch.core.image import entry_device
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.models._layers import BatchNorm, init_like_flax


class SimpleCNN(nn.Module):
    #: (c, h, w) of the map fc1 flattens, for a 32x32 input
    FLATTEN_CHW = (128, 5, 5)

    def __init__(self, num_classes: int = 10, device=None):
        super().__init__()
        dev = entry_device(device, "SimpleCNN")
        self.conv1 = nn.Conv2d(3, 64, 5, device=dev)
        self.bn1 = BatchNorm(64, dev)
        self.conv2 = nn.Conv2d(64, 128, 5, device=dev)
        self.bn2 = BatchNorm(128, dev)
        self.fc1 = nn.Linear(128 * 5 * 5, 256, device=dev)
        self.fc2 = nn.Linear(256, 128, device=dev)
        self.fc3 = nn.Linear(128, num_classes, device=dev)
        init_like_flax(self)

    def forward(self, x, train: bool = False):
        with full_f32():
            x = F.max_pool2d(torch.relu(self.bn1(self.conv1(x), train)), 2)
            x = F.max_pool2d(torch.relu(self.bn2(self.conv2(x), train)), 2)
            x = x.flatten(1)  # [N, 128*5*5], CHW order
            x = torch.relu(self.fc1(x))
            x = torch.relu(self.fc2(x))
            return self.fc3(x)
