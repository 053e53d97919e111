"""CIFAR ResNet-20/56 (PyTorch, NCHW).

Counterpart of ``imagetransformations_tpu/models/resnet.py:30-125``: the
``chenyaofo/pytorch-cifar-models`` nets the reference loads through
torch.hub everywhere (pipeline/metrics/shannon_entropy.py:28,
fall_2025/generalizedOdin2.py:12). Three stages of n BasicBlocks at widths
16/32/64 with the hub models' 1x1-conv downsample. The parameter names are
chenyaofo's (``conv1``, ``bn1``, ``layer{s}.{b}.conv1|bn1|conv2|bn2|
downsample.0|downsample.1``, ``fc``), so a hub state_dict loads with
``load_state_dict`` and the JAX importer ``load_torch_state_dict`` maps
``state_dict()`` into flax.

``forward`` returns logits, ``features`` the pooled penultimate embedding
(the reference's monkey-patched ``forward_features``,
pipeline/metrics/dknn2.py:109-120). ``mc=True`` inserts flax-style dropout
after each block, its mask drawn from the caller's ``torch.Generator``
(MC dropout, pipeline/metrics/mutual_info.py:35-41). Every forward runs in
true f32 (``core.precision.full_f32``); on a CUDA device the blocks run
NCHW-contiguous (``_layers.body_layout``), with the arithmetic of the
channels-last forward.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from imagetransformations_tpu_torch.core.image import entry_device
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.models._layers import (BatchNorm, body_layout, dropout,
                                                            init_like_flax, mean_pool)


def conv3x3(cin: int, cout: int, stride: int = 1, device=None) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, 1, bias=False, device=device)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = conv3x3(cin, planes, stride, device)
        self.bn1 = BatchNorm(planes, device)
        self.conv2 = conv3x3(planes, planes, 1, device)
        self.bn2 = BatchNorm(planes, device)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.ModuleList([
                nn.Conv2d(cin, planes, 1, stride, bias=False, device=device),
                BatchNorm(planes, device)])

    def forward(self, x, train: bool = False):
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if self.downsample is not None:
            conv, bn = self.downsample
            x = bn(conv(x), train)
        return torch.relu(y + x)


class CifarResNet(nn.Module):
    """ResNet for 32x32 inputs; depth 6n+2 (n blocks a stage). ``device``:
    None means "cuda" (raises without a GPU), or "cpu"."""

    def __init__(self, num_blocks: Sequence[int] = (9, 9, 9), num_classes: int = 10,
                 dropout_rate: float = 0.5, device=None):
        super().__init__()
        dev = entry_device(device, type(self).__name__)
        self.dropout_rate = dropout_rate
        self.conv1 = conv3x3(3, 16, 1, dev)
        self.bn1 = BatchNorm(16, dev)
        cin = 16
        for stage, (nblocks, planes) in enumerate(zip(num_blocks, (16, 32, 64))):
            blocks = []
            for b in range(nblocks):
                blocks.append(BasicBlock(cin, planes, 2 if (stage > 0 and b == 0) else 1, dev))
                cin = planes
            setattr(self, f"layer{stage + 1}", nn.ModuleList(blocks))
        self.fc = nn.Linear(64, num_classes, device=dev)
        init_like_flax(self)

    def _blocks(self):
        return [b for s in (self.layer1, self.layer2, self.layer3) for b in s]

    def backbone(self, x, train: bool = False, mc: bool = False,
                 generator: torch.Generator | None = None):
        with full_f32():
            x = body_layout(torch.relu(self.bn1(self.conv1(x), train)))
            for block in self._blocks():
                x = block(x, train)
                if mc:
                    x = dropout(x, self.dropout_rate, generator)
            return mean_pool(x)  # [N, 64]

    def forward(self, x, train: bool = False, mc: bool = False,
                generator: torch.Generator | None = None):
        return self.features_and_logits(x, train, mc, generator)[1]

    def features(self, x, train: bool = False, mc: bool = False,
                 generator: torch.Generator | None = None):
        """Penultimate pooled features (forward_features parity,
        pipeline/metrics/dknn2.py:109-120)."""
        return self.backbone(x, train, mc, generator)

    def features_and_logits(self, x, train: bool = False, mc: bool = False,
                            generator: torch.Generator | None = None):
        feats = self.backbone(x, train, mc, generator)
        with full_f32():
            return feats, self.fc(feats)


def resnet20(num_classes: int = 10, device=None) -> CifarResNet:
    return CifarResNet((3, 3, 3), num_classes, device=device)


def resnet56(num_classes: int = 10, device=None) -> CifarResNet:
    return CifarResNet((9, 9, 9), num_classes, device=device)


#: CIFAR-10 normalization used by every reference eval script
CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)


def normalize(x01: torch.Tensor, mean: np.ndarray, std: np.ndarray) -> torch.Tensor:
    """``(x01 - mean) / std`` over the last (channel) axis, a true f32
    division on every device (PyTorch's CUDA kernel multiplies by the
    reciprocal of a Python-number divisor, the CPU divides)."""
    m = torch.as_tensor(mean, device=x01.device)
    s = torch.as_tensor(std, device=x01.device)
    return (x01 - m) / s


def normalize_cifar(x01: torch.Tensor) -> torch.Tensor:
    """[0,1] NHWC -> normalized (torchvision Normalize parity)."""
    return normalize(x01, CIFAR_MEAN, CIFAR_STD)


def to_unit(u8: torch.Tensor) -> torch.Tensor:
    """u8 -> f32 in [0, 1]: ``x / 255`` as a true division on every device."""
    return u8.to(torch.float32) / torch.tensor(255.0, device=u8.device)


def cifar_model_space(u8_nhwc: torch.Tensor) -> torch.Tensor:
    """u8 NHWC batch -> the CIFAR nets' normalized f32 NCHW input; the NCHW
    tensor keeps the channels-last strides (the permute copies nothing)."""
    return normalize_cifar(to_unit(u8_nhwc)).permute(0, 3, 1, 2)
