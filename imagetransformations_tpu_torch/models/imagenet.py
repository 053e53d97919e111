"""ImageNet classifiers (PyTorch, NCHW): ResNet-50, ResNet-18 and VGG-19-BN.

Counterpart of ``imagetransformations_tpu/models/imagenet.py:19-208``. The
reference evaluates torchvision ``resnet50``
(attacks/uncertainty/FINAL_imagenet_adversarial.py:43), ``vgg19_bn``
(attacks/normal_inference/imagenet_normal.py:60) and trains ``resnet18``
(attacks/fgsm.py:55,222). Parameter names are torchvision's (``conv1``,
``layer{s}.{b}.conv{i}|bn{i}|downsample.{0,1}``, ``fc``; VGG's
``features.N`` and ``classifier.{0,3,6}``), so a torchvision state_dict
loads with ``load_state_dict`` and the JAX importers read ``state_dict()``.

Like the JAX ``VGG19BN``, and unlike torchvision's, the VGG has no
``AdaptiveAvgPool2d((7, 7))``: ``fc1`` takes ``512 * (h/32) * (w/32)``
inputs flattened CHW, sized from ``input_size`` (224 by default).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imagetransformations_tpu_torch.core.image import entry_device
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.models._layers import BatchNorm, dropout, init_like_flax
from imagetransformations_tpu_torch.models.resnet import normalize, to_unit

#: torchvision ImageNet normalization
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_imagenet(x01: torch.Tensor) -> torch.Tensor:
    """[0,1] NHWC -> normalized (torchvision Normalize parity)."""
    return normalize(x01, IMAGENET_MEAN, IMAGENET_STD)


def imagenet_model_space(u8_nhwc: torch.Tensor) -> torch.Tensor:
    """u8 NHWC batch -> the ImageNet nets' normalized f32 NCHW input (the
    channels-last strides kept)."""
    return normalize_imagenet(to_unit(u8_nhwc)).permute(0, 3, 1, 2)


def _downsample(cin: int, cout: int, stride: int, device) -> nn.ModuleList:
    return nn.ModuleList([nn.Conv2d(cin, cout, 1, stride, bias=False, device=device),
                          BatchNorm(cout, device)])


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False, device=device)
        self.bn1 = BatchNorm(planes, device)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False, device=device)
        self.bn2 = BatchNorm(planes, device)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False, device=device)
        self.bn3 = BatchNorm(planes * 4, device)
        self.downsample = _downsample(cin, planes * 4, stride, device) if downsample else None

    def forward(self, x, train: bool = False):
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = torch.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        if self.downsample is not None:
            conv, bn = self.downsample
            x = bn(conv(x), train)
        return torch.relu(y + x)


class BasicBlock(nn.Module):
    """torchvision BasicBlock (resnet18/34)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False, device=device)
        self.bn1 = BatchNorm(planes, device)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False, device=device)
        self.bn2 = BatchNorm(planes, device)
        self.downsample = _downsample(cin, planes, stride, device) if downsample else None

    def forward(self, x, train: bool = False):
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        if self.downsample is not None:
            conv, bn = self.downsample
            x = bn(conv(x), train)
        return torch.relu(y + x)


class _ResNet(nn.Module):
    """torchvision's stem (7x7/2 conv, 3x3/2 max pool) and four stages."""

    def __init__(self, block, stage_sizes: Sequence[int], num_classes: int, device):
        super().__init__()
        dev = entry_device(device, type(self).__name__)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, device=dev)
        self.bn1 = BatchNorm(64, dev)
        cin = 64
        for stage, n in enumerate(stage_sizes):
            planes = 64 * 2**stage
            blocks = []
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                down = b == 0 and (stride != 1 or cin != planes * block.expansion)
                blocks.append(block(cin, planes, stride, down, dev))
                cin = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.ModuleList(blocks))
        self.fc = nn.Linear(cin, num_classes, device=dev)
        init_like_flax(self)

    def backbone(self, x, train: bool = False):
        with full_f32():
            x = torch.relu(self.bn1(self.conv1(x), train))
            x = F.max_pool2d(x, 3, 2, 1)
            for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
                for block in stage:
                    x = block(x, train)
            return x.mean(dim=(2, 3))  # [N, 2048] (ResNet-50) or [N, 512]

    def forward(self, x, train: bool = False):
        feats = self.backbone(x, train)
        with full_f32():
            return self.fc(feats)

    def features(self, x, train: bool = False):
        return self.backbone(x, train)


class ResNet50(_ResNet):
    def __init__(self, num_classes: int = 1000, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 device=None):
        super().__init__(Bottleneck, stage_sizes, num_classes, device)


class ResNet18(_ResNet):
    """torchvision resnet18 (the reference's from-scratch adversarial-training
    model, attacks/fgsm.py:55,222); stage 1 has no downsample."""

    def __init__(self, num_classes: int = 1000, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 device=None):
        super().__init__(BasicBlock, stage_sizes, num_classes, device)


_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


class VGG19BN(nn.Module):
    """``features`` holds torchvision's sequence (conv, BN, ReLU per width,
    a max pool per "M"), so its indices name the parameters as
    torchvision's do; ``classifier`` is 0 Linear, 1 ReLU, 2 Dropout, 3
    Linear, 4 ReLU, 5 Dropout, 6 Linear. Dropout (p 0.5) runs in training
    only and draws from ``generator``."""

    def __init__(self, num_classes: int = 1000, input_size: int = 224, device=None):
        super().__init__()
        dev = entry_device(device, "VGG19BN")
        layers, cin = [], 3
        for v in _VGG19_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1, device=dev), BatchNorm(v, dev),
                           nn.ReLU()]
                cin = v
        self.features = nn.ModuleList(layers)
        side = input_size // 32
        self.classifier = nn.ModuleList([
            nn.Linear(512 * side * side, 4096, device=dev), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(4096, 4096, device=dev), nn.ReLU(), nn.Dropout(0.5),
            nn.Linear(4096, num_classes, device=dev)])
        init_like_flax(self)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        with full_f32():
            for layer in self.features:
                x = layer(x, train) if isinstance(layer, BatchNorm) else layer(x)
            x = x.flatten(1)  # CHW order, as torch's
            fc1, _, _, fc2, _, _, fc3 = self.classifier
            for fc in (fc1, fc2):
                x = torch.relu(fc(x))
                if train:
                    x = dropout(x, 0.5, generator)
            return fc3(x)
