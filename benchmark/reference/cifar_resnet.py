"""ResNet for CIFAR-10 in plain PyTorch (He et al. 2016, arXiv:1512.03385
section 4.2): a 3x3 stem of 16, three stages of n BasicBlocks at widths
16 / 32 / 64 (the first block of stages 2 and 3 at stride 2, with a 1x1
convolution and BatchNorm as its shortcut, as chenyaofo's
pytorch-cifar-models), global average pooling and a dense layer; 6n + 2
layers. Parameter names are chenyaofo's, which the port also uses, so one
state dict loads into both. BatchNorm in evaluation mode (running
statistics, eps 1e-5)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class Block(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.ModuleList([nn.Conv2d(cin, planes, 1, stride, bias=False),
                                             _bn(planes)])

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample[1](self.downsample[0](x))
        return F.relu(y + x)


class CifarResNet(nn.Module):
    def __init__(self, blocks_per_stage: int, num_classes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 16, 3, 1, 1, bias=False)
        self.bn1 = _bn(16)
        cin = 16
        for s, planes in enumerate((16, 32, 64)):
            blocks = []
            for b in range(blocks_per_stage):
                blocks.append(Block(cin, planes, 2 if (s > 0 and b == 0) else 1))
                cin = planes
            setattr(self, f"layer{s + 1}", nn.ModuleList(blocks))
        self.fc = nn.Linear(64, num_classes)

    def features_and_logits(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        for stage in (self.layer1, self.layer2, self.layer3):
            for block in stage:
                x = block(x)
        feats = x.mean(dim=(2, 3))
        return feats, self.fc(feats)

    def forward(self, x):
        return self.features_and_logits(x)[1]


def build(config: dict) -> nn.Module:
    """The configuration's network (``depth`` = 6n + 2), in evaluation mode."""
    n = (int(config["depth"]) - 2) // 6
    return CifarResNet(n, int(config["num_classes"])).eval()
