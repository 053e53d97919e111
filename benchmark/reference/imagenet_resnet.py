"""ResNet-50 in plain PyTorch (He et al. 2016, arXiv:1512.03385, Table 1;
torchvision's ``resnet50``): a 7x7/2 stem of 64 and a 3x3/2 max pool, then
bottleneck stages of 3 / 4 / 6 / 3 blocks at widths 64-512 (x4 out), the
stride on the 3x3 convolution, a 1x1 convolution and BatchNorm as the
first block's shortcut, global average pooling and a dense layer.
Parameter names are torchvision's, which the port also uses. BatchNorm in
evaluation mode (running statistics, eps 1e-5)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, down: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = None
        if down:
            self.downsample = nn.ModuleList([nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
                                             _bn(planes * 4)])

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample[1](self.downsample[0](x))
        return F.relu(y + x)


class ResNet(nn.Module):
    def __init__(self, stages, num_classes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        cin = 64
        for s, nblocks in enumerate(stages):
            planes = 64 * 2 ** s
            blocks = []
            for b in range(nblocks):
                stride = 2 if (s > 0 and b == 0) else 1
                blocks.append(Bottleneck(cin, planes, stride, b == 0))
                cin = planes * 4
            setattr(self, f"layer{s + 1}", nn.ModuleList(blocks))
        self.fc = nn.Linear(cin, num_classes)

    def features_and_logits(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x)
        feats = x.mean(dim=(2, 3))
        return feats, self.fc(feats)

    def forward(self, x):
        return self.features_and_logits(x)[1]


def build(config: dict) -> nn.Module:
    """The configuration's network (``stages`` blocks a stage), in evaluation mode."""
    return ResNet(tuple(config["stages"]), int(config["num_classes"])).eval()
