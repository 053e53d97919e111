"""Swin Transformer in plain PyTorch (Liu et al. 2021, arXiv:2103.14030,
Table 1 and Algorithm / Figure 2-4; torchvision's ``swin_b``): a 4x4/4
patch convolution and LayerNorm; stages of blocks

    x = x + W-MSA(LN(x))   or   x = x + SW-MSA(LN(x))   (odd blocks)
    x = x + MLP(LN(x))     (Linear C -> 4C, exact GELU, Linear 4C -> C)

where W-MSA is multi-head self-attention inside non-overlapping M x M
windows, softmax(Q K^T / sqrt(d) + B) V with B gathered from a learned
(2M - 1)² x heads table, and SW-MSA the same on the map cyclically
shifted by -floor(M/2) (``torch.roll``), with -100 added between tokens of
a window that came from different regions of the unshifted map (the
paper's 3 x 3 region slicing), the result rolled back. A map one window
wide is not shifted. Patch merging between stages: x[0::2, 0::2],
x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2] concatenated, LayerNorm(4C),
a bias-free Linear 4C -> 2C. Then LayerNorm, the mean over tokens and the
classifier. LayerNorm eps 1e-5; qkv and proj have biases.

Departures from torchvision's module, none of them in the arithmetic: the
classifier is ``fc`` (torchvision: ``head``), as the benchmark's weights
name every network's classifier; the relative-position index and the shift
masks are non-persistent buffers (torchvision keeps the index in the state
dict), so that the weights drawn for ``state_dict()`` hold parameters only;
an image's windows stay in its row of the batch ([B, windows, M², C];
torchvision folds them into the batch), so that the multiply-adds that
``roofline.macs_per_image`` counts from one image's forward hooks are the
whole image's. No stochastic depth or dropout (evaluation). The map must
be a whole number of windows at every stage (no padding)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def window_partition(x: torch.Tensor, m: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/m * W/m, m * m, C]."""
    b, h, w, c = x.shape
    x = x.view(b, h // m, m, w // m, m, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, m * m, c)


def window_reverse(windows: torch.Tensor, m: int, h: int, w: int) -> torch.Tensor:
    """[B, H/m * W/m, m * m, C] -> [B, H, W, C]."""
    b, c = windows.shape[0], windows.shape[-1]
    x = windows.view(b, h // m, w // m, m, m, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def relative_position_index(m: int) -> torch.Tensor:
    """[m², m²]: each pair's row of the bias table (the paper's B-hat)."""
    coords = torch.stack(torch.meshgrid(torch.arange(m), torch.arange(m), indexing="ij"))
    flat = torch.flatten(coords, 1)  # 2, m²
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += m - 1
    rel[:, :, 1] += m - 1
    rel[:, :, 0] *= 2 * m - 1
    return rel.sum(-1)


def shift_mask(h: int, w: int, m: int, s: int) -> torch.Tensor:
    """[windows, m², m²]: the paper's mask of the shifted map, its regions
    labelled by slicing rows and columns into [0, -m), [-m, -s), [-s, end)."""
    img = torch.zeros((h, w))
    count = 0
    for hs in (slice(0, -m), slice(-m, -s), slice(-s, None)):
        for ws in (slice(0, -m), slice(-m, -s), slice(-s, None)):
            img[hs, ws] = count
            count += 1
    ids = window_partition(img.view(1, h, w, 1), m)[0].squeeze(-1)  # windows, m²
    diff = ids.unsqueeze(1) - ids.unsqueeze(2)
    return diff.masked_fill(diff != 0, -100.0).masked_fill(diff == 0, 0.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, m: int):
        super().__init__()
        self.heads, self.m = heads, m
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * m - 1) ** 2, heads))
        self.register_buffer("relative_position_index", relative_position_index(m),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """x [B, windows, m², C]; mask [windows, m², m²] or None."""
        b, nw, n, c = x.shape
        d = c // self.heads
        qkv = self.qkv(x).reshape(b, nw, n, 3, self.heads, d).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B, windows, heads, m², d]
        q = q * d ** -0.5
        attn = q @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index.view(-1)]
        attn = attn + bias.view(n, n, -1).permute(2, 0, 1)
        if mask is not None:
            attn = attn + mask.unsqueeze(1)
        attn = F.softmax(attn, dim=-1)
        x = (attn @ v).transpose(2, 3).reshape(b, nw, n, c)
        return self.proj(x)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, m: int, shift: int, side: int, mlp_ratio: int):
        super().__init__()
        self.m, self.shift = m, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads, m)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = nn.Sequential(nn.Linear(dim, mlp_ratio * dim), nn.GELU(), nn.Dropout(0.0),
                                 nn.Linear(mlp_ratio * dim, dim))
        self.register_buffer("attn_mask", shift_mask(side, side, m, shift) if shift else None,
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        y = self.norm1(x)
        if self.shift:
            y = torch.roll(y, shifts=(-self.shift, -self.shift), dims=(1, 2))
        y = window_reverse(self.attn(window_partition(y, self.m), self.attn_mask), self.m, h, w)
        if self.shift:
            y = torch.roll(y, shifts=(self.shift, self.shift), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x[..., 0::2, 0::2, :]
        x1 = x[..., 1::2, 0::2, :]
        x2 = x[..., 0::2, 1::2, :]
        x3 = x[..., 1::2, 1::2, :]
        return self.reduction(self.norm(torch.cat([x0, x1, x2, x3], -1)))


class Permute(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 3, 1)


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim: int, depths, heads, m: int, patch: int, mlp_ratio: int,
                 num_classes: int, image_size: int):
        super().__init__()
        layers: list[nn.Module] = [nn.Sequential(nn.Conv2d(3, embed_dim, patch, patch),
                                                 Permute(), nn.LayerNorm(embed_dim, eps=1e-5))]
        dim, side = embed_dim, image_size // patch
        for s, (depth, nh) in enumerate(zip(depths, heads)):
            if s > 0:
                layers.append(PatchMerging(dim))
                dim, side = 2 * dim, side // 2
            shift = m // 2 if m < side else 0
            layers.append(nn.Sequential(*[SwinBlock(dim, nh, m, shift if b % 2 else 0, side,
                                                    mlp_ratio) for b in range(depth)]))
        self.features = nn.Sequential(*layers)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc = nn.Linear(dim, num_classes)

    def features_and_logits(self, x: torch.Tensor):
        x = self.norm(self.features(x))  # [N, H, W, C]
        feats = x.mean(dim=(1, 2))
        return feats, self.fc(feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features_and_logits(x)[1]


def build(config: dict) -> nn.Module:
    """The configuration's network (``embed_dim``, ``depths``, ``heads``,
    ``window``, ``patch``, ``mlp_ratio``, ``num_classes``, ``image_size``),
    in evaluation mode."""
    return SwinTransformer(int(config["embed_dim"]), tuple(config["depths"]),
                           tuple(config["heads"]), int(config["window"]), int(config["patch"]),
                           int(config["mlp_ratio"]), int(config["num_classes"]),
                           int(config["image_size"])).eval()
