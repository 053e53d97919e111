"""Swin Transformer (PyTorch): shifted-window attention, Swin-B at 224².

Liu et al. 2021, *Swin Transformer: Hierarchical Vision Transformer using
Shifted Windows* (arXiv:2103.14030), as torchvision's ``swin_b`` computes
it: a 4x4/4 patch convolution and LayerNorm, then four stages of
pre-LayerNorm blocks (windowed multi-head attention with a learned
relative-position bias, an exact-erf GELU MLP of ratio 4), patch merging
(2x2 concatenation, LayerNorm(4C), a bias-free 4C -> 2C linear) between
stages, a final LayerNorm and the mean over tokens. Odd blocks attend
within windows shifted by ``window // 2`` (a cyclic shift, with -100
between tokens the shift made neighbours); a stage whose map is one window
wide neither shifts nor masks (Swin-B's stage 4: global attention).

Parameter names are torchvision's (``features.0.0`` the patch convolution,
``features.0.2`` its LayerNorm, ``features.{1,3,5,7}.{b}.norm1 | attn.qkv |
attn.proj | attn.relative_position_bias_table | norm2 | mlp.0 | mlp.3``,
``features.{2,4,6}.norm | reduction``, ``norm``) except the classifier,
``fc`` where torchvision has ``head``: ``load_torch_state_dict`` maps a
torchvision state dict (``torchvision_key``). The relative-position index,
the token orders and the shift masks are non-persistent buffers built once
on the model's device, so ``state_dict()`` holds parameters only.

The tokens are kept as ``[N, H*W, C]``. Each attention half gathers its
tokens into window order with one ``index_select`` (the cyclic shift and
the window partition in one index, ``_window_order``) and scatters them
back with the inverse; the arithmetic is the paper's, in the same order.
Every product runs inside ``core.precision.full_f32`` (true f32, TF32 off);
the attention products are ``torch.matmul``. The forward makes no host read
and uploads nothing. Each block's attention half is span ``swin.attention``
(``utils.profiling``; ids ``stage``, ``block``, ``shifted``).

Stochastic depth and dropout are absent: ``train`` selects nothing.
Parameters start from torch's defaults, the bias tables from torchvision's
truncated normal (std 0.02).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from imagetransformations_tpu_torch.core.image import entry_device
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.utils import profiling

PATCH = 4
MLP_RATIO = 4
MASK_VALUE = -100.0
LN_EPS = 1e-5


def _window_order(side: int, window: int, shift: int, device) -> torch.Tensor:
    """int64 [side²]: the token (row-major index) at each place of the
    window-major order after a cyclic shift by -``shift`` on both axes:
    place (wh, ww, ih, iw) holds the shifted map's (wh*M + ih, ww*M + iw),
    which is the map's ((wh*M + ih + shift) mod side, ...)."""
    nw = side // window
    a = torch.arange(nw, device=device).view(nw, 1, 1, 1) * window
    i = torch.arange(window, device=device)
    rows = (a + i.view(1, 1, window, 1) + shift) % side  # [wh, 1, ih, 1]
    cols = (a.view(1, nw, 1, 1) + i.view(1, 1, 1, window) + shift) % side  # [1, ww, 1, iw]
    return (rows * side + cols).reshape(-1)


def _shift_mask(side: int, window: int, shift: int, device) -> torch.Tensor:
    """f32 [windows, M², M²]: -100 between two tokens of a window that lie
    in different regions of the shifted map, else 0. Along each axis the
    shifted map's places p fall in three regions, p < side - M,
    side - M <= p < side - shift, and the last ``shift``."""
    p = torch.arange(side, device=device)
    region = (p >= side - window).to(torch.int64) + (p >= side - shift).to(torch.int64)
    ids = (region.view(side, 1) * 3 + region.view(1, side)).reshape(-1)
    ids = ids[_window_order(side, window, 0, device)].view(-1, window * window)
    same = ids.unsqueeze(2) == ids.unsqueeze(1)
    return torch.where(same, 0.0, MASK_VALUE).to(torch.float32)


def _relative_index(window: int, device) -> torch.Tensor:
    """int64 [M², M²]: the row of the bias table for each pair of places
    (i, j) of a window: (dh + M - 1) * (2M - 1) + (dw + M - 1), d = i - j."""
    i = torch.arange(window * window, device=device)
    dh = (i // window).view(-1, 1) - (i // window).view(1, -1)
    dw = (i % window).view(-1, 1) - (i % window).view(1, -1)
    return (dh + window - 1) * (2 * window - 1) + (dw + window - 1)


class _Attention(nn.Module):
    """The parameters of one block's windowed attention (torchvision's
    ``ShiftedWindowAttention`` names) and its index."""

    def __init__(self, dim: int, heads: int, window: int, device):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(nn.init.trunc_normal_(
            torch.empty((2 * window - 1) ** 2, heads, device=device), std=0.02))
        self.register_buffer("relative_position_index", _relative_index(window, device),
                             persistent=False)

    def bias(self) -> torch.Tensor:
        """[heads, M², M²]: the table's rows gathered by the index."""
        n = self.relative_position_index.shape[0]
        b = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        return b.view(n, n, self.heads).permute(2, 0, 1).contiguous()


class _Block(nn.Module):
    """One pre-LayerNorm Swin block on tokens [N, side², C]."""

    def __init__(self, dim: int, heads: int, window: int, side: int, stage: int, index: int,
                 device):
        super().__init__()
        self.window = window
        self.shift = window // 2 if (index % 2 == 1 and window < side) else 0
        self.ids = {"stage": stage, "block": index, "shifted": int(self.shift > 0)}
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = _Attention(dim, heads, window, device)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp = nn.Sequential(nn.Linear(dim, MLP_RATIO * dim, device=device), nn.GELU(),
                                 nn.Identity(), nn.Linear(MLP_RATIO * dim, dim, device=device))
        order = _window_order(side, window, self.shift, device)
        whole = window == side  # one window: the order is the identity
        self.register_buffer("order", None if whole else order, persistent=False)
        self.register_buffer("inverse", None if whole else torch.argsort(order),
                             persistent=False)
        self.register_buffer("mask", _shift_mask(side, window, self.shift, device)
                             if self.shift else None, persistent=False)

    def attention(self, y: torch.Tensor) -> torch.Tensor:
        """Windowed attention of normalized tokens [N, L, C]; returns the
        projected result in token order."""
        n, length, c = y.shape
        m2, heads = self.window * self.window, self.attn.heads
        if self.order is not None:
            y = y.index_select(1, self.order)  # shift and partition
        windows = n * length // m2
        qkv = self.attn.qkv(y.reshape(windows, m2, c))
        qkv = qkv.reshape(windows, m2, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * (c // heads) ** -0.5
        a = q.matmul(k.transpose(-2, -1))
        a = a + self.attn.bias()
        if self.mask is not None:
            nw = self.mask.shape[0]
            a = (a.view(n, nw, heads, m2, m2) + self.mask[None, :, None]).view(-1, heads, m2, m2)
        a = torch.softmax(a, dim=-1)
        out = a.matmul(v).transpose(1, 2).reshape(windows, m2, c)
        out = self.attn.proj(out).reshape(n, length, c)
        if self.inverse is not None:
            out = out.index_select(1, self.inverse)  # reverse and shift back
        return out

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        with profiling.span("swin.attention", **self.ids):
            t = t + self.attention(self.norm1(t))
        return t + self.mlp(self.norm2(t))


class _PatchMerging(nn.Module):
    """2x2 neighbours concatenated as [x(0,0), x(1,0), x(0,1), x(1,1)]
    (row, column parity), LayerNorm(4C), a bias-free 4C -> 2C linear."""

    def __init__(self, dim: int, side: int, device):
        super().__init__()
        self.side = side
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS, device=device)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, device=device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        n, _, c = t.shape
        h = self.side // 2
        t = t.view(n, h, 2, h, 2, c).permute(0, 1, 3, 4, 2, 5).reshape(n, h * h, 4 * c)
        return self.reduction(self.norm(t))


class SwinTransformer(nn.Module):
    """Swin Transformer on square ``image_size`` inputs (model space, NCHW;
    the channels-last strides of ``imagenet_model_space`` give the tokens
    without a copy). ``depths`` and ``heads`` a stage; every stage's map
    must be a whole number of ``window``-wide windows. ``device``: None
    means "cuda" (raises without a GPU), or "cpu"."""

    def __init__(self, embed_dim: int, depths: Sequence[int], heads: Sequence[int],
                 window: int, num_classes: int, device=None, image_size: int = 224):
        super().__init__()
        dev = entry_device(device, type(self).__name__)
        self.image_size = image_size
        side = image_size // PATCH
        layers: list[nn.Module] = [nn.ModuleDict({
            "0": nn.Conv2d(3, embed_dim, PATCH, PATCH, device=dev),
            "2": nn.LayerNorm(embed_dim, eps=LN_EPS, device=dev)})]
        dim = embed_dim
        for s, (depth, nh) in enumerate(zip(depths, heads)):
            if s > 0:
                layers.append(_PatchMerging(dim, side, dev))
                dim, side = 2 * dim, side // 2
            if image_size % PATCH or side % window or (s + 1 < len(depths) and side % 2):
                raise ValueError(f"stage {s + 1}'s {side}x{side} map is not a whole number "
                                 f"of {window}x{window} windows, or cannot be merged")
            layers.append(nn.ModuleList([_Block(dim, nh, window, side, s + 1, b, dev)
                                         for b in range(depth)]))
        # Torchvision names the layers ``features.*``, and ``features(x)`` is
        # the pooled-feature method the sweep's models have (the ResNets'
        # too; the Mahalanobis fit calls it). The method wins attribute
        # lookup, so the list is reached as ``self._modules["features"]``;
        # ``model.features[i]`` is not a layer here.
        self.features = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=dev)
        self.fc = nn.Linear(dim, num_classes, device=dev)

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Model-space images [N, 3, H, W] -> final normalized tokens [N, L, C]."""
        if tuple(x.shape[-2:]) != (self.image_size, self.image_size):
            raise ValueError(f"built for {self.image_size}x{self.image_size} inputs, "
                             f"got {tuple(x.shape[-2:])}")
        layers = self._modules["features"]
        embed = layers[0]
        t = embed["0"](x)
        n, c, h, w = t.shape
        t = embed["2"](t.permute(0, 2, 3, 1).reshape(n, h * w, c))
        for layer in list(layers)[1:]:
            if isinstance(layer, _PatchMerging):
                t = layer(t)
            else:
                for block in layer:
                    t = block(t)
        return self.norm(t)

    def features(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Pooled features [N, 8C]: the final LayerNorm, then the mean over tokens."""
        del train
        with full_f32():
            return self._tokens(x).mean(dim=1)

    def features_and_logits(self, x: torch.Tensor, train: bool = False):
        feats = self.features(x, train)
        with full_f32():
            return feats, self.fc(feats)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.features_and_logits(x, train)[1]

    @staticmethod
    def torchvision_key(key: str) -> str | None:
        """The port's name of a torchvision ``swin_*`` state-dict key; None
        for the relative-position index (a buffer the port builds)."""
        if key.endswith("relative_position_index"):
            return None
        return "fc." + key[len("head."):] if key.startswith("head.") else key


class SwinB(SwinTransformer):
    """Swin-B at 224² (Table 1): C 128, depths 2 / 2 / 18 / 2, heads
    4 / 8 / 16 / 32 (width 32 each), window 7; 87 768 224 parameters at
    1 000 classes."""

    def __init__(self, num_classes: int = 1000, device=None):
        super().__init__(128, (2, 2, 18, 2), (4, 8, 16, 32), 7, num_classes, device)
