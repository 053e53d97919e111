"""One cell of the corruption sweep in plain PyTorch (the reference's
FINAL_cifar_corrupted.py: corrupt the clean set, classify it, score each
image, and the accuracy and the error-detection AUROC of each score).

The corruption table is a frozen copy of the port's
``evalx/harness.CORRUPTIONS`` (the 15 canonical CIFAR-10-C corruptions,
their severity values, and each generator's explicit-draw keywords); the
generators are ``corruptions.py``'s frozen copies."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import corruptions as cr
from . import noise as nz
from . import uq


def _elastic(x, v, **d):
    h, w = int(x.shape[-3]), int(x.shape[-2])
    a, s, aa = cr.elastic_affine_pixels(h, w, *v)
    return cr.elastic_transform_affine(x, a, s, aa, **d)


#: corruption name -> (fn(images_u8, severity value, **draws), 5 severity values)
CORRUPTIONS = {
    "gaussian_noise": (lambda x, v, **d: nz.gaussian_noise_01(x, v, **d), cr.GAUSSIAN_NOISE_SEV),
    "shot_noise": (lambda x, v, **d: nz.shot_noise(x, v, **d), cr.SHOT_NOISE_SEV),
    "impulse_noise": (lambda x, v, **d: nz.impulse_noise(x, v, **d), cr.IMPULSE_NOISE_SEV),
    "defocus_blur": (lambda x, v, **d: cr.defocus_blur_disk(x, *v), cr.DEFOCUS_SEV),
    "glass_blur": (lambda x, v, **d: cr.glass_blur(x, *v, **d), cr.GLASS_BLUR_SEV),
    "motion_blur": (lambda x, v, **d: cr.motion_blur_directional(x, int(v[0]), float(v[1]), **d),
                    cr.MOTION_SEV),
    "zoom_blur": (lambda x, v, **d: cr.zoom_blur(x, float(v)), cr.ZOOM_BLUR_SEV),
    "snow": (lambda x, v, **d: cr.snow(x, *v, **d), cr.SNOW_SEV),
    "frost": (lambda x, v, **d: cr.frost(x, *v, **d), cr.FROST_SEV),
    "fog": (lambda x, v, **d: cr.fog(x, *v, **d), cr.FOG_SEV),
    "brightness": (lambda x, v, **d: cr.brightness_hsv(x, float(v)), cr.BRIGHTNESS_SEV),
    "contrast": (lambda x, v, **d: cr.contrast_meanpreserve(x, float(v)), cr.CONTRAST_SEV),
    "elastic_transform": (_elastic, cr.ELASTIC_AFFINE_SEV),
    "pixelate": (lambda x, v, **d: cr.pixelate(x, float(v)), cr.PIXELATE_SEV),
    "jpeg_compression": (lambda x, v, **d: cr.jpeg_compression(x, int(v)), cr.JPEG_SEV),
}


def corrupt(images_u8: torch.Tensor, name: str, severity: int, draws: dict) -> torch.Tensor:
    fn, sevs = CORRUPTIONS[name]
    return fn(images_u8, sevs[severity - 1], **draws)


def severity_value(name: str, severity: int):
    return CORRUPTIONS[name][1][severity - 1]


MODEL_SPACES = {
    # torchvision's Normalize statistics of CIFAR-10 and of ImageNet
    "cifar": ((0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)),
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}


def model_space(u8: torch.Tensor, space: str) -> torch.Tensor:
    """u8 NHWC -> normalized f32 NCHW (the NHWC strides kept): ``x / 255``
    and the division by the deviation as true divisions."""
    mean, std = (torch.tensor(np.asarray(v, np.float32), device=u8.device)
                 for v in MODEL_SPACES[space])
    x01 = u8.to(torch.float32) / torch.tensor(255.0, device=u8.device)
    return ((x01 - mean) / std).permute(0, 3, 1, 2)


@contextlib.contextmanager
def precision(tf32: bool):
    """cuDNN's and cuBLAS's TF32 flags for the scope: off for the reference
    (the configuration's true f32), on for the control."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def _batches(n: int, batch: int):
    for i in range(0, n, batch):
        yield i, min(i + batch, n)


def features_and_logits(model, u8: torch.Tensor, space: str, batch: int, tf32: bool = False):
    """(features [N, D], logits [N, K]) of a u8 set, batch by batch."""
    feats, logits = [], []
    with precision(tf32), torch.no_grad():
        for a, b in _batches(u8.shape[0], batch):
            f, lg = model.features_and_logits(model_space(u8[a:b], space))
            feats.append(f)
            logits.append(lg)
    return torch.cat(feats), torch.cat(logits)


def evaluate_cell(model, clean_u8, labels, name: str, severity: int, draws: dict, *,
                  space: str, batch: int, metrics, odin=None, maha=None, tf32: bool = False):
    """One sweep cell: ``{"accuracy", "auroc": {column: value}, "logits"}``.
    ``odin`` = (temperature, eps) adds the ODIN column, ``maha`` = (mean,
    precision) the Mahalanobis column (fitted by ``uq.mahalanobis_fit`` on
    the clean set's features)."""
    imgs = corrupt(clean_u8, name, severity, draws)
    feats, logits = features_and_logits(model, imgs, space, batch, tf32)
    cols = {}
    with precision(tf32):
        odin_u = None
        if odin is not None:
            odin_u = torch.cat([uq.odin_uncertainty(model, model_space(imgs[a:b], space), *odin)
                                for a, b in _batches(imgs.shape[0], batch)])
        with torch.no_grad():
            correct = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
            errors = 1.0 - correct
            for m in metrics:
                s = uq.METRICS[m](logits)
                cols[m] = uq.auroc(-s if m in uq.CONFIDENCE else s, errors)
            if odin_u is not None:
                cols["odin"] = uq.auroc(odin_u, errors)
            if maha is not None:
                cols["mahalanobis"] = uq.auroc(uq.mahalanobis_score(*maha, feats), errors)
    return {"accuracy": float(torch.mean(correct)), "auroc": cols, "logits": logits}
