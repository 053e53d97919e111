"""The benchmark's inputs, made on the device from ``--seed``: images,
labels, model weights and each sweep cell's corruption draws. The same seed
gives the same inputs, and both the port and the reference get them."""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F

from reference import corruptions as rcr
from reference import sweep as rsweep


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed of (``seed``, keys...): strings by their CRC-32, so it
    is the same in every process."""
    words = [int(seed)] + [zlib.crc32(k.encode()) if isinstance(k, str) else int(k) for k in keys]
    a, b = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(a) << 31) ^ int(b)


def generator(seed: int, device, *keys) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


def images(seed: int, n: int, size: int, device) -> torch.Tensor:
    """[n, size, size, 3] u8 NHWC: each image a smooth random field (an 8x8
    colour grid of its own, bilinearly upsampled) plus fine noise, so that
    images differ in colour, brightness and structure, as photographs do."""
    g = generator(seed, device, "images")
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    for a in range(0, n, 1024):  # blocks keep the f32 temporaries small
        b = min(n, a + 1024)
        base = torch.randn((b - a, 3, 8, 8), generator=g, device=device) * 48.0 + 128.0
        x = F.interpolate(base, size=(size, size), mode="bilinear", align_corners=False)
        x = x + torch.randn(x.shape, generator=g, device=device) * 16.0
        out[a:b] = x.clamp(0.0, 255.0).round().to(torch.uint8).permute(0, 2, 3, 1)
    return out


def weights(model: torch.nn.Module, seed: int, device) -> dict:
    """A state dict for ``model`` (the reference network, whose parameter
    names the port's network shares) from one standard-normal draw on the
    device, cut into the leaves: every convolution and dense kernel scaled
    to variance 1 / fan_in (LeCun normal, flax's default), the dense bias
    by 0.01, and the BatchNorm statistics and affine parameters near the
    identity, as a trained net's: scale 1 + 0.1 z, shift 0.1 z, mean 0.1 z,
    variance exp(0.2 z)."""
    sd = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    total = sum(v.numel() for v in sd.values())
    z = torch.randn(total, generator=generator(seed, device, "weights"), device=device)
    out, at = {}, 0
    for k, v in sd.items():
        zk = z[at: at + v.numel()].reshape(v.shape)
        at += v.numel()
        if v.ndim > 1:
            out[k] = zk / float(np.sqrt(v[0].numel()))
        elif k.endswith("running_var"):
            out[k] = torch.exp(0.2 * zk)
        elif k.endswith("weight"):  # a BatchNorm scale
            out[k] = 1.0 + 0.1 * zk
        elif k.startswith("fc."):
            out[k] = 0.01 * zk
        else:  # BatchNorm shift and running mean
            out[k] = 0.1 * zk
    return out


def standardize_head(weights: dict, feats: torch.Tensor, gain: float = 3.0) -> dict:
    """The dense head of ``weights`` made to read standardized features:
    ``W' = gain * W / sigma`` and ``b' = -W' mu`` with mu and sigma the
    features' mean and deviation over the clean set. A random backbone's
    pooled features share one large mean, so a random head would predict
    one class for every image; a trained head reads how an image departs
    from the others. ``gain`` sets the logits' spread (max probabilities
    between about 0.3 and 1, as a trained net's)."""
    mu, sigma = feats.mean(dim=0), feats.std(dim=0)
    sigma = torch.clamp(sigma, min=1e-2 * float(sigma.median()) + 1e-12)
    w = gain * weights["fc.weight"] / sigma
    return dict(weights, **{"fc.weight": w, "fc.bias": -(w @ mu)})


def labels(seed: int, logits: torch.Tensor, accuracy: float) -> torch.Tensor:
    """[n] int64: the network's prediction from the clean ``logits`` for a
    share ``accuracy`` of the images (the published clean accuracy of the
    trained network), another class, uniform, for the rest: so the clean
    set reads that accuracy and the corruptions lower it."""
    dev, k = logits.device, logits.shape[-1]
    pred = torch.argmax(logits, dim=-1)
    g = generator(seed, dev, "labels")
    keep = torch.rand(pred.shape, generator=g, device=dev) < accuracy
    other = (pred + torch.randint(1, k, pred.shape, generator=g, device=dev)) % k
    return torch.where(keep, pred, other)


def cell_draws(seed: int, cell: int, name: str, severity: int, x: torch.Tensor) -> dict:
    """The explicit draws of sweep cell ``cell`` (corruption ``name`` at
    ``severity``) over the u8 NHWC set ``x``, on its device: the keywords
    of the corruption's generator, in the shapes and distributions it draws
    them (the port's ``evalx.harness.numpy_draws``), from the cell's own
    generator. Empty for a deterministic corruption."""
    g = generator(seed, x.device, "cell", cell)
    n, h, w, c = x.shape
    dev = x.device
    v = rsweep.severity_value(name, severity)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    if name == "gaussian_noise":
        return {"noise": normal(n, h, w, c)}
    if name == "shot_noise":
        rate = x.to(torch.float32) / torch.tensor(255.0, device=dev) * float(v)
        return {"draw": torch.poisson(rate, generator=g)}
    if name == "impulse_noise":
        return {"u": uniform(0.0, 1.0, n, h, w)}
    if name == "glass_blur":
        _, d, iterations = v
        return {"offsets": torch.randint(-d, d, (iterations, n, h, w, 2), generator=g,
                                         device=dev, dtype=torch.int32)}
    if name == "motion_blur":
        return {"angles_deg": uniform(-45.0, 45.0, n)}
    if name == "snow":
        return {"g_noise": normal(n, h, w), "angles_deg": uniform(-135.0, -45.0, n)}
    if name == "frost":
        return {"u_seed": uniform(0.0, 1.0, n, h, w), "u_amp": uniform(0.0, 1.0, n, h, w),
                "g_noise": normal(n, h, w)}
    if name == "fog":
        size = rcr.fog_size(h, w)
        return {"draws": uniform(-1.0, 1.0, n, rcr.plasma_levels(size), size, size)}
    if name == "elastic_transform":
        alpha, _, aa = rcr.elastic_affine_pixels(h, w, *v)
        out = {"jitter": uniform(-aa, aa, n, 3, 2)}
        if alpha > 0:
            out["disp"] = uniform(-1.0, 1.0, n, h, w, 2)
        return out
    return {}


def sweep_cell(order: list[str], i: int) -> tuple[str, int]:
    """Cell ``i`` of the sweep's fixed order: corruption ``i mod k`` at
    severity ``((i mod k) + i div k) mod 5 + 1`` (k corruptions): the first
    k cells hold every corruption once, the first 5k every pair once."""
    k = len(order)
    return order[i % k], ((i % k) + i // k) % 5 + 1
