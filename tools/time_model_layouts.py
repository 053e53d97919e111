#!/usr/bin/env python3
"""Time the ResNets on one NVIDIA GPU under three input layouts, and count
cuDNN's layout transposes.

    python3 tools/time_model_layouts.py [--tree DIR] [--batch N]

Two passes, each in true f32 (the models' ``full_f32``), random weights:

- ``resnet50``: one ``models.imagenet.ResNet50`` forward at 224x224;
- ``resnet56``: one ``models.resnet.resnet56`` forward at 32x32, then ODIN's
  input gradient (``uq.odin._input_gradient``, T 1000) on the same batch.

Each under three inputs, all made by the model space from one u8 NHWC batch:

- ``a``: the model space's output as it is, an NCHW view of NHWC memory
  (channels-last strides);
- ``b``: the same values made NCHW-contiguous;
- ``c``: ``a``'s input with the model's parameters in ``torch.channels_last``.

A row a (pass, layout): ``ms`` one pass (CUDA events around 10 passes after 3
warm-up passes), ``device_ms`` the device time of one pass (the sum of its
kernels, torch.profiler over 3 passes), ``transpose_ms`` the part of it in
kernels whose names hold ``nhwcToNchw`` or ``nchwToNhwc``, ``convs`` the
convolution kernels (names holding ``conv``, ``xmma`` or ``implicit``) with
their device ms a pass, ``top`` the ten largest kernels, and ``max_gap`` the
largest |output - output of ``a``| over max(1, max |output of ``a``|).
One JSON line a row, the card's name and power limit first.

``--tree DIR`` imports the port's package from DIR instead (another
checkout, e.g. the parent commit unpacked with ``git archive``), for A/B
runs in turns within one call. Needs a CUDA device; exits 1 without one.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSPOSES = ("nhwcToNchw", "nchwToNhwc")
CONV_MARKS = ("conv", "xmma", "implicit")


def kernel_ms(torch, fn, reps: int) -> dict:
    """{kernel name: device ms a call} over ``reps`` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e6 / reps
    return out


def event_ms(torch, fn, reps: int) -> float:
    """Wall ms a call by CUDA events around ``reps`` calls."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def row(torch, name, layout, fn, ref):
    for _ in range(3):
        out = fn()
    torch.cuda.synchronize()
    by_kernel = kernel_ms(torch, fn, 3)
    gap = None
    if ref is not None:
        scale = max(1.0, float(ref.abs().max()))
        gap = float((out - ref).abs().max()) / scale
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    return out, {
        "pass": name, "layout": layout, "ms": event_ms(torch, fn, 10),
        "device_ms": sum(by_kernel.values()),
        "transpose_ms": sum(v for k, v in by_kernel.items() if any(t in k for t in TRANSPOSES)),
        "convs": {k[:110]: round(v, 4) for k, v in top
                  if any(c in k.lower() for c in CONV_MARKS)},
        "top": [[k[:90], round(v, 4)] for k, v in top[:10]],
        "max_gap": gap}


def passes(torch, batch: int):
    """(name, model on the card, u8 NHWC batch, model space, the pass on a model
    and an input)."""
    from imagetransformations_tpu_torch.models import imagenet, resnet
    from imagetransformations_tpu_torch.uq.odin import _input_gradient

    g = torch.Generator(device="cuda").manual_seed(0)

    def u8(side):
        return torch.randint(0, 256, (batch, side, side, 3), generator=g, device="cuda",
                             dtype=torch.uint8)

    def forward(model, x):
        with torch.no_grad():
            return model(x)

    def forward_and_odin(model, x):
        with torch.no_grad():
            logits = model(x)
        return torch.cat([logits.flatten(), _input_gradient(model, x, 1000.0).flatten()])

    torch.manual_seed(0)
    yield ("resnet50_forward", imagenet.ResNet50(device="cuda").eval(), u8(224),
           imagenet.imagenet_model_space, forward)
    yield ("resnet56_forward_odin", resnet.resnet56(device="cuda").eval(), u8(32),
           resnet.cifar_model_space, forward_and_odin)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None, help="import the port's package from this tree")
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_model_layouts: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import imagetransformations_tpu_torch as pkg

    print(json.dumps({"card": cs.nvidia_smi(), "package": os.path.dirname(pkg.__file__),
                      "torch": torch.__version__, "cudnn": torch.backends.cudnn.version()}),
          flush=True)
    for name, model, u8, space, run in passes(torch, args.batch):
        x = space(u8)
        cl_model = copy.deepcopy(model).to(memory_format=torch.channels_last)
        cases = [("a", model, x), ("b", model, x.contiguous()), ("c", cl_model, x)]
        ref = None
        for layout, m, xi in cases:
            out, r = row(torch, name, layout, lambda m=m, xi=xi: run(m, xi), ref)
            ref = out if ref is None else ref
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
