#!/usr/bin/env python3
"""The demo recipe's test accuracy in the JAX package and in the port, on
the CPU.

    JAX_PLATFORMS=cpu python3 tools/demo_accuracy.py

The ``sweep`` / ``report`` commands of both packages train a ResNet-20 by
the demo recipe (``utils.demo.get_model``: 3 epochs of Adam at batch 128
on 512 images) and evaluate it on 256 (``get_data``: CIFAR-10 under
``--data-root``, here the synthetic fallback). Prints one JSON line with
the test accuracy of the JAX recipe, of the port's (flax's initializers,
``models._layers.init_like_flax``) and of the port's with PyTorch's own
default initializers put back (``reset_parameters`` on every convolution
and dense layer, from the same seed), and the seconds each took. Runs in
about a minute.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from imagetransformations_tpu.evalx import harness as jh  # noqa: E402
from imagetransformations_tpu.utils import demo as jd  # noqa: E402
from imagetransformations_tpu_torch.evalx import harness as ph  # noqa: E402
from imagetransformations_tpu_torch.models.resnet import cifar_model_space, resnet20  # noqa: E402
from imagetransformations_tpu_torch.models.training import fit  # noqa: E402
from imagetransformations_tpu_torch.utils import demo as pd  # noqa: E402


def torch_default_init_accuracy(xtr, ytr, xte, yte, seed: int = 0) -> float:
    """The port's demo recipe from PyTorch's default initializers."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = resnet20(device="cpu")
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                m.reset_parameters()
    x, y = torch.from_numpy(xtr), torch.from_numpy(ytr)
    batches = [(cifar_model_space(x[i: i + 128]), y[i: i + 128]) for i in range(0, len(x), 128)]
    fit(model, batches, epochs=3)
    return ph.evaluate_batched(model, cifar_model_space, xte, yte, device="cpu")["accuracy"]


def main() -> None:
    out = {}
    xtr, ytr, xte, yte = jd.get_data("")
    t0 = time.perf_counter()
    fn, space, *_ = jd.get_model(xtr, ytr)
    out["jax"] = float(jh.evaluate_batched(fn, space, jnp.asarray(xte), jnp.asarray(yte))
                       ["accuracy"])
    out["jax_s"] = time.perf_counter() - t0
    pxtr, pytr, pxte, pyte = pd.get_data("")
    t0 = time.perf_counter()
    fn, space, _ = pd.get_model(pxtr, pytr, device="cpu")
    out["port_flax_init"] = float(ph.evaluate_batched(fn, space, pxte, pyte,
                                                      device="cpu")["accuracy"])
    out["port_flax_init_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["port_torch_init"] = float(torch_default_init_accuracy(pxtr, pytr, pxte, pyte))
    out["port_torch_init_s"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
