"""Shared smoke setup for the CLI's ``sweep`` / ``report``: a briefly
trained ResNet-20 and CIFAR-10 data with a synthetic fallback (PyTorch).

Counterpart of ``imagetransformations_tpu/utils/demo.py:15-52``: one home
for the demo recipe (512 / 256 images, 3 epochs of Adam at batch 128, the
CIFAR normalization) so the commands cannot drift apart.
"""

from __future__ import annotations

import torch

from imagetransformations_tpu_torch.core.image import entry_device, to_device


def get_data(
    data_root: str, n_train: int = 512, n_test: int = 256, verbose: bool = False
):
    """(xtr, ytr, xte, yte) numpy arrays from the CIFAR-10 pickles under
    ``data_root``, or deterministic synthetic data when they are absent."""
    from imagetransformations_tpu_torch.pipeline.datasets import load_cifar10, synthetic

    try:
        xtr, ytr = load_cifar10(data_root, train=True)
        xte, yte = load_cifar10(data_root, train=False)
        return xtr[:n_train], ytr[:n_train], xte[:n_test], yte[:n_test]
    except (FileNotFoundError, OSError):
        if verbose:
            print(f"no CIFAR-10 under {data_root!r}; using synthetic smoke data")
        xtr, ytr = synthetic(n_train, seed=0)
        xte, yte = synthetic(n_test, seed=1)
        return xtr, ytr, xte, yte


def get_model(xtr, ytr, epochs: int = 3, batch: int = 128, device=None, seed: int = 0):
    """Briefly train a ResNet-20 on (xtr, ytr) (u8 NHWC, labels); returns
    (model_fn, to_model_space, model) on ``device`` (None means "cuda",
    which raises without a GPU). The weights are initialized on the host
    from ``seed`` (the process's generators restored after), so every
    device starts from the same ones."""
    from imagetransformations_tpu_torch.models.resnet import cifar_model_space, resnet20
    from imagetransformations_tpu_torch.models.training import fit

    dev = entry_device(device, "get_model")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = resnet20(device="cpu")
    model = model.to(dev)
    x, y = to_device(xtr, dev), to_device(ytr, dev)
    batches = [(cifar_model_space(x[i: i + batch]), y[i: i + batch])
               for i in range(0, len(x), batch)]
    fit(model, batches, epochs=epochs)

    def model_fn(xm):
        return model(xm)

    return model_fn, cifar_model_space, model
