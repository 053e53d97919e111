"""Carry the JAX package's flax variables into the port's modules.

``from_flax(model, variables)`` loads a flax ``{"params", "batch_stats"}``
tree (numpy arrays, or anything ``np.asarray`` reads) into a port module.
One name map (``_entries``, which also holds each entry's inverse) serves
every architecture of ``models``:

- torch keys ``a.b.conv1.weight`` <-> flax paths ``("a_b", "conv1",
  "kernel")`` for the ResNets (``layer{s}.{b}`` -> ``layer{s}_{b}``,
  ``downsample.0`` / ``.1`` -> ``downsample_conv`` / ``downsample_bn``),
  the VGG's ``features.N`` -> ``conv{i}`` / ``bn{i}`` in order and
  ``classifier.{0,3,6}`` -> ``fc1..3``, and the names as they are for the
  rest;
- convolution kernels OIHW <-> HWIO, dense kernels [out, in] <-> [in, out]
  (also the Bayesian ``mu`` / ``rho``), BatchNorm ``weight`` / ``bias`` /
  ``running_mean`` / ``running_var`` <-> ``scale`` / ``bias`` / ``mean`` /
  ``var`` (``num_batches_tracked`` has no flax counterpart and stays);
- ``SimpleCNN.fc1`` and ``BayesianCNN.fc1`` (``mu`` and ``rho``): the port
  flattens CHW, JAX HWC, so their input rows are permuted.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from imagetransformations_tpu_torch.models._layers import BatchNorm
from imagetransformations_tpu_torch.models.bayesian import _Bayesian

_BN_FIELDS = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _module_path(model: nn.Module, parts: list[str]) -> tuple[str, ...]:
    """The flax module path of the torch submodule ``parts``."""
    if parts[0] == "features":  # VGG: conv{i} / bn{i} by order of kind
        kind = type(model.features[int(parts[1])])
        before = [m for m in model.features[: int(parts[1])] if type(m) is kind]
        return (f"{'bn' if kind is BatchNorm else 'conv'}{len(before)}",)
    if parts[0] == "classifier":
        return ({"0": "fc1", "3": "fc2", "6": "fc3"}[parts[1]],)
    if parts[0].startswith("layer") and len(parts) > 1:
        name = (f"{parts[0]}_{parts[1]}",)
        rest = parts[2:]
        if rest[:1] == ["downsample"]:
            return name + ({"0": "downsample_conv", "1": "downsample_bn"}[rest[1]],)
        return name + tuple(rest)
    return tuple(parts)


def _entries(model: nn.Module):
    """(torch key, flax collection, flax path, torch -> flax fn, flax -> torch
    fn) for each parameter and BN statistic of ``model``."""
    state = model.state_dict()
    for key, value in state.items():
        *mod, field = key.split(".")
        module = model.get_submodule(".".join(mod))
        path = _module_path(model, mod)
        if isinstance(module, BatchNorm):
            if field == "num_batches_tracked":
                continue
            coll, leaf = _BN_FIELDS[field]
            yield key, coll, path + (leaf,), _same, _same
            continue
        leaf = field if isinstance(module, _Bayesian) else {"weight": "kernel"}.get(field, field)
        if value.ndim == 4:
            yield key, "params", path + (leaf,), _oihw_to_hwio, _hwio_to_oihw
        elif value.ndim == 2:
            chw = getattr(model, "FLATTEN_CHW", None) if mod == ["fc1"] else None
            if chw is None:
                yield key, "params", path + (leaf,), _transpose, _transpose
            else:
                yield (key, "params", path + (leaf,), lambda v, c=chw: _chw_to_hwc_rows(v, c),
                       lambda v, c=chw: _hwc_to_chw_rows(v, c))
        else:
            yield key, "params", path + (leaf,), _same, _same


def _same(v):
    return v


def _transpose(v):
    return v.T


def _oihw_to_hwio(v):
    return v.transpose(2, 3, 1, 0)


def _hwio_to_oihw(v):
    return v.transpose(3, 2, 0, 1)


def _chw_to_hwc_rows(w, chw):
    """torch [out, c*h*w] -> flax kernel [h*w*c, out]."""
    c, h, wd = chw
    return w.reshape(-1, c, h, wd).transpose(2, 3, 1, 0).reshape(h * wd * c, -1)


def _hwc_to_chw_rows(k, chw):
    """flax kernel [h*w*c, out] -> torch [out, c*h*w]."""
    c, h, wd = chw
    return k.reshape(h, wd, c, -1).transpose(3, 2, 0, 1).reshape(-1, c * h * wd)


def _get(tree: dict, path):
    for p in path:
        tree = tree[p]
    return tree


def from_flax(model: nn.Module, variables: dict) -> nn.Module:
    """Load the flax ``{"params", "batch_stats"}`` tree into ``model`` (on
    its device); returns ``model``. Raises ``KeyError`` naming a missing
    flax path and ``ValueError`` on a shape mismatch."""
    state = model.state_dict()
    new = {}
    for key, coll, path, _, to_torch in _entries(model):
        value = np.array(to_torch(np.asarray(_get(variables[coll], path))), np.float32)
        if tuple(value.shape) != tuple(state[key].shape):
            raise ValueError(f"{key}: flax {'/'.join(path)} gives shape {value.shape}, "
                             f"the module has {tuple(state[key].shape)}")
        new[key] = torch.from_numpy(value)
    model.load_state_dict(new, strict=False)
    return model


def load_torch_state_dict(model: nn.Module, state: dict) -> nn.Module:
    """Load a torch state_dict (tensors or numpy arrays) by key: the port's
    names are the reference checkpoints' (chenyaofo's CIFAR ResNets,
    torchvision's ResNets and VGG), so the JAX importers' renaming is the
    identity here. Returns ``model``."""
    model.load_state_dict({k: torch.as_tensor(v) if isinstance(v, torch.Tensor)
                           else torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model
