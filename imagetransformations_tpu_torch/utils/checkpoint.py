"""Checkpoint and resume over ``torch.save`` / ``torch.load`` (PyTorch).

Counterpart of ``imagetransformations_tpu/utils/checkpoint.py:14-49`` (the
reference only saves, fire and forget: angellic.py:232, cifar_swag.py:76-83,
model_wrapper.py:70-97). A tree is nested dicts, lists and tuples of
tensors and numbers (model ``state_dict()``s, optimizer states, a
``SwagState`` through ``dataclasses.asdict`` and back with
``SwagState.from_dict``); tensors are saved from the CPU, and loading
reads weights only (``weights_only=True``, no pickled code). With a step
the file is ``<path>/step_<n>``, and loading without one resumes the
latest step, as the JAX package's layout.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, tree: Any, step: int | None = None) -> str:
    """Save a tree; with ``step`` the file is <path>/step_<n>. Returns the
    absolute path written (an existing file is replaced)."""
    target = os.path.abspath(os.path.join(path, f"step_{step}") if step is not None else path)
    os.makedirs(os.path.dirname(target), exist_ok=True)
    torch.save(_to_cpu(tree), target)
    return target


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [
        int(d.split("_", 1)[1])
        for d in os.listdir(path)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
    ]
    return max(steps) if steps else None


def load_checkpoint(path: str, step: int | None = None) -> Any:
    """Load a tree (tensors on the CPU); without ``step`` resume the latest
    step, or the bare path if it holds no steps."""
    if step is None:
        s = latest_step(path)
        target = os.path.join(path, f"step_{s}") if s is not None else path
    else:
        target = os.path.join(path, f"step_{step}")
    return torch.load(os.path.abspath(target), map_location="cpu", weights_only=True)
