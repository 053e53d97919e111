"""True f32 arithmetic for the models' convolutions and matrix products.

PyTorch runs f32 cuDNN convolutions in TF32 (10 mantissa bits) by default
(``torch.backends.cudnn.allow_tf32 = True``), and a caller may switch TF32
on for cuBLAS matrix products too. The JAX package computes its models in
f32 (and ``Precision.HIGHEST`` where the TPU's default would truncate), so
every model forward, the Mahalanobis quadratic form and the evaluation
harness run inside :func:`full_f32`: TF32 off for the scope of the call,
the caller's settings back on leaving it. Library code never changes the
flags for good.

The flags are PyTorch's legacy ``allow_tf32`` pair, the API the rest of
the repository sets. Do not also set TF32 through the newer
``fp32_precision`` settings in the same process: PyTorch 2.13 raises on
reading the legacy flags after that (2.11 does not).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch


@contextlib.contextmanager
def full_f32():
    """Scope in which cuDNN convolutions and cuBLAS f32 matrix products run
    in true f32 (no TF32); restores the caller's two flags on leaving."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = False
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def input_gradient(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
    """d loss_fn(x) / d x for a scalar loss: one ``torch.autograd.grad`` on a
    leaf copy of ``x``, in gradient mode whatever the caller's, forward and
    backward inside :func:`full_f32` (cuDNN's convolution backward reads the
    TF32 flag when it runs, not when the forward built the graph)."""
    leaf = x.detach().requires_grad_(True)
    with full_f32(), torch.enable_grad():
        (g,) = torch.autograd.grad(loss_fn(leaf), leaf)
    return g
