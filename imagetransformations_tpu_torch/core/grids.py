"""Discrete transform-parameter grids and batched sampling (PyTorch).

The reference samples each image's transform value from a discrete
``{min, max, step}`` grid per image (``transformation.py:95-105`` bounds,
``:122-139`` sampling). As in the JAX package's ``core/grids.py``, the grids
are data and one draw yields a ``[N]`` parameter vector. The draws come from
a ``torch.Generator``; they cannot reproduce ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamGrid:
    """Inclusive discrete grid {lo, lo+step, ..., hi} of transform parameters."""

    lo: float
    hi: float
    step: float

    def values_f64(self) -> np.ndarray:
        """The grid's values in f64, as the reference's Python floats."""
        n = int(round((self.hi - self.lo) / self.step)) + 1
        return np.round(self.lo + self.step * np.arange(n), 10)

    def values(self) -> np.ndarray:
        return self.values_f64().astype(np.float32)


#: The reference's transform-value bounds (transformation.py:95-105).
PARAM_GRIDS: dict[str, ParamGrid] = {
    "scale": ParamGrid(0.9, 1.4, 0.1),
    "rotation": ParamGrid(-22.5, 22.5, 2.5),
    "lighten_darken": ParamGrid(-0.05, 0.05, 0.01),
    "gaussian_noise": ParamGrid(0.0, 0.1, 0.01),
    "translation": ParamGrid(-50.0, 50.0, 5.0),
    "contrast": ParamGrid(0.0, 1.0, 0.1),
    "blur": ParamGrid(0.0, 5.0, 0.5),
    "shear": ParamGrid(0.0, 1.0, 0.1),
}


def sample_indices(generator: torch.Generator, name: str,
                   n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw ``n`` i.i.d. grid values for transform ``name`` -> (int64 [n]
    their indices into ``PARAM_GRIDS[name].values()``, f32 [n] the values),
    on the generator's device."""
    vals = torch.from_numpy(PARAM_GRIDS[name].values()).to(generator.device)
    idx = torch.randint(0, vals.shape[0], (n,), generator=generator, device=generator.device)
    return idx, vals[idx]


def sample_params(generator: torch.Generator, name: str, n: int) -> torch.Tensor:
    """Draw ``n`` i.i.d. grid values for transform ``name`` -> f32 [n] on the
    generator's device."""
    return sample_indices(generator, name, n)[1]


def sample_all(generator: torch.Generator, n: int) -> dict[str, torch.Tensor]:
    """One ``[n]`` parameter vector per transform type, drawn in the order
    of ``PARAM_GRIDS`` from ``generator``."""
    return {name: sample_params(generator, name, n) for name in PARAM_GRIDS}


def linspace_f32(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in f32 as XLA computes it: the
    fractions ``t = iota * f32(1 / (num - 1))`` (XLA turns the division by
    a constant into that product), ``start * (1 - t) + stop * t``, and
    ``stop`` itself as the last value. On the unit interval this is JAX's
    grid bit for bit (``torch.linspace`` differs: at 11 points its 0.9 is
    0.89999998, JAX's 0.90000004); elsewhere XLA may fold and contract the
    sum, and the values are within 1 ulp of JAX's."""
    if num < 2:
        return torch.full((num,), float(start), dtype=torch.float32, device=device)
    div = num - 1
    t = torch.arange(div, dtype=torch.float32, device=device) * (
        torch.tensor(1.0, dtype=torch.float32) / div).to(device)
    a = torch.tensor(start, dtype=torch.float32, device=device)
    b = torch.tensor(stop, dtype=torch.float32, device=device)
    return torch.cat([a * (1.0 - t) + b * t, b[None]])
