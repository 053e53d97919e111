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

    def values(self) -> np.ndarray:
        n = int(round((self.hi - self.lo) / self.step)) + 1
        return np.round(self.lo + self.step * np.arange(n), 10).astype(np.float32)


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
