"""Traffic kind ``apply_all``: the reference's 8-type sweep
(transformation.py:92-170) as on-device augmentation, through the port's
``pipeline.batch.apply_all_transformations(x, g)`` at its default flags,
one call a pass over ``images_per_call`` images; ``g`` a generator on the
device seeded from ``--seed``, every call drawing anew. The window, the
sample and the comparison are ``transform_window``'s; the reference
replays the calls' draws from the seed."""

from __future__ import annotations

import torch

from harness import inputs, transform_window
from harness.roofline import apply_all_work
from reference import transforms as rt


class Entry(transform_window.Calls):
    def __init__(self, r, x: torch.Tensor):
        super().__init__(r, x)
        from imagetransformations_tpu_torch.pipeline.batch import apply_all_transformations

        self.port = lambda xb, g: apply_all_transformations(xb, g, device=r.device)

    def outputs(self, out) -> dict:
        return {t: v[1] for t, v in out.items()}

    def drawn(self, out) -> dict:
        return {t: v[0] for t, v in out.items()}

    def work(self, i: int, drawn) -> tuple[float, float]:
        return apply_all_work(tuple(self.batch(i).shape),
                              {t: v.cpu().numpy() for t, v in drawn.items()})

    def reference(self, picked: list, dtype=torch.float32) -> dict:
        out = {}
        g = inputs.generator(self.r.seed, self.r.device, "calls")
        for i in range(max(picked) + 1):
            d = rt.sweep_draws(g, tuple(self.batch(i).shape))
            if i in picked:
                out[i] = rt.apply_all(self.batch(i), d, dtype)
        return out


def run(r) -> dict:
    return transform_window.run(r, Entry)


def control(r, done: int):
    return transform_window.control(r, Entry, done)
