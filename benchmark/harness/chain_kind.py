"""Traffic kind ``chain``: blur -> rotation -> grayscale as on-device
augmentation, through the port's ``pipeline.chain.build_chain_fn(ops)``
over the set in calls of ``images_per_call``, cycled. ``ops`` lists the
chain as ``{"name", "params"}`` (a ``blur`` with its ``radius``, a
``rotation`` with its ``angle``, a ``grayscale``). The window, the sample
and the comparison are ``transform_window``'s."""

from __future__ import annotations

import torch

from harness import transform_window
from harness.roofline import chain_work
from reference import transforms as rt


class Entry(transform_window.Calls):
    def __init__(self, r, x: torch.Tensor):
        super().__init__(r, x)
        from imagetransformations_tpu_torch.pipeline.chain import OpSpec, build_chain_fn

        self.ops = {o["name"]: o.get("params", {}) for o in self.tr["ops"]}
        fn = build_chain_fn([OpSpec(o["name"], o.get("params", {})) for o in self.tr["ops"]],
                            device=r.device)
        self.port = lambda xb, g: fn(xb)

    def outputs(self, out) -> dict:
        return {"chain": out}

    def work(self, i: int, drawn) -> tuple[float, float]:
        return chain_work(tuple(self.batch(i).shape), float(self.ops["blur"]["radius"]))

    def reference(self, picked: list, dtype=torch.float32) -> dict:
        radius, angle = float(self.ops["blur"]["radius"]), float(self.ops["rotation"]["angle"])
        return {i: {"chain": rt.blur_rotate_gray(self.batch(i), radius, angle, dtype)}
                for i in picked}


def run(r) -> dict:
    return transform_window.run(r, Entry)


def control(r, done: int):
    return transform_window.control(r, Entry, done)
