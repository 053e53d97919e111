"""The port's checkpoints (``utils.checkpoint``: ``torch.save`` /
``torch.load(weights_only=True)`` in the JAX package's ``step_<n>``
layout), mirroring tests/test_workflows.py:265: a round trip, the latest
step resumed, and a ``SwagState`` through ``dataclasses.asdict``."""

import dataclasses

import numpy as np
import pytest
import torch

from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.uq import swag
from imagetransformations_tpu_torch.utils.checkpoint import (
    latest_step,
    load_checkpoint,
    save_checkpoint,
)

from test_torch_models import _torch_threads  # noqa: F401


def test_round_trip_and_latest_step(tmp_path):
    ck = str(tmp_path / "ck")
    assert latest_step(ck) is None
    tree = {"a": torch.arange(4), "b": {"c": torch.ones((2, 2))}, "n": 3, "t": (1.5, "x")}
    first = save_checkpoint(ck, tree, step=1)
    save_checkpoint(ck, {"a": torch.arange(4) * 2, "b": {"c": torch.zeros((2, 2))}}, step=2)
    assert first == str(tmp_path / "ck" / "step_1")
    assert latest_step(ck) == 2
    restored = load_checkpoint(ck)  # latest = step 2
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(4) * 2)
    one = load_checkpoint(ck, step=1)
    assert torch.equal(one["b"]["c"], torch.ones((2, 2))) and one["n"] == 3
    assert one["t"] == (1.5, "x")
    bare = str(tmp_path / "bare.pt")
    save_checkpoint(bare, {"w": torch.full((3,), 2.0)})
    assert torch.equal(load_checkpoint(bare)["w"], torch.full((3,), 2.0))


def test_model_and_optimizer_state(tmp_path):
    model = pm.SimpleCNN(num_classes=4, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.zeros(2, 3, 32, 32), True).sum().backward()
    opt.step()
    save_checkpoint(str(tmp_path), {"model": model.state_dict(), "opt": opt.state_dict()},
                    step=7)
    back = load_checkpoint(str(tmp_path))
    other = pm.SimpleCNN(num_classes=4, device="cpu")
    other.load_state_dict(back["model"])
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    opt2 = torch.optim.SGD(other.parameters(), lr=0.1, momentum=0.9)
    opt2.load_state_dict(back["opt"])
    assert opt2.state_dict()["param_groups"] == opt.state_dict()["param_groups"]


def test_swag_state(tmp_path):
    params = {"w": torch.tensor([1.0, 2.0]), "b": torch.tensor([0.5])}
    st = swag.init(params, max_rank=3)
    swag.update(st, {"w": torch.tensor([1.5, 2.5]), "b": torch.tensor([0.0])})
    save_checkpoint(str(tmp_path / "swag"), dataclasses.asdict(st), step=0)
    back = swag.SwagState.from_dict(load_checkpoint(str(tmp_path / "swag")))
    assert back.n_models == 1 and back.max_rank == 3
    for field in ("mean", "sq_mean", "deviations"):
        for k, v in getattr(st, field).items():
            assert torch.equal(getattr(back, field)[k], v), (field, k)
    draws = swag.draw(st, torch.Generator().manual_seed(0))
    a, b = swag.sample(st, draws=draws), swag.sample(back, draws=draws)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_load_refuses_pickled_code(tmp_path):
    import pickle

    path = tmp_path / "evil"
    torch.save({"f": print}, path)  # a reference to code, not weights
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint(str(path))
