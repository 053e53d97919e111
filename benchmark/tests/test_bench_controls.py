"""The control of each cell's ``correct``: the reference in the port's place,
computed one precision step below the configuration's, fails the cell's
comparison. bfloat16 for the transforms' f32 runs on the CPU; TF32 for the
models exists only on the card."""

import time

import pytest

import controls
from harness import cell

SEED = 2**31 + 4099


def _control(name: str, images: int, device: str, done: int):
    r = cell.make_run(name, SEED, 0.0, False, time.perf_counter(), device=device, images=images)
    return controls.control(r, done)


@pytest.mark.parametrize("name,images", [("cifar10-resnet56.augment", 32),
                                         ("imagenet-resnet50.chain", 4)])
def test_bfloat16_transforms_are_not_correct(name, images):
    checks = _control(name, images, "cpu", done=6)
    assert not checks.correct
    assert checks.rows["max_lsb"]["value"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name,images", [("cifar10-resnet56.c10c", 512),
                                         ("imagenet-resnet50.inc", 64)])
def test_tf32_models_are_not_correct(cuda, name, images):
    checks = _control(name, images, "cuda", done=15)
    assert not checks.correct
