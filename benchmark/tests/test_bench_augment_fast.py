"""The ``cifar10-resnet56.augment-fast`` cell: ``reference/transforms_fast.py``
equals the port's plain versions byte for byte, a CPU run of the cell is
correct, its bfloat16 control is not, and its work is counted for the
fast flags."""

import time

import numpy as np
import pytest
import torch

from harness import apply_all_fast_kind, cell, inputs
from reference import transforms as rt
from reference import transforms_fast as rtf

import controls

SEED = 2**31 + 2453
CELL = "cifar10-resnet56.augment-fast"


@pytest.mark.parametrize("size", [(32, 32), (37, 53)])
def test_the_three_fast_types_equal_the_ports_plain_versions(size):
    from imagetransformations_tpu_torch.ops.hopper.resample import zoom_bilinear_plain
    from imagetransformations_tpu_torch.ops.hopper.rotate_gather import (
        pil_rotate_coeffs, pil_rotate_nearest_plain)
    from imagetransformations_tpu_torch.pipeline import batch

    h, w = size
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (8, h, w, 3), np.uint8))
    factors = torch.from_numpy(rt.grid_f32("scale")[[0, 1, 2, 3, 4, 5, 0, 5]])
    assert torch.equal(rtf.zoom_bilinear(x, factors), zoom_bilinear_plain(x, factors))
    angles = torch.from_numpy(rt.grid_f32("rotation")[[0, 3, 9, 12, 18, 4, 7, 15]])
    co = torch.from_numpy(pil_rotate_coeffs(angles.numpy(), w, h).fixed)
    assert torch.equal(rtf.pil_rotate_nearest(x, angles), pil_rotate_nearest_plain(x, co, 0))
    shears = torch.from_numpy(rt.grid_f32("shear")[[0, 1, 3, 5, 7, 9, 10, 10]])
    assert torch.equal(rtf.shear_fast(x, shears), batch._shear_fast(x, shears, None))


def test_a_whole_call_equals_the_ports_on_replayed_draws():
    from imagetransformations_tpu_torch.pipeline.batch import apply_all_transformations

    x = inputs.images(SEED, 12, 32, "cpu")
    got = apply_all_transformations(x, inputs.generator(SEED, "cpu", "calls"), device="cpu",
                                    **apply_all_fast_kind.FLAGS)
    want = rtf.apply_all_fast(x, rt.sweep_draws(inputs.generator(SEED, "cpu", "calls"),
                                                 tuple(x.shape)))
    assert set(got) == set(want) == set(rt.TYPES)
    for t in rt.TYPES:
        assert torch.equal(got[t][1], want[t]), t


def test_sound_cpu_run_is_correct_and_its_control_is_not():
    r = cell.make_run(CELL, SEED, 0.05, False, time.perf_counter(), device="cpu", images=32)
    res, lines = cell.run_cell(r)
    print("\n".join(lines))
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["metrics"]) == {"transform_gpix_per_s.augment", "setup_s"}
    checks = controls.control(cell.make_run(CELL, SEED, 0.0, False, time.perf_counter(),
                                            device="cpu", images=32), 6)
    assert not checks.correct and checks.rows["max_lsb"]["value"] >= 1


def test_work_counts_the_fast_flags():
    shape = (4, 32, 32, 3)
    px = 32 * 32 * 3
    values = {t: np.zeros(4, np.float32) for t in rt.TYPES}
    values["scale"] = np.ones(4, np.float32)
    nbytes, flops = apply_all_fast_kind.fast_work(shape, values)
    assert nbytes == 4 * px * 9 + 8 * 4 * 4
    assert flops == 4.0 * 4 * px  # brightness, noise, contrast only: identity geometry
    values["scale"][0] = 1.4  # zoom in: every place has a source
    values["shear"][1] = 0.5
    values["blur"][2] = 1.5
    values["rotation"][3] = 10.0  # NEAREST: a gather, no arithmetic
    _, more = apply_all_fast_kind.fast_work(shape, values)
    assert more - flops == 9.0 * px + 3.0 * px + 4.0 * 9 * px
    values["scale"][0] = 0.9  # zoom out: the border has no source
    _, out = apply_all_fast_kind.fast_work(shape, values)
    assert 0 < more - out < 9.0 * px


@pytest.mark.cuda
def test_kernels_move_on_the_card(cuda):
    r = cell.make_run(CELL, SEED, 0.2, False, time.perf_counter(), device="cuda", images=512)
    res, _ = cell.run_cell(r)
    assert res["correct"] is True
    for name in ("shear_rows_logrouted", "zoom_bilinear", "pil_rotate_nearest"):
        assert res["checks"][f"launches.{name}"]["value"] >= 1
