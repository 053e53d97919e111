"""The yardstick's arithmetic on hand-counted shapes: multiply-adds, the
transforms' bytes and operations, the roofline and MFU readers, the trace's
union of device intervals, and the sweep's fixed cell order."""

import math

import pytest
import torch
from torch import nn

from harness import inputs, roofline, spec, trace
from reference import cifar_resnet, imagenet_resnet, resize
from reference import transforms as rt

S = spec.load()


def test_macs_of_a_hand_counted_net():
    net = nn.Sequential(nn.Conv2d(3, 4, 3, 1, 1), nn.ReLU(), nn.Conv2d(4, 8, 1, 2),
                        nn.Flatten(), nn.Linear(8 * 4 * 4, 10))
    # 8x8: conv 3x3 3->4: 4*8*8 outputs x 27; conv 1x1 4->8 stride 2: 8*4*4 x 4; dense 128 x 10
    assert roofline.macs_per_image(net, torch.zeros(1, 3, 8, 8)) == 4 * 64 * 27 + 8 * 16 * 4 + 1280


@pytest.mark.parametrize("name,module,size,macs", [
    ("cifar10-resnet56", cifar_resnet, 32, (125e6, 127e6)),
    ("imagenet-resnet50", imagenet_resnet, 224, (4.08e9, 4.12e9)),
])
def test_reference_networks_have_the_published_size(name, module, size, macs):
    cfg = spec.config(S, name)
    net = module.build(cfg)
    params = sum(p.numel() for p in net.parameters())
    assert params == cfg["parameters"]
    m = roofline.macs_per_image(net, torch.zeros(1, 3, size, size))
    assert macs[0] <= m <= macs[1]


def test_least_time_takes_the_larger_roof():
    assert roofline.least_time_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert roofline.least_time_s(1.0, 67e12) == pytest.approx(1.0)
    assert roofline.least_time_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_apply_all_work_by_hand():
    n, h, w, c = 2, 32, 32, 3
    px = h * w * c
    values = {t: torch.zeros(n) for t in rt.TYPES}
    values["scale"] = torch.tensor([1.0, 1.0])
    values["blur"] = torch.tensor([0.0, 1.0])  # ksize 7 for the second image
    values["rotation"] = torch.tensor([0.0, 5.0])
    values["shear"] = torch.tensor([0.0, 0.5])
    nbytes, flops = roofline.apply_all_work((n, h, w, c), {k: v.numpy() for k, v in values.items()})
    assert nbytes == n * px * 9 + 8 * n * 4
    # LANCZOS at factor 1: support 3, so 6 taps an output (fewer at the edges)
    taps = int(resize.resize_coeffs(32, 32, "lanczos")[0][:, 1].sum())
    assert 5 * 32 < taps < 6 * 32
    scale = 2 * 2.0 * c * (h * taps + w * taps)  # 2 images, 2 FLOPs a tap
    assert flops == pytest.approx(scale + 9 * px + 4 * n * px + 4 * 7 * px + 8 * px)


def test_chain_work_by_hand():
    nbytes, flops = roofline.chain_work((4, 10, 10, 3), 1.5)  # ksize 9
    assert nbytes == 2 * 4 * 100 * 3
    assert flops == 4 * 100 * (5 + 36 + 9 + 1)


def _ctx(**work):
    return {"trace": {"window_s": 2.0, "busy_s": 1.5}, "work": work, "device": {}}


def _read(name, **work):
    return spec.metric_reader(name)(_ctx(**work))


def test_sweep_readers_divide_by_the_untraced_time():
    sweep = dict(kind="sweep", macs_per_image=1e9, passes=4, images_per_cell=1000, cells=2,
                 wall_s=1.6)
    # 2 * 1e9 * 4 * 1000 * 2 = 1.6e13 FLOPs over the untraced 1.6 s at 67e12
    assert _read("model_mfu_pct.c10c", **sweep) == pytest.approx(100 * 1.6e13 / (1.6 * 67e12))
    assert _read("device_idle_pct.c10c", **sweep) == pytest.approx(100 * (1 - 1.5 / 1.6))
    for name in ("kernel_roofline_pct.chain", "step_mfu_pct.chain", "host_call_ms.chain"):
        assert _read(name, **sweep) is None


def test_transform_readers_on_hand_counted_numbers():
    tr = dict(kind="transform", calls=10, bytes=3.35e9, flops=6.7e9, least_s=1e-3 * 1.2,
              host_call_ms=0.7)
    assert _read("kernel_roofline_pct.chain", **tr) == pytest.approx(100 * 1.2e-3 / 1.5)
    assert _read("step_mfu_pct.chain", **tr) == pytest.approx(100 * 1.2e-3 / 2.0)
    assert _read("device_idle_pct.augment", **tr) == pytest.approx(25.0)
    assert _read("host_call_ms.augment", **tr) == 0.7
    assert _read("model_mfu_pct.inc", **tr) is None


def test_trace_union_and_idle_gaps():
    ms = 1_000_000
    events = [
        ("cudaLaunchKernel", False, 0, 4 * ms),
        ("cudaStreamSynchronize", False, 4 * ms, 10 * ms),
        ("k1", True, 1 * ms, 3 * ms),
        ("k2", True, 2 * ms, 4 * ms),  # overlaps k1: counted once
        ("k1", True, 6 * ms, 7 * ms),
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(0.010)
    assert s["busy_s"] == pytest.approx(0.004)
    assert dict((k, v) for k, v in s["device_ops"]) == pytest.approx({"k1": 0.003, "k2": 0.002})
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    # gaps [0, 1], [4, 6], [7, 10] ms, named by the call running at their middle
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.002 + 0.003)
    assert gaps["cudaLaunchKernel"] == pytest.approx(0.001)
    assert sum(gaps.values()) == pytest.approx(0.006)


def test_sweep_order_is_fixed_and_covers_every_pair():
    order = spec.traffic("c10c")["corruptions"]
    assert order == spec.traffic("inc")["corruptions"] and len(order) == 15
    cells = [inputs.sweep_cell(order, i) for i in range(75)]
    assert {c for c, _ in cells[:15]} == set(order)
    assert len(set(cells)) == 75
    assert all(1 <= s <= 5 for _, s in cells)
    assert cells[75 % 75] == inputs.sweep_cell(order, 75)


def test_traced_cells_spread_over_the_corruptions():
    from harness.sweep_kind import trace_cells

    assert trace_cells(15, 1) == [0]
    assert trace_cells(15, 2) == [0, 7]
    assert trace_cells(15, 3) == [0, 5, 10]
    order = spec.traffic("c10c")["corruptions"]
    names = {inputs.sweep_cell(order, i)[0] for i in trace_cells(15, 3)}
    assert len(names) == 3


def test_sub_seeds_take_large_seeds_and_differ_by_key():
    a, b = inputs.sub_seed(2**33 + 5, "cell", 1), inputs.sub_seed(2**33 + 5, "cell", 2)
    assert a != b and 0 <= a < 2**63 and a == inputs.sub_seed(2**33 + 5, "cell", 1)
    assert not math.isnan(float(a))
