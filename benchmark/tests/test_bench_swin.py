"""The ``imagenet-swin-b.inc`` cell: its plain reference stands alone, a CPU
run of the whole cell (the port's ``SwinB`` through ``corruption_sweep``)
is correct, its reader of ``swin.attention`` finds nothing where there is
nothing, and, on the card, the reference in TF32 fails the cell's limits.
The reference against the port at small sizes is ``tests/test_torch_swin.py``."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from harness import cell, roofline, spec
from imagetransformations_tpu_torch.utils import profiling

import controls
from reference import imagenet_swin

BENCH = Path(__file__).resolve().parents[1]
SEED = 2**31 + 2441
CELL = "imagenet-swin-b.inc"


def test_new_reference_modules_load_nothing_of_the_port():
    """Importing the Swin and fast-transform references, and building the
    configuration's network, loads no module of the port or of JAX."""
    code = ("import sys, json; sys.path[:0] = [%r]\n"
            "from reference import imagenet_swin, transforms_fast\n"
            "cfg = json.load(open(%r))\n"
            "net = imagenet_swin.build(dict(cfg, depths=[1, 1, 1, 1]))\n"
            "print(sorted({m.partition('.')[0] for m in sys.modules}))\n"
            % (str(BENCH), str(BENCH / "configs" / "imagenet-swin-b.json")))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"imagetransformations_tpu_torch", "imagetransformations_tpu", "jax"}


def test_the_configuration_is_the_published_swin_b():
    cfg = spec.config(spec.load(), "imagenet-swin-b")
    assert (cfg["embed_dim"], cfg["depths"], cfg["heads"], cfg["window"]) == (
        128, [2, 2, 18, 2], [4, 8, 16, 32], 7)
    from imagetransformations_tpu_torch.models.swin import SwinB

    assert sum(p.numel() for p in SwinB(device="meta").parameters()) == cfg["parameters"]


def test_the_hooks_count_every_image_of_the_published_network():
    """``model_mfu_pct.inc`` counts with ``roofline.macs_per_image`` (one
    image's Conv2d and Linear hooks): on the reference Swin-B it has to
    see every window of the image, 15 126 077 440 multiply-adds (the patch
    convolution, 12 T C² a block of T tokens, 8 T C² a merging into T
    tokens, the classifier). Counted on the meta device: shapes only."""
    cfg = spec.config(spec.load(), "imagenet-swin-b")
    with torch.device("meta"):
        net = imagenet_swin.build(cfg)
        x1 = torch.empty(1, 3, 224, 224)
    tokens, dims = [56 * 56, 28 * 28, 14 * 14, 7 * 7], [128, 256, 512, 1024]
    want = (56 * 56 * 128 * 3 * 4 * 4
            + sum(12 * t * c * c * d for t, c, d in zip(tokens, dims, cfg["depths"]))
            + sum(8 * t * c * c for t, c in zip(tokens[1:], dims[:-1]))
            + 1024 * 1000)
    assert want == 15_126_077_440
    assert roofline.macs_per_image(net, x1) == want


def test_sound_cpu_run_is_correct():
    r = cell.make_run(CELL, SEED, 0.05, False, time.perf_counter(), device="cpu", images=2)
    res, lines = cell.run_cell(r)
    print("\n".join(lines))
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 3
    assert set(res["metrics"]) == {"eval_images_per_s.inc", "setup_s"}
    assert res["checks"]["logit_gap"]["value"] <= 1e-5


def test_reader_finds_nothing_without_swin_spans(monkeypatch):
    read = spec.metric_reader("window_attention_share_pct.inc")
    ctx = {"trace": {}, "work": {"kind": "sweep"}, "device": {}}
    profiling.reset()
    assert read(ctx) is None
    monkeypatch.delattr(profiling, "recorded")
    assert read(ctx) is None


def test_reader_on_a_hand_made_registry(monkeypatch):
    def span(i, name, parent, ms):
        return {"name": name, "index": i, "parent": parent, "root": 0, "root_name": "sweep.cell",
                "seq": 0, "ids": {}, "host_start_ns": i, "host_end_ns": i + 1, "stream_ms": ms}

    spans = [span(0, "sweep.cell", None, 100.0), span(1, "sweep.forward", 0, 90.0),
             span(2, "swin.attention", 1, 30.0), span(3, "swin.attention", 1, 15.0)]
    monkeypatch.setattr(profiling, "recorded", lambda: {"spans": spans, "reads": [], "sites": {}})
    read = spec.metric_reader("window_attention_share_pct.inc")
    assert read({"trace": {}, "work": {}, "device": {}}) == pytest.approx(45.0)


@pytest.mark.cuda
def test_tf32_reference_is_not_correct(cuda):
    r = cell.make_run(CELL, SEED, 0.0, False, time.perf_counter(), device="cuda", images=64)
    checks = controls.control(r, 15)
    assert not checks.correct
