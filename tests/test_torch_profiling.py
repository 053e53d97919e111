"""The port's profiling helpers (``utils.profiling``), CPU: ``trace`` writes
a Chrome trace that names the ops it recorded, and ``op_throughput``
returns the JAX package's three rates, positive and consistent with one
another (``gpix_per_s`` from the time and the batch's pixels,
``gbytes_per_s`` one u8 read and one write a value)."""

import json

import numpy as np
import torch

from imagetransformations_tpu_torch import utils
from imagetransformations_tpu_torch.ops import elementwise as ew
from imagetransformations_tpu_torch.utils import profiling


def test_trace_writes_chrome_trace(tmp_path):
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8))
    with profiling.trace(str(tmp_path / "tr")) as prof:
        ew.apply_brightness(x, 0.05)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("aten::mul" in str(e.get("name")) for e in events)
    assert len(prof.key_averages()) > 0


def test_op_throughput():
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 32, 32, 3),
                                                           dtype=np.uint8))
    res = profiling.op_throughput(lambda a: ew.apply_brightness(a, 0.01), x, k1=2, k2=6)
    assert set(res) == {"ms_per_op", "gpix_per_s", "gbytes_per_s"}
    assert res["ms_per_op"] > 0 and res["gpix_per_s"] > 0
    assert abs(res["gbytes_per_s"] - 6 * res["gpix_per_s"]) <= 1e-9 * res["gbytes_per_s"]
    assert abs(res["gpix_per_s"] * res["ms_per_op"] * 1e6 - 4 * 32 * 32) < 1e-6 * 4096
    assert utils.op_throughput is profiling.op_throughput and utils.trace is profiling.trace
