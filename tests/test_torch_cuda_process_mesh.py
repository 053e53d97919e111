"""The process mesh on the card: 2 gloo ranks sharing ``cuda:0``
(``tools/run_process_mesh.py`` under ``python -m torch.distributed.run
--standalone --nproc-per-node=2``, the workload ``make_inputs("small")``).

- the four ``sharded_chain_fn`` chains and ``sharded_gaussian_blur``: the
  ranks' shards 0 LSB against the one-device call on the card;
- the training step, run once with the caller's TF32 on and once off
  (cuDNN deterministic in both): every parameter, buffer and loss
  bit-equal, since ``full_f32`` holds around the forward, the backward
  and their collectives; the ranks' parameters equal bit for bit.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one (decided inside the fixture). No JAX is imported:

    python -m pytest tests/test_torch_cuda_process_mesh.py -q
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import run_process_mesh as rpm  # noqa: E402

pytestmark = pytest.mark.cuda
RANKS = 2


def _ranks(d: Path, inputs_path: Path, tf32: str) -> list:
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = d / f"tf32_{tf32}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={RANKS}", str(ROOT / "tools" / "run_process_mesh.py"),
         "--device=cuda", f"--inputs={inputs_path}", f"--out={out}", f"--tf32={tf32}"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:  # torchrun and its ranks
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, stdout[-4000:] + stderr[-8000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, ranks with TF32 on, ranks with TF32 off, the one-device run
    on the card); the kernels built here before any rank starts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card path runs only on the card")
    from imagetransformations_tpu_torch.ops.hopper import _lib

    _lib.build_all()
    d = tmp_path_factory.mktemp("cuda_process_mesh")
    inputs = rpm.make_inputs("small", 5, RANKS)
    torch.save(inputs, d / "inputs.pt")
    on, off = _ranks(d, d / "inputs.pt", "on"), _ranks(d, d / "inputs.pt", "off")
    return inputs, on, off, rpm.run_all(inputs, None, "cuda")["out"]


def test_gloo_ranks_share_the_card(runs):
    _, on, _, _ = runs
    assert {(r["backend"], r["device"]) for r in on} == {("gloo", "cuda:0")}


@pytest.mark.parametrize("run", [*rpm.CHAINS, "blur"])
def test_chains_and_halo_blur_zero_lsb(runs, run):
    _, on, _, one = runs
    got = torch.cat([r["out"][run] for r in on], dim=1 if run == "blur" else 0)
    assert torch.equal(got, one[run])


def test_train_step_tf32_on_equals_off(runs):
    _, on, off, _ = runs
    for a, b in zip(on, off):
        for part in ("params", "buffers", "grads"):
            for k, v in b["out"]["train"][part].items():
                assert torch.equal(a["out"]["train"][part][k], v), (part, k)
        for x, y in zip(a["out"]["train"]["loss_acc"], b["out"]["train"]["loss_acc"]):
            assert torch.equal(x[0], y[0])
    for k, v in on[0]["out"]["train"]["params"].items():
        assert torch.equal(on[1]["out"]["train"]["params"][k], v), k
