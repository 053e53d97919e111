"""The port's one-process device mesh against the JAX package's mesh of 8
virtual CPU devices (``tests/conftest.py``).

- ``data_mesh``, ``shard_images``, ``sharded_apply``, ``psum_mean`` and
  ``sharded_accuracy`` on 8 CPU slots: the same shards, outputs and
  accuracy as JAX's (accuracy within 1e-7, JAX's own budget);
- ``sharded_chain_fn``, a static angle and per-image angles (a shard whose
  angles lie in a lower 5-degree band gets the global budget), gray and
  RGB: 0 LSB against the port's one-device chain, and within C.3's chain
  budget of JAX's ``sharded_chain_fn`` (<= 1 LSB on <= 1% of values, where
  XLA-CPU contracts an FMA);
- ``sharded_gaussian_blur`` at 2x64x48x3, r 1.5: 0 LSB against the port's
  ``gaussian_blur`` and ``cv2.GaussianBlur``; within C.3's blur budget of
  JAX's (<= 2 LSB on <= 27% of values: JAX's f32 taps, not cv2's integers);
  the same ``ValueError`` at 1x24x24x3;
- ``global_batch_from_host_shards`` as JAX's test, and its multi-process
  scope;
- ``build_chain_fn(jit=False)`` equal to ``jit=True``.
"""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from imagetransformations_tpu import ops as jops
from imagetransformations_tpu.ops.sharded_stencil import sharded_gaussian_blur as j_sharded_blur
from imagetransformations_tpu.pipeline import chain as jchain
from imagetransformations_tpu.pipeline import sharding as js
from imagetransformations_tpu.pipeline.io import global_batch_from_host_shards as j_global
from imagetransformations_tpu_torch.ops import elementwise as pew
from imagetransformations_tpu_torch.ops.hopper import megakernel as pmk
from imagetransformations_tpu_torch.ops.sharded_stencil import sharded_gaussian_blur
from imagetransformations_tpu_torch.ops.stencil import gaussian_blur
from imagetransformations_tpu_torch.pipeline import chain as pchain
from imagetransformations_tpu_torch.pipeline import sharding as ps
from imagetransformations_tpu_torch.pipeline.io import global_batch_from_host_shards

BLUR_LSB, BLUR_SHARE = 2, 0.27
CHAIN_LSB, CHAIN_SHARE = 1, 0.01


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8, "conftest should give 8 CPU devices"
    return js.data_mesh(), ps.data_mesh(8, device="cpu")


def test_data_mesh(meshes, monkeypatch):
    jm, pm = meshes
    assert pm.shape == dict(jm.shape) == {"data": 8}
    assert pm.axis_names == tuple(jm.axis_names) and pm.size == 8
    assert ps.data_mesh(3, axis="rows", device="cpu").shape == dict(js.data_mesh(3, "rows").shape)
    assert ps.data_mesh(device="cpu").shape == {"data": 1}
    assert ps.data_mesh(2, device="cuda").devices == (torch.device("cuda", 0),) * 2
    assert ps.Mesh(["cpu", "cpu"]) == ps.Mesh((torch.device("cpu"),) * 2)
    with pytest.raises(ValueError):
        ps.Mesh(())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ps.data_mesh()


def test_shard_images_and_apply(meshes, rng):
    jm, pm = meshes
    imgs = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    ja = js.shard_images(jnp.asarray(imgs), jm)
    pa = ps.shard_images(imgs, pm)
    jshards = sorted(ja.addressable_shards, key=lambda s: s.index[0].start)
    assert len(pa.shards) == len(jshards) == 8
    for got, want in zip(pa.shards, jshards):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.data))
    assert pa.shape == ja.shape and len(pa) == 16
    np.testing.assert_array_equal(np.asarray(pa), imgs)
    assert ps.shard_images(pa, pm) is pa
    with pytest.raises(ValueError):
        ps.shard_images(imgs[:12], pm)
    with pytest.raises(ValueError):
        js.shard_images(jnp.asarray(imgs[:12]), jm)
    # the map-style wrapper (JAX's test_sharded_apply_8_devices)
    got = ps.sharded_apply(lambda x: pew.apply_brightness(x, 0.05), pm)(pa)
    want = js.sharded_apply(lambda x: jops.apply_brightness(x, 0.05), jm)(ja)
    assert isinstance(got, ps.ShardedBatch) and len(got.shards) == 8
    np.testing.assert_array_equal(got.gather().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.gather().numpy(),
                                  pew.apply_brightness(torch.from_numpy(imgs), 0.05).numpy())


def test_psum_mean_and_sharded_accuracy(meshes, rng):
    jm, pm = meshes
    logits = rng.standard_normal((64, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 64)
    want = js.sharded_accuracy(js.shard_images(jnp.asarray(logits), jm),
                               js.shard_images(jnp.asarray(labels), jm), jm)
    got = ps.sharded_accuracy(logits, labels, pm)
    ref = float(np.mean(logits.argmax(-1) == labels))
    assert got == pytest.approx(want, abs=1e-7) and got == pytest.approx(ref, abs=1e-7)
    v = rng.random(64).astype(np.float32)
    from jax.sharding import PartitionSpec as P

    jmean = jax.jit(jax.shard_map(lambda t: js.psum_mean(t, "data"), mesh=jm, in_specs=P("data"),
                                  out_specs=P()))(js.shard_images(jnp.asarray(v), jm))
    pmean = ps.psum_mean(ps.shard_images(v, pm))
    assert float(pmean) == pytest.approx(float(jmean), rel=1e-6)
    # unequal shards: a mean of means, as psum pairs them
    parts = [torch.ones(2), torch.zeros(6)]
    assert float(ps.psum_mean(parts)) == 0.5


def _chain(angle, gray):
    ops = [pchain.OpSpec("blur", {"radius": 1.5}), pchain.OpSpec("rotation", {"angle": angle})]
    return ops + [pchain.OpSpec("grayscale")] if gray else ops


def _lower_band_angles(rng, n=16):
    """Per-image angles within 22.5 degrees, shard 0's (2 of 16) in the
    lowest 5-degree band: its own budget would be 5, the batch's is 25."""
    a = rng.uniform(-22.5, 22.5, n).astype(np.float32)
    a[:2] = (2.0, -3.5)
    a[-1] = 22.0
    return a


@pytest.mark.parametrize("gray", [True, False], ids=["gray", "rgb"])
@pytest.mark.parametrize("per_image", [False, True], ids=["static", "per_image"])
def test_sharded_chain_fn(meshes, rng, monkeypatch, gray, per_image):
    jm, pm = meshes
    imgs = rng.integers(0, 256, (16, 40, 48, 3), dtype=np.uint8)
    angle = _lower_band_angles(rng) if per_image else 15.0
    chain = _chain(angle, gray)
    budgets = []
    batched = pchain.fused_blur_rotate_batched

    def recording(x, radius, angles, **kw):
        budgets.append(kw["max_angle_deg"])
        return batched(x, radius, angles, **kw)

    monkeypatch.setattr(pchain, "fused_blur_rotate_batched", recording)
    out = ps.sharded_chain_fn(chain, pm)(imgs)
    assert isinstance(out, ps.ShardedBatch) and len(out.shards) == 8
    assert budgets == ([25.0] * 8 if per_image else [])
    ref = pchain.build_chain_fn(chain, device="cpu")(imgs).numpy()
    np.testing.assert_array_equal(out.gather().numpy(), ref)
    jc = [jchain.OpSpec(s.name, dict(s.params)) for s in chain]
    want = np.asarray(js.sharded_chain_fn(jc, jm)(js.shard_images(jnp.asarray(imgs), jm)))
    d = np.abs(out.gather().numpy().astype(int) - want.astype(int))
    assert d.max() <= CHAIN_LSB and (d > 0).mean() <= CHAIN_SHARE, (d.max(), (d > 0).mean())


def test_budget_changes_no_pixel(rng):
    """A budget that covers the angles clips none of them: the lower-band
    shard's images come out the same under its own budget and the batch's."""
    x = torch.from_numpy(rng.integers(0, 256, (2, 40, 48, 3), dtype=np.uint8))
    angles = np.asarray([2.0, -3.5], np.float32)
    for gray in (True, False):
        outs = [pmk.fused_blur_rotate_batched(x, 1.5, angles, grayscale_out=gray, stream=True,
                                              max_angle_deg=b) for b in (5.0, 25.0, 45.0)]
        for o in outs[1:]:
            assert torch.equal(o, outs[0])
    # the one-device chain keeps a declared budget that covers the angles
    spec = pchain.OpSpec("rotation", {"angle": angles, "max_angle_deg": 25.0})
    assert pchain._match_mega([spec], 0, 3)[4] == 25.0
    low = pchain.OpSpec("rotation", {"angle": angles, "max_angle_deg": 1.0})
    assert pchain._match_mega([low], 0, 3)[4] == 5.0


def test_sharded_chain_fn_lifts_parameters(meshes, rng):
    _, pm = meshes
    imgs = rng.integers(0, 256, (8, 24, 24, 3), dtype=np.uint8)
    chain = [pchain.OpSpec("rotation", {"angle": np.float32(7.0)})]
    np.testing.assert_array_equal(
        ps.sharded_chain_fn(chain, pm)(imgs).gather().numpy(),
        pchain.build_chain_fn([pchain.OpSpec("rotation", {"angle": 7.0})], device="cpu")(
            imgs).numpy())
    bad = [pchain.OpSpec("rotation", {"angle": np.zeros(4, np.float32)})]
    with pytest.raises(ValueError, match="per-image"):
        ps.sharded_chain_fn(bad, pm)(imgs)
    # noise ops draw from the caller's generator, shard after shard
    noisy = [pchain.OpSpec("gaussian_noise", {"std": 0.05})]
    got = ps.sharded_chain_fn(noisy, pm)(imgs, torch.Generator().manual_seed(4)).gather()
    g = torch.Generator().manual_seed(4)
    fn = pchain.build_chain_fn(noisy, device="cpu")
    want = torch.cat([fn(imgs[i:i + 1], g) for i in range(8)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("slots", [8, 4, 1])
def test_sharded_gaussian_blur(meshes, rng, slots):
    jm, _ = meshes
    pm = ps.data_mesh(slots, device="cpu")
    imgs = rng.integers(0, 256, (2, 64, 48, 3), dtype=np.uint8)
    out = sharded_gaussian_blur(imgs, 1.5, pm)
    assert out.dim == 1 and len(out.shards) == slots and out.shape == imgs.shape
    got = out.gather().numpy()
    np.testing.assert_array_equal(got, gaussian_blur(torch.from_numpy(imgs), 1.5).numpy())
    for i in range(2):
        np.testing.assert_array_equal(got[i], cv2.GaussianBlur(imgs[i], (9, 9), 1.5,
                                                               borderType=cv2.BORDER_REFLECT_101))
    if slots == 8:
        want = np.asarray(j_sharded_blur(jnp.asarray(imgs), 1.5, jm)).astype(int)
        d = np.abs(got.astype(int) - want)
        assert d.max() <= BLUR_LSB and (d > 0).mean() <= BLUR_SHARE
    # f32 input: the same rows as the unsharded f32 blur
    f = rng.random((1, 64, 16, 3)).astype(np.float32) * 255.0
    np.testing.assert_array_equal(sharded_gaussian_blur(f, 2.5, pm).gather().numpy(),
                                  gaussian_blur(torch.from_numpy(f), 2.5).numpy())
    assert torch.equal(sharded_gaussian_blur(imgs, 0, pm).gather(), torch.from_numpy(imgs))


def test_sharded_blur_rejects_bad_split(meshes):
    jm, pm = meshes
    imgs = np.zeros((1, 24, 24, 3), np.uint8)  # 3 rows a shard < p = 4
    with pytest.raises(ValueError) as jerr:
        j_sharded_blur(jnp.asarray(imgs), 1.5, JMesh(np.asarray(jax.devices()), ("data",)))
    with pytest.raises(ValueError) as perr:
        sharded_gaussian_blur(imgs, 1.5, pm)
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError):
        sharded_gaussian_blur(np.zeros((1, 60, 8, 3), np.uint8), 1.5, pm)  # 60 % 8


def test_global_batch_from_host_shards(meshes, rng, monkeypatch):
    jm, pm = meshes
    local = rng.integers(0, 256, (16, 8, 8, 3), dtype=np.uint8)
    want = j_global(local, jm)
    arr = global_batch_from_host_shards(local, pm)
    assert arr.shape == want.shape == (16, 8, 8, 3)
    assert arr.axis == want.sharding.spec[0] == "data" and arr.dim == 0 and len(arr.shards) == 8
    np.testing.assert_array_equal(np.asarray(arr), local)
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(RuntimeError, match="must be a process mesh"):
        global_batch_from_host_shards(local, pm)


def test_build_chain_fn_jit_flag(rng):
    imgs = rng.integers(0, 256, (3, 40, 48, 3), dtype=np.uint8)
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    for chain in (_chain(15.0, True), _chain(_lower_band_angles(rng, 3), False),
                  [pchain.OpSpec("sharpness", {"factor": 1.5}),
                   pchain.OpSpec("gaussian_noise", {"std": 0.05})]):
        a = pchain.build_chain_fn(chain, jit=True, device="cpu")(imgs, g())
        b = pchain.build_chain_fn(chain, jit=False, device="cpu")(imgs, g())
        assert torch.equal(a, b)
    # fast_compile acts under jit=True only, as in JAX (chain.py:261)
    chain = _chain(15.0, True)
    fc = pchain.build_chain_fn(chain, fast_compile=True, jit=False, device="cpu")(imgs)
    assert torch.equal(fc, pchain.build_chain_fn(chain, device="cpu")(imgs))
