"""The port's build_chain_fn against the JAX build_chain_fn.

Both take the same numpy batch and the same chain (op name + params); the
port runs on the CPU (device="cpu": the kernels' plain versions), the JAX
package on its CPU backend (Pallas in interpret mode). The chains of
CHAINS route entirely through the fused kernels in both packages. Budget
against JAX: <= 1 LSB on <= 0.1% of pixels (XLA-CPU FMA contraction);
against the numpy stream oracle: 0 LSB. The chains and inputs the port
refused before the rest of the dispatcher was ported are held against JAX
too (tests/test_torch_chain_full.py covers every route).
"""

import numpy as np
import pytest
import torch

import cv2
import jax.numpy as jnp

from imagetransformations_tpu.oracle import fast_warp as ofw
from imagetransformations_tpu.pipeline import chain as jchain

from imagetransformations_tpu_torch.ops.stencil import cv2_gaussian_ksize
from imagetransformations_tpu_torch.pipeline import chain as tchain

# (ops as (name, params), stream-oracle segments as (radius, angle, gray))
CHAINS = {
    "blur>rotation>gray": (
        [("blur", {"radius": 1.5}), ("rotation", {"angle": 15.0}), ("grayscale", {})],
        [(1.5, 15.0, True)],
    ),
    "rotation": ([("rotation", {"angle": -22.5})], [(0.0, -22.5, False)]),
    "rotation|blur>gray": (  # two fused segments
        [("rotation", {"angle": 7.0}), ("blur", {"radius": 1.0}), ("grayscale", {})],
        [(0.0, 7.0, False), (1.0, 0.0, True)],
    ),
    "blur": ([("blur", {"radius": 2.5})], [(2.5, 0.0, False)]),
    "blur>gray": ([("blur", {"radius": 1.5}), ("grayscale", {})], [(1.5, 0.0, True)]),
}


def _ops(module, ops):
    return [module.OpSpec(name, dict(params)) for name, params in ops]


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_matches_jax_and_oracle(rng, name):
    ops, segments = CHAINS[name]
    imgs = rng.integers(0, 256, (2, 64, 48, 3), dtype=np.uint8)
    out = tchain.build_chain_fn(_ops(tchain, ops), device="cpu")(imgs)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    out = out.numpy()
    ref = imgs
    for radius, angle, gray in segments:
        ref = ofw.fused_stream_chain(ref, radius, angle, grayscale_out=gray)
    assert np.array_equal(out, ref)
    want = np.asarray(jchain.build_chain_fn(_ops(jchain, ops))(jnp.asarray(imgs)))
    err = np.abs(out.astype(int) - want.astype(int))
    assert err.max() <= 1 and (err > 0).mean() <= 0.001, (err.max(), (err > 0).mean())


def test_chain_plan_matches_jax_routing(rng):
    """The port's static-angle matcher consumes the same ops with the same
    parameters as the JAX _match_mega."""
    x = jnp.zeros((1, 64, 48, 3), jnp.uint8)
    for name, (ops, _) in CHAINS.items():
        jc, tc = _ops(jchain, ops), _ops(tchain, ops)
        i = 0
        while i < len(ops):
            want = jchain._match_mega(jc, i, False, x)
            got = tchain._match_mega(tc, i, 3)
            assert want is not None and want[4] is None, name
            assert got == want, name
            i += got[3]


def test_chain_accepts_tensor_and_empty_chain(rng):
    imgs = rng.integers(0, 256, (1, 40, 36, 3), dtype=np.uint8)
    fn = tchain.build_chain_fn([tchain.OpSpec("rotation", {"angle": 5})], device="cpu")
    assert torch.equal(fn(torch.from_numpy(imgs)), fn(imgs))
    assert np.array_equal(tchain.build_chain_fn([], device="cpu")(imgs).numpy(), imgs)


@pytest.mark.parametrize(
    "ops,kwargs,item",
    [
        # angle arrays beyond the +-45 routing budget take the affine warp
        ([("rotation", {"angle": np.array([5.0, -50.0], np.float32)})], {}, "A.6"),
        ([("rotation", {"angle": np.float32(60.0)})], {}, "A.6"),
        ([("blur", {"radius": 1.5}), ("rotation", {"angle": 15.0})],
         {"strict_parity": True}, "A.6"),
        ([("rotation", {"angle": 60.0})], {}, "A.6"),
        ([("blur", {"radius": 1.5}), ("rotation", {"angle": -50.0})], {}, "A.6"),
        ([("brightness", {"factor": 1.2})], {}, "A.6"),
        ([("rotation", {"angle": 15.0}), ("invert", {})], {}, "A.6"),
        ([("grayscale", {})], {}, "A.6"),
    ],
)
def test_unported_chains_raise(rng, ops, kwargs, item):
    """The chains the port refused until ROADMAP ``item`` was ported now
    run, and match the JAX chain: <= 1 LSB on <= 0.1% of values (the
    affine warp's rotation matrix: the port's correctly rounded f32 cos /
    sin against XLA's; measured 0.05% at 60 degrees). A strict chain's blur
    is cv2's integer blur, where JAX blurs in f32: the rest of that chain is
    held to the JAX chain on cv2's blur of the input at the same budget,
    and the whole chain to JAX within <= 1 LSB on <= 10% (measured 8.4%)."""
    imgs = rng.integers(0, 256, (2, 40, 48, 3), dtype=np.uint8)
    out = tchain.build_chain_fn(_ops(tchain, ops), device="cpu", **kwargs)(imgs).numpy()
    want = np.asarray(jchain.build_chain_fn(_ops(jchain, ops), **kwargs)(jnp.asarray(imgs)))
    err = np.abs(out.astype(int) - want.astype(int))
    if kwargs.get("strict_parity") and ops[0][0] == "blur":
        assert err.max() <= 1 and (err > 0).mean() <= 0.10, (item, err.max(), (err > 0).mean())
        r = ops[0][1]["radius"]
        k = cv2_gaussian_ksize(r)
        blurred = np.stack([cv2.GaussianBlur(im, (k, k), r) for im in imgs])
        want = np.asarray(jchain.build_chain_fn(_ops(jchain, ops[1:]), **kwargs)(
            jnp.asarray(blurred)))
        err = np.abs(out.astype(int) - want.astype(int))
    assert err.max() <= 1 and (err > 0).mean() <= 0.001, (item, err.max(), (err > 0).mean())


def test_unported_inputs_raise_at_call(rng):
    """HWC and float32 inputs run op by op, as in JAX. A blur > grayscale
    chain on one channel computes: the blur segment, then the grayscale of
    one channel (its own luma, repeated to 3 channels), 0 LSB against the
    stream oracle; the JAX chain raises there, from its megakernel."""
    gray_chain = [("blur", {"radius": 1.5}), ("grayscale", {})]
    fn = tchain.build_chain_fn(_ops(tchain, gray_chain), device="cpu")
    jfn = jchain.build_chain_fn(_ops(jchain, gray_chain))
    one_channel = rng.integers(0, 256, (1, 40, 36, 1), dtype=np.uint8)
    want = np.repeat(ofw.fused_stream_chain(one_channel, 1.5, 0.0), 3, axis=-1)
    assert np.array_equal(fn(one_channel).numpy(), want)
    with pytest.raises(TypeError):
        jfn(jnp.asarray(one_channel))
    hwc = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
    with pytest.raises(ValueError):
        jfn(jnp.asarray(hwc))  # the JAX chain's HWC blur unpacks four dims
    want = tchain.build_chain_fn(_ops(tchain, gray_chain), strict_parity=True,
                                 device="cpu")(hwc[None])[0]
    assert torch.equal(fn(hwc), want)  # the u8 blur, then grayscale
    floats = rng.random((1, 40, 36, 3), dtype=np.float32) * 255
    out = fn(floats)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jfn(jnp.asarray(floats))), atol=2e-3)


def test_default_device_is_cuda_and_never_cpu(monkeypatch):
    """Without a GPU, build_chain_fn with no device raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chain = [tchain.OpSpec("rotation", {"angle": 15.0})]
    with pytest.raises(RuntimeError, match="CUDA"):
        tchain.build_chain_fn(chain)
    with pytest.raises(RuntimeError, match="CUDA"):
        tchain.build_chain_fn(chain, device="cuda")
    assert callable(tchain.build_chain_fn(chain, device="cpu"))
