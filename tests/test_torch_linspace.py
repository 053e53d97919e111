"""The port's f32 grids against ``jnp.linspace`` (CPU): the ECE bin edges
and ``minimal_epsilon``'s default eps grid.

``torch.linspace`` is not JAX's: XLA turns ``iota / div`` into ``iota *
f32(1 / div)``, so at 11 points JAX's 0.9 is 0.90000004 and torch's
0.89999998. ``core.grids.linspace_f32`` takes JAX's rule: on the unit
interval bit-equal for every n in 2..301; elsewhere within 1 ulp of the
larger end point (XLA may fold ``stop * t`` into one constant and contract
the sum), and the eps grid within 1 ulp of each level. A confidence on an
edge where the two rules differ falls in JAX's bin (the ECE within an ulp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu.uq import calibration as jc
from imagetransformations_tpu_torch.core.grids import linspace_f32
from imagetransformations_tpu_torch.uq import calibration as pc


def ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def test_unit_edges_bit_equal():
    """n = 2..301 in one jit (start and stop traced, as the eager
    ``jnp.linspace`` traces them: one compile, not 300), and a few n
    eagerly."""
    grids = jax.jit(lambda a, b: [jnp.linspace(a, b, n) for n in range(2, 302)])(
        jnp.float32(0.0), jnp.float32(1.0))
    differ_torch = 0
    for n, want in zip(range(2, 302), grids):
        want = np.asarray(want)
        np.testing.assert_array_equal(linspace_f32(0.0, 1.0, n).numpy(), want, err_msg=str(n))
        differ_torch += int((torch.linspace(0.0, 1.0, n).numpy() != want).sum())
    assert differ_torch > 0  # the rule the port left (8005 values on this torch)
    for n in (2, 11, 16, 101):
        np.testing.assert_array_equal(linspace_f32(0.0, 1.0, n).numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))


@pytest.mark.parametrize("start,stop,n", [(1.0 / 255, 16.0 / 255, 16), (0.0, 5.0, 11),
                                          (-22.5, 22.5, 19), (0.5, 0.25, 7), (3.0, 3.0, 4)])
def test_general_grid(start, stop, n):
    """The end points exact; each value within one ulp of the larger end
    point's magnitude (where ``start * (1 - t)`` and ``stop * t`` cancel,
    e.g. 2.5 on -22.5..22.5, XLA's fold moves the last bits)."""
    got = linspace_f32(start, stop, n).numpy()
    want = np.asarray(jnp.linspace(start, stop, n))
    assert got[0] == want[0] and got[-1] == want[-1]
    assert np.abs(got - want).max() <= np.spacing(np.float32(max(abs(start), abs(stop))))


def test_degenerate_sizes():
    assert linspace_f32(0.0, 1.0, 1).tolist() == [0.0]
    assert linspace_f32(0.0, 1.0, 0).shape == (0,)


@pytest.mark.parametrize("n_bins", [10, 15])
def test_confidence_on_a_differing_edge(n_bins):
    """Each confidence exactly on an edge where torch's and JAX's grids part
    (10 bins: 0.90000004; 15 bins: six edges) lands in JAX's bin."""
    jedges = np.asarray(jnp.linspace(0.0, 1.0, n_bins + 1))
    differing = jedges[jedges != torch.linspace(0.0, 1.0, n_bins + 1).numpy()]
    assert len(differing) > 0
    k = len(differing)
    probs = np.full((k, 4), 0.0, np.float32)
    probs[:, 0] = differing
    probs[:, 1:] = ((1.0 - differing) / 3)[:, None]
    labels = np.arange(k) % 2
    got = pc.calibration_bins(torch.from_numpy(probs), torch.from_numpy(labels), n_bins)
    want = jc.calibration_bins(jnp.asarray(probs), jnp.asarray(labels), n_bins)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the ECE's sum over the bins in another order: within an ulp
    assert ulps(pc.ece(torch.from_numpy(probs), torch.from_numpy(labels), n_bins).numpy(),
                np.asarray(jc.ece(jnp.asarray(probs), jnp.asarray(labels), n_bins))) <= 1


def test_minimal_epsilon_default_grid():
    """``minimal_epsilon``'s default grid is ``linspace_f32(1/255, 16/255,
    16)``, every level within 1 ulp of JAX's; a model that flips every
    image at the first level returns that level."""
    from imagetransformations_tpu_torch.attacks import fgsm

    x = torch.full((2, 3, 4, 4), 0.5)
    y = torch.zeros(2, dtype=torch.int64)

    def model(xb):  # class 1 wins once the mean moves up by 1e-6
        m = xb.reshape(xb.shape[0], -1).mean(1)
        return torch.stack([torch.zeros_like(m), 1000.0 * (m - 0.5) - 1e-3], 1)

    grid = linspace_f32(1.0 / 255, 16.0 / 255, 16)
    assert torch.equal(fgsm.minimal_epsilon(model, x, y), grid[:1].expand(2))
    assert ulps(grid.numpy(), np.asarray(jnp.linspace(1.0 / 255, 16.0 / 255, 16))).max() <= 1
