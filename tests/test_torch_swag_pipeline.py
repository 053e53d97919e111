"""SWAG collection and the SWAG workflow of the port against the JAX
package's (CPU).

``models.training.swag_collect`` from weights carried from flax
(``test_torch_uq_mc.carried``; a CIFAR ResNet of depth 8, whose BatchNorm
statistics move in every step) over 4 batches against JAX's
``swag_collect``; then ``workflows.swag_pipeline`` end to end against
JAX's, mirroring tests/test_workflows.py:70 (SimpleCNN, 4 classes, 8
images, 4 weight samples, 3 evaluated, rank 3), with JAX's draws
(``test_torch_uq_posterior.jax_sample_draws``) passed to the port.
Budgets: the SWAG moments, ring and parameters rtol 1e-4 (the one-step
gradient budget of PR 14; JAX's collection jits ``swag.update``, where XLA
contracts multiply-adds that the port rounds twice); the BatchNorm
statistics rtol 1e-4; the workflow's probabilities, entropies, JSD and
variances within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu import models as jm
from imagetransformations_tpu.models import training as jt
from imagetransformations_tpu.workflows import swag_pipeline as jswag_pipeline
from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch import workflows as pw
from imagetransformations_tpu_torch.models import training as pt
from imagetransformations_tpu_torch.models.convert import _entries

from test_torch_models import _torch_threads, nchw  # noqa: F401
from test_torch_uq_mc import carried
from test_torch_uq_posterior import _leaf, jax_sample_draws, to_port


def close(got, want, rtol=1e-4, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_swag_collect_against_jax(rng):
    x = rng.standard_normal((4, 8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 4, (4, 8)).astype(np.int32)
    variables, port = carried(lambda: pm.CifarResNet((1, 1, 1), num_classes=4, device="cpu"), 2)
    jmodel = jm.CifarResNet((1, 1, 1), num_classes=4)
    jparams, jstats, jstate = jt.swag_collect(
        jmodel.apply, variables["params"], variables["batch_stats"],
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in zip(x, y)], lr=1e-4, max_rank=3,
        update_every=1)
    model, state = pt.swag_collect(port, [(nchw(a), torch.from_numpy(b)) for a, b in zip(x, y)],
                                   lr=1e-4, max_rank=3)
    assert model is port and state.n_models == int(jstate.n_models) == 4
    named = dict(port.named_parameters())
    buffers = dict(port.named_buffers())
    for k, coll, path, _, tt in _entries(port):
        tree = jparams if coll == "params" else jstats
        close(named[k].detach() if coll == "params" else buffers[k],
              tt(np.asarray(_leaf(tree, path))), msg=k)
    for name in ("mean", "sq_mean"):
        want = to_port(port, getattr(jstate, name))
        for k in want:
            close(getattr(state, name)[k], want[k], msg=f"{name} {k}")
    want = to_port(port, jstate.deviations, lead=1)
    for k in want:
        # the deviations are differences of nearly equal parameters: a budget
        # of 1e-4 of the parameters' scale, and 1e-9 for the biases that
        # start at 0
        scale = float(want[k].abs().max()) + float(state.mean[k].abs().max())
        close(state.deviations[k], want[k], rtol=1e-4, atol=1e-4 * scale + 1e-9,
              msg=f"dev {k}")


def test_swag_collect_update_every(rng):
    port = pm.SimpleCNN(num_classes=4, device="cpu")
    x = torch.from_numpy(rng.standard_normal((5, 2, 3, 32, 32)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (5, 2)))
    _, state = pt.swag_collect(port, list(zip(x, y)), lr=1e-3, max_rank=2, update_every=2)
    assert state.n_models == 3  # steps 0, 2 and 4


def test_swag_pipeline_against_jax(rng):
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 4, 8).astype(np.int32)
    variables, port = carried(lambda: pm.SimpleCNN(num_classes=4, device="cpu"), 0)
    jmodel = jm.SimpleCNN(num_classes=4)
    key = jax.random.key(1)
    want = jswag_pipeline(
        jmodel.apply,
        lambda v, xb, train, mutable: jmodel.apply(v, xb, train, mutable=mutable),
        variables["params"], variables["batch_stats"],
        lambda: [(jnp.asarray(x), jnp.asarray(y))] * 4,
        jnp.asarray(x), key, num_weight_samples=4, eval_mc_samples=3, max_rank=3)
    draws = [jax_sample_draws(port, variables["params"], k, 3) for k in jax.random.split(key, 4)]
    got = pw.swag_pipeline(port, lambda: [(nchw(x), torch.from_numpy(y))] * 4, nchw(x),
                           num_weight_samples=4, eval_mc_samples=3, max_rank=3, draws=draws,
                           device="cpu")
    assert tuple(got["probs"].shape) == (8, 4) and tuple(got["entropy"].shape) == (8,)
    for name in ("probs", "entropy", "one_minus_max", "jsd", "variance"):
        close(got[name], want[name], rtol=1e-4, atol=1e-4, msg=name)
    assert float(torch.min(got["variance"])) >= 0
    assert got["swag_state"].n_models == 4
    for k in got["swag_state"].mean:
        close(got["swag_state"].mean[k], to_port(port, want["swag_state"].mean)[k], msg=k)


def test_swag_pipeline_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is available")
    with pytest.raises(RuntimeError, match="swag_pipeline runs on CUDA"):
        pw.swag_pipeline(None, lambda: [], None)
