"""The port's reverse-FGSM refinement (``adapt.refine``), flip analysis and
failure heads (``evalx.analysis``) and ``workflows.refinement_pipeline``
against the JAX package's (CPU).

Logits from numpy seeds, the later ones with ties; a CIFAR ResNet of depth
8 carried from flax (``test_torch_uq_mc.carried``) on 8 images in [0, 1].
Budgets: the five losses rtol 1e-5; ``refine_batch`` the same iteration
count and its inputs equal to JAX's except on <= 0.1% of the values (a
gradient sign near 0; up to 2 eps a step there, as the attacks);
``single_step_refine`` the same; ``flip_analysis`` equal;
``FailureHead``'s standardized features rtol 1e-5 and its probabilities
after 50 Adam steps from JAX's initial draws rtol 1e-4;
``superclass_confusion_rule`` equal with ties at the k-th place (the port
takes ``lax.top_k``'s set); ``refinement_pipeline`` equal to JAX's on
tests/test_workflows.py:42's linear model (threshold rtol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu import models as jm
from imagetransformations_tpu.adapt import refine as jr
from imagetransformations_tpu.evalx import analysis as ja
from imagetransformations_tpu.workflows import refinement_pipeline as jpipeline
from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch import workflows as pw
from imagetransformations_tpu_torch.adapt import refine as pr
from imagetransformations_tpu_torch.evalx import analysis as pa

from test_torch_attacks import assert_mostly_equal, nhwc
from test_torch_models import _torch_threads, nchw  # noqa: F401
from test_torch_uq_mc import carried


def logits_and_labels(seed, n=64, c=10):
    rng = np.random.default_rng(seed)
    lg = rng.normal(0, 3, (n, c)).astype(np.float32)
    if seed >= 1:
        lg = np.round(lg * 2) / 2
    if seed >= 2:
        lg[:, 4] = lg[:, 2]
        lg[::5] = 0.0
    return lg, rng.integers(0, c, n).astype(np.int32)


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", range(3))
def test_losses(seed):
    lg, y = logits_and_labels(seed)
    t, ty, j, jy = torch.from_numpy(lg), torch.from_numpy(y), jnp.asarray(lg), jnp.asarray(y)
    close(pr.logit_margin_loss(t, ty), jr.logit_margin_loss(j, jy))
    close(pr.logit_margin_loss(t, ty, 2.0), jr.logit_margin_loss(j, jy, 2.0))
    close(pr.entropy_loss(t), jr.entropy_loss(j))
    close(pr.pseudo_label_loss(t), jr.pseudo_label_loss(j))
    ref = lg + np.random.default_rng(seed).normal(size=lg.shape).astype(np.float32)
    close(pr.logit_consistency_loss(t, torch.from_numpy(ref)),
          jr.logit_consistency_loss(j, jnp.asarray(ref)))
    key = jax.random.key(seed)
    offset = np.asarray(jax.random.randint(key, y.shape, 1, 10))  # as negative_class_loss
    close(pr.negative_class_loss(t, ty, offset=torch.from_numpy(offset)),
          jr.negative_class_loss(j, jy, key))
    a = pr.negative_class_loss(t, ty, torch.Generator().manual_seed(1))
    assert torch.equal(a, pr.negative_class_loss(t, ty, torch.Generator().manual_seed(1)))


@pytest.fixture(scope="module")
def resnet8():
    variables, port = carried(lambda: pm.CifarResNet((1, 1, 1), device="cpu"), 31)
    jmodel = jm.CifarResNet((1, 1, 1))
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
    flagged = np.array([1, 1, 0, 1, 0, 1, 1, 1], bool)
    return port, jax.jit(lambda xb: jmodel.apply(variables, xb)), x, flagged


@pytest.mark.parametrize("loss_kind", ["logit_margin", "entropy", "pseudo_label"])
def test_refine_batch(resnet8, loss_kind):
    port, jfn, x, flagged = resnet8
    got, iters = pr.refine_batch(port, nchw(x), torch.from_numpy(flagged), loss_kind=loss_kind,
                                 max_iters=3, eps=0.02)
    want, jiters = jr.refine_batch(jfn, jnp.asarray(x), jnp.asarray(flagged),
                                   loss_kind=loss_kind, max_iters=3, eps=0.02)
    assert iters == int(jiters) == 3
    assert_mostly_equal(nhwc(got), want, 0.02 * 3)
    np.testing.assert_array_equal(nhwc(got)[~flagged], x[~flagged])  # only flagged ones move


def test_refine_batch_stops(resnet8):
    """No sample active: no iteration; msp_stop reached by every flagged
    sample at once: one."""
    port, jfn, x, flagged = resnet8
    got, iters = pr.refine_batch(port, nchw(x), torch.zeros(8, dtype=torch.bool))
    assert iters == 0 and torch.equal(got, nchw(x))
    got, iters = pr.refine_batch(port, nchw(x), torch.from_numpy(flagged), msp_stop=0.0)
    assert iters == 0
    _, jiters = jr.refine_batch(jfn, jnp.asarray(x), jnp.asarray(flagged), msp_stop=0.0)
    assert int(jiters) == 0
    with pytest.raises(ValueError):
        pr.refine_batch(port, nchw(x), torch.from_numpy(flagged), loss_kind="other")


def test_single_step_refine(resnet8):
    port, jfn, x, flagged = resnet8
    got = pr.single_step_refine(port, nchw(x), torch.from_numpy(flagged), 0.03)
    want = jr.single_step_refine(jfn, jnp.asarray(x), jnp.asarray(flagged), 0.03)
    assert_mostly_equal(nhwc(got), want, 0.03)


@pytest.mark.parametrize("seed", range(3))
def test_flip_analysis(seed):
    a, y = logits_and_labels(seed)
    b, _ = logits_and_labels(seed + 10)
    got = pa.flip_analysis(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(y))
    want = ja.flip_analysis(jnp.asarray(a), jnp.asarray(b), jnp.asarray(y))
    assert got == pytest.approx(want, rel=1e-7) and list(got) == list(want)
    assert got["fixed"] + got["broken"] + got["stable_correct"] + got["stable_incorrect"] == 64


def test_failure_head(rng):
    lg, y = logits_and_labels(0, n=128)
    extra = rng.standard_normal((128, 3)).astype(np.float32)
    feats = pa.FailureHead.features_from_logits(torch.from_numpy(lg), torch.from_numpy(extra))
    jfeats = ja.FailureHead.features_from_logits(jnp.asarray(lg), jnp.asarray(extra))
    close(feats, jfeats)
    failed = np.argmax(lg, -1) != y
    k1, k2 = jax.random.split(jax.random.key(3))
    init = (np.array(jax.random.normal(k1, (7, 16))), np.array(jax.random.normal(k2, (16, 1))))
    head = pa.FailureHead(hidden=16, seed=3).fit(feats, torch.from_numpy(failed), steps=50,
                                                 init=init)
    jhead = ja.FailureHead(hidden=16, seed=3).fit(jfeats, jnp.asarray(failed), steps=50)
    close(head.predict_proba(feats), jhead.predict_proba(jfeats), rtol=1e-4, atol=1e-6)
    again = pa.FailureHead(hidden=16, seed=3).fit(feats, torch.from_numpy(failed), steps=5)
    other = pa.FailureHead(hidden=16, seed=3).fit(feats, torch.from_numpy(failed), steps=5)
    assert torch.equal(again.predict_proba(feats), other.predict_proba(feats))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k", [2, 3, 5])
def test_superclass_confusion_rule(seed, k):
    lg, _ = logits_and_labels(seed, c=20)
    supers = np.random.default_rng(seed).permutation(20) // 5
    got = pa.superclass_confusion_rule(torch.from_numpy(lg), torch.from_numpy(supers), k)
    want = ja.superclass_confusion_rule(jnp.asarray(lg), jnp.asarray(supers), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_superclass_rule_tie_at_kth_place():
    """Classes 1, 2, 3 tie behind class 0; k = 2 takes class 1 (the lower
    index), which shares class 0's superclass, so nothing is flagged."""
    lg = torch.tensor([[5.0, 1.0, 1.0, 1.0]])
    supers = torch.tensor([0, 0, 1, 1])
    assert not bool(pa.superclass_confusion_rule(lg, supers, 2)[0])
    assert not bool(ja.superclass_confusion_rule(jnp.asarray(lg.numpy()),
                                                 jnp.asarray(supers.numpy()), 2)[0])


def test_refinement_pipeline(rng):
    """tests/test_workflows.py:42's linear model on 64 synthetic images."""
    from imagetransformations_tpu_torch.pipeline.datasets import synthetic

    w = (rng.standard_normal((3072, 10)) * 0.02).astype(np.float32)
    imgs, labels = synthetic(n=64)
    tw = torch.from_numpy(w)
    want = jpipeline(lambda x: x.reshape(x.shape[0], -1) @ jnp.asarray(w),
                     lambda u8: u8.astype(jnp.float32) / 255.0, jnp.asarray(imgs),
                     jnp.asarray(labels), max_iters=3)
    got = pw.refinement_pipeline(lambda x: x.reshape(x.shape[0], -1) @ tw,
                                 lambda u8: u8.to(torch.float32) / 255.0, imgs, labels,
                                 max_iters=3, device="cpu")
    assert list(got) == list(want)
    close(got.pop("threshold"), want.pop("threshold"))
    assert got == pytest.approx(want, rel=1e-7)
    assert got["n_flagged"] > 0 and got["refine_iters"] >= 1


def test_refinement_pipeline_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is available")
    with pytest.raises(RuntimeError, match="refinement_pipeline runs on CUDA"):
        pw.refinement_pipeline(None, None, np.zeros((1, 32, 32, 3), np.uint8), np.zeros(1))
