"""The reference against the port's CPU path (its plain versions) at small
sizes, entry by entry, on the same inputs: every corruption at every
severity, the networks, ODIN, the Mahalanobis distance and the AUROC, the
8-type sweep with its draws replayed, and the chain."""

import pytest
import torch

from harness import inputs, spec
from reference import cifar_resnet, imagenet_resnet
from reference import sweep as rsweep
from reference import transforms as rt
from reference import uq as ruq

S = spec.load()
ORDER = spec.traffic("c10c")["corruptions"]


@pytest.mark.parametrize("name", ORDER)
@pytest.mark.parametrize("size", [32, 40])
def test_corruptions_equal_the_port(name, size):
    from imagetransformations_tpu_torch.evalx import harness

    x = inputs.images(11, 3, size, "cpu")
    for sev in range(1, 6):
        d = inputs.cell_draws(11, sev, name, sev, x)
        want = harness.corrupt(x, name, sev, None, **d)
        got = rsweep.corrupt(x, name, sev, d)
        assert torch.equal(got, want), (name, sev)


@pytest.mark.parametrize("cfg_name,module,port,size", [
    ("cifar10-resnet56", cifar_resnet, "imagetransformations_tpu_torch.models.resnet:resnet56", 32),
    ("imagenet-resnet50", imagenet_resnet, "imagetransformations_tpu_torch.models.imagenet:ResNet50",
     64),
])
def test_networks_equal_the_port(cfg_name, module, port, size):
    from harness.sweep_kind import _attr

    cfg = spec.config(S, cfg_name)
    net = module.build(cfg)
    w = inputs.weights(net, 5, "cpu")
    net.load_state_dict(w, strict=False)
    pnet = _attr(port)(num_classes=cfg["num_classes"], device="cpu")
    pnet.load_state_dict(w, strict=False)
    pnet.eval()
    x = rsweep.model_space(inputs.images(5, 2, size, "cpu"), cfg["model_space"])
    to_space = _attr(cfg["port_model_space"])
    assert torch.equal(to_space(inputs.images(5, 2, size, "cpu")), x)
    with torch.no_grad():
        f, lg = net.features_and_logits(x)
        assert torch.allclose(lg, pnet(x), rtol=1e-5, atol=1e-5)
        assert torch.allclose(f, pnet.features(x), rtol=1e-5, atol=1e-5)


def test_scores_equal_the_port():
    from imagetransformations_tpu_torch.uq import mahalanobis, metrics, odin
    from imagetransformations_tpu_torch.uq.calibration import auroc

    cfg = spec.config(S, "cifar10-resnet56")
    net = cifar_resnet.build(dict(cfg, depth=8))
    net.load_state_dict(inputs.weights(net, 3, "cpu"), strict=False)
    x = rsweep.model_space(inputs.images(3, 16, 32, "cpu"), "cifar")
    assert torch.equal(ruq.odin_uncertainty(net, x, 1000.0, 0.0014),
                       odin.odin_uncertainty(net, x, 1000.0, 0.0014))
    with torch.no_grad():
        f, lg = net.features_and_logits(x)
    mean, prec = ruq.mahalanobis_fit(f)
    st = mahalanobis.fit(f)
    assert torch.allclose(prec, st.precision, rtol=1e-6, atol=1e-6)
    assert torch.allclose(ruq.mahalanobis_score(mean, prec, f), mahalanobis.score(st, f))
    for m in ruq.METRICS:
        assert torch.equal(ruq.METRICS[m](lg), metrics.LOGIT_METRICS[m](lg)), m
    t = (torch.arange(16) % 3 == 0).float()
    s = torch.tensor([0.1, 0.1, 0.3, 0.2] * 4)
    assert ruq.auroc(s, t) == float(auroc(s, t))


def test_sweep_cell_equals_the_port():
    """One whole cell with ODIN and Mahalanobis through the port's
    ``corruption_sweep`` and through ``reference.sweep.evaluate_cell``."""
    from imagetransformations_tpu_torch.evalx import harness
    from imagetransformations_tpu_torch.models.resnet import cifar_model_space, resnet20

    cfg = dict(spec.config(S, "cifar10-resnet56"), depth=20)
    net = cifar_resnet.build(cfg)
    x = inputs.images(9, 24, 32, "cpu")
    w = inputs.weights(net, 9, "cpu")
    net.load_state_dict(w, strict=False)
    feats, _ = rsweep.features_and_logits(net, x, "cifar", 8)
    w = inputs.standardize_head(w, feats)
    net.load_state_dict(w, strict=False)
    pnet = resnet20(device="cpu")
    pnet.load_state_dict(w, strict=False)
    pnet.eval()
    y = inputs.labels(9, rsweep.features_and_logits(net, x, "cifar", 8)[1], 0.9)
    maha = ruq.mahalanobis_fit(feats)
    for i in (4, 9, 12):
        name, sev = inputs.sweep_cell(ORDER, i)
        d = inputs.cell_draws(9, i, name, sev, x)
        port = harness.corruption_sweep(
            pnet, cifar_model_space, x, y, corruption_names=(name,), severities=(sev,),
            batch_size=8, uq_extras={"feats_logits_fn": pnet.features_and_logits,
                                     "maha_mean": maha[0], "maha_precision": maha[1]},
            cell_draws=lambda nm, sv: d, device="cpu")[name][sev]
        ref = rsweep.evaluate_cell(net, x, y, name, sev, d, space="cifar", batch=8,
                                   metrics=("shannon_entropy", "msp", "margin", "energy"),
                                   odin=(1000.0, 0.0014), maha=maha)
        assert port["accuracy"] == ref["accuracy"]
        assert port["auroc"] == pytest.approx(ref["auroc"], abs=1e-6)


def test_apply_all_equals_the_port():
    from imagetransformations_tpu_torch.pipeline.batch import apply_all_transformations

    x = inputs.images(4, 12, 32, "cpu")
    g_port, g_ref = (inputs.generator(4, "cpu", "calls") for _ in range(2))
    for _ in range(3):  # the draws of later calls follow from the earlier ones
        port = apply_all_transformations(x, g_port, device="cpu")
        ref = rt.apply_all(x, rt.sweep_draws(g_ref, tuple(x.shape)))
        for t in rt.TYPES:
            assert torch.equal(port[t][1], ref[t]), t


def test_chain_equals_the_port():
    from imagetransformations_tpu_torch.pipeline.chain import OpSpec, build_chain_fn

    ops = spec.traffic("chain")["ops"]
    fn = build_chain_fn([OpSpec(o["name"], o.get("params", {})) for o in ops], device="cpu")
    x = inputs.images(6, 3, 48, "cpu")
    assert torch.equal(fn(x), rt.blur_rotate_gray(x, 1.5, 15.0))
