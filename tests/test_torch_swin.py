"""The port's Swin Transformer (``models.swin``) against the benchmark's plain
reference (``benchmark/reference/imagenet_swin.py``: ``torch.roll``, window
partition and reverse, the mask by the paper's region slicing), CPU.

Two small networks on weights drawn by the benchmark's rule
(``benchmark/harness/inputs.weights``): a tiny one (C 16, window 2, 64²)
whose stages 1-3 shift by 1 and whose stage 4 is one 2x2 window (global
attention), and a thin one at the published window 7 and 224² whose stages
1-3 shift by 3 and whose stage 4 is one 7x7 window. Then the structure
(parameters only in the state dicts, Swin-B's parameter count, the masks
matter, torchvision's keys load), ODIN and the Mahalanobis score through
the tiny network against the reference's scores, and the spans."""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from imagetransformations_tpu_torch.models import SwinB, SwinTransformer, load_torch_state_dict
from imagetransformations_tpu_torch.models.imagenet import imagenet_model_space
from imagetransformations_tpu_torch.uq import mahalanobis, odin
from imagetransformations_tpu_torch.utils import profiling

sys.path.append(str(Path(__file__).resolve().parents[1] / "benchmark"))
from harness import inputs  # noqa: E402
from reference import imagenet_swin  # noqa: E402
from reference import uq as ruq  # noqa: E402

SEED = 2**31 + 2417
#: (name, configuration, images): tiny and thin
NETS = {
    "tiny": (dict(embed_dim=16, depths=[2, 2, 2, 2], heads=[1, 2, 4, 8], window=2, patch=4,
                  mlp_ratio=4, num_classes=10, image_size=64), 3),
    "thin": (dict(embed_dim=16, depths=[2, 2, 2, 2], heads=[1, 2, 4, 8], window=7, patch=4,
                  mlp_ratio=4, num_classes=10, image_size=224), 2),
}
#: f32 summation order: the port's data movement (one gather a shift and
#: partition) may let a library pick another reduction order; the
#: arithmetic is the same, so the gap is a few f32 roundings of the logits
TOL = 1e-5


def _pair(name: str):
    """(port, reference, model-space images) on the same drawn weights."""
    cfg, n = NETS[name]
    ref = imagenet_swin.build(cfg)
    w = inputs.weights(ref, SEED, "cpu")
    ref.load_state_dict(w)
    port = SwinTransformer(cfg["embed_dim"], cfg["depths"], cfg["heads"], cfg["window"],
                           cfg["num_classes"], device="cpu", image_size=cfg["image_size"])
    port.load_state_dict(w)
    x = imagenet_model_space(inputs.images(SEED, n, cfg["image_size"], "cpu"))
    return port.eval(), ref, x


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("name", list(NETS))
def test_port_equals_the_reference(name):
    port, ref, x = _pair(name)
    with torch.no_grad():
        f_ref, lg_ref = ref.features_and_logits(x)
        f, lg = port.features_and_logits(x)
        assert _gap(port(x), lg_ref) <= TOL
        assert torch.equal(port.features(x), f)
    assert lg.shape == (x.shape[0], 10) and f.shape == (x.shape[0], 128)
    assert _gap(lg, lg_ref) <= TOL
    assert _gap(f, f_ref) <= TOL


@pytest.mark.parametrize("name", list(NETS))
def test_a_bfloat16_reference_fails_the_tolerance(name):
    port, ref, x = _pair(name)
    with torch.no_grad():
        lg = port(x)
        lg_bf16 = ref.to(torch.bfloat16)(x.to(torch.bfloat16)).float()
    assert _gap(lg_bf16, lg) > 10 * TOL


@pytest.mark.parametrize("name", list(NETS))
def test_the_shift_masks_change_the_result(name):
    port, ref, x = _pair(name)
    masks = [b.mask for b in port.modules() if getattr(b, "mask", None) is not None]
    assert len(masks) == 3  # the odd block of stages 1-3; stage 4 is one window
    for m in masks:
        m.zero_()
    with torch.no_grad():
        assert _gap(port(x), ref(x)) > 10 * TOL


def test_state_dicts_hold_the_same_parameters_and_no_buffers():
    port, ref, _ = _pair("thin")
    keys = set(port.state_dict())
    assert keys == set(ref.state_dict())
    assert keys == {k for k, _ in port.named_parameters()}
    assert "fc.weight" in keys and "features.5.1.attn.relative_position_bias_table" in keys


def test_swin_b_counts_its_published_parameters():
    net = SwinB(device="meta")
    assert sum(p.numel() for p in net.parameters()) == 87_768_224
    blocks = [m for m in net.modules() if hasattr(m, "ids")]
    assert [b.ids["stage"] for b in blocks] == [1] * 2 + [2] * 2 + [3] * 18 + [4] * 2
    assert [b.shift for b in blocks] == [0, 3] * 11 + [0, 0]


def test_other_sizes_are_refused():
    port, _, x = _pair("tiny")
    with pytest.raises(ValueError, match="built for 64x64"):
        port(x[:, :, :32, :32])
    with pytest.raises(ValueError, match="whole number"):
        SwinTransformer(16, (2, 2, 2, 2), (1, 2, 4, 8), 7, 10, device="cpu", image_size=64)


def test_the_layers_keep_torchvision_names_beside_the_features_method():
    """``features(x)`` is the pooled-feature method of the port's models,
    and torchvision names Swin's layers ``features.*``: the list is that
    child, and the method still gives pooled features."""
    port, _, x = _pair("tiny")
    layers = dict(port.named_children())["features"]
    assert isinstance(layers, torch.nn.ModuleList) and len(layers) == 8
    assert [type(m).__name__ for m in layers[1:]] == ["ModuleList", "_PatchMerging"] * 3 + [
        "ModuleList"]
    with torch.no_grad():
        assert port.features(x).shape == (x.shape[0], 128)


def test_a_torchvision_state_dict_loads():
    """torchvision's names: ``head.*`` for the classifier and a persistent
    ``relative_position_index`` in every block."""
    port, _, x = _pair("tiny")
    tv = {("head." + k[3:] if k.startswith("fc.") else k): v.clone()
          for k, v in port.state_dict().items()}
    for k in [k for k in tv if k.endswith("relative_position_bias_table")]:
        tv[k.replace("bias_table", "index")] = torch.zeros(4, dtype=torch.int64)
    cfg, _ = NETS["tiny"]
    other = SwinTransformer(16, cfg["depths"], cfg["heads"], 2, 10, device="cpu",
                            image_size=64).eval()
    load_torch_state_dict(other, tv)
    with torch.no_grad():
        assert torch.equal(other(x), port(x))


def test_odin_and_mahalanobis_through_swin_match_the_reference():
    """ODIN's input gradient runs through the gathers, the bias table's
    gather and the masked softmax (the reference: ``torch.roll``)."""
    port, ref, x = _pair("tiny")
    got = odin.odin_uncertainty(port, x, 1000.0, 0.0014)
    want = ruq.odin_uncertainty(ref, x, 1000.0, 0.0014)
    assert torch.allclose(got, want, rtol=0.0, atol=1e-6)
    grads = []
    for net in (port, ref):  # the input gradient itself, which ODIN only takes the sign of
        leaf = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.logsumexp(net(leaf), dim=-1).sum(), leaf)
        grads.append(g)
    assert _gap(grads[0], grads[1]) <= TOL * float(grads[1].abs().max())
    many = imagenet_model_space(inputs.images(SEED + 1, 12, 64, "cpu"))
    with torch.no_grad():
        f = port.features(many)
        f_ref, _ = ref.features_and_logits(many)
    st = mahalanobis.fit(f)
    mean, prec = ruq.mahalanobis_fit(f_ref)
    # the same fit of the same features: equal to f32 rounding
    assert torch.allclose(mahalanobis.score(st, f), ruq.mahalanobis_score(mean, prec, f_ref),
                          rtol=1e-5, atol=1e-6)


def test_one_attention_span_a_block_and_no_host_read():
    port, _, x = _pair("tiny")
    profiling.reset()
    with torch.no_grad():
        port(x)  # outside a profiler: nothing recorded
    assert profiling.recorded()["spans"] == []
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        port(x)
    rec = profiling.recorded()
    spans = [s for s in rec["spans"] if s["name"] == "swin.attention"]
    assert len(spans) == len(rec["spans"]) == 8
    assert [(s["ids"]["stage"], s["ids"]["block"], s["ids"]["shifted"]) for s in spans] == [
        (1, 0, 0), (1, 1, 1), (2, 0, 0), (2, 1, 1), (3, 0, 0), (3, 1, 1), (4, 0, 0), (4, 1, 0)]
    assert rec["reads"] == []
    profiling.reset()
