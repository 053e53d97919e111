"""Whole runs on the CPU (the harness's look for a chip skipped, the plain
versions in the kernels' place, a few images): a sound run is correct, and a
run whose timed path is broken underneath is not, for each fault the cell
can have:

- a step that returns its state unchanged (a corruption or a transform
  that gives back its input);
- half of the batch left out (the accuracy the mean over half the images;
  a transform applied to half the images);
- a token or an answer altered where it is produced (one logit, one byte).

The exchange between chips does not exist in these one-chip cells. The
ImageNet sweep's faults run on the card: at the few images a CPU run holds,
its random network gets no corrupted image right, and an accuracy of 0 over
half the images is the accuracy over all of them."""

import time

import pytest
import torch

from harness import cell, spec

SEED = 2**31 + 977
CELLS = {  # cell -> images a CPU run holds
    "cifar10-resnet56.c10c": 24,
    "imagenet-resnet50.inc": 6,
    "cifar10-resnet56.augment": 32,
    "imagenet-resnet50.chain": 8,
}


def _run(name: str, device: str = "cpu", images: int | None = None) -> dict:
    r = cell.make_run(name, SEED, 0.05, False, time.perf_counter(), device=device,
                      images=images or CELLS[name])
    result, lines = cell.run_cell(r)
    print("\n".join(lines))
    return result


@pytest.mark.parametrize("name", list(CELLS))
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    # every end-to-end metric of the cell but those read from CUDA events
    want = {m["name"] for m in spec.end_to_end(spec.load(), name) if m["source"] == "host_clock"}
    assert set(res["metrics"]) == want and "setup_s" in want


def _sweep_faults(monkeypatch, fault):
    from imagetransformations_tpu_torch.evalx import harness
    from imagetransformations_tpu_torch.models import imagenet, resnet

    if fault == "unchanged":
        monkeypatch.setattr(harness, "corrupt", lambda x, *a, **k: x)
    elif fault == "half":
        orig = harness._error_aurocs

        def half(logits, labels, names):
            # the accuracy and the logit scores' AUROCs over the first half
            k = max(1, logits.shape[0] // 2)
            acc, _, aucs = orig(logits[:k], labels[:k], names)
            return acc, orig(logits, labels, names)[1], aucs

        monkeypatch.setattr(harness, "_error_aurocs", half)
    else:
        for cls in (resnet.CifarResNet, imagenet._ResNet):
            orig_fl = cls.features_and_logits if hasattr(cls, "features_and_logits") else None
            if orig_fl is not None:
                def fl(self, x, *a, _o=orig_fl, **k):
                    f, lg = _o(self, x, *a, **k)
                    return f, _altered(lg)

                monkeypatch.setattr(cls, "features_and_logits", fl)
            orig_fw = cls.forward

            def fw(self, x, *a, _o=orig_fw, **k):
                return _altered(_o(self, x, *a, **k))

            monkeypatch.setattr(cls, "forward", fw)


def _altered(lg: torch.Tensor) -> torch.Tensor:
    """One logit of the first image moved by 1% of the largest."""
    lg = lg.clone()
    lg[0, 0] += 0.01 * max(1.0, float(lg.abs().max()))
    return lg


def _transform_faults(monkeypatch, fault):
    from imagetransformations_tpu_torch.pipeline import batch, chain

    def half_of(fn):
        def wrapped(x, *a, **k):
            out = fn(x, *a, **k).clone()
            h = x.shape[0] // 2
            out[h:] = x[h:]  # the rest left as it came in
            return out
        return wrapped

    if fault == "unchanged":
        monkeypatch.setattr(batch, "_blur_grid", lambda images, idx, values: images)
        monkeypatch.setattr(chain, "fused_blur_rotate_image", lambda x, *a, **k: x)
    elif fault == "half":
        monkeypatch.setattr(batch, "shear_bicubic_batched", half_of(batch.shear_bicubic_batched))
        monkeypatch.setattr(chain, "fused_blur_rotate_image",
                            half_of(chain.fused_blur_rotate_image))
    else:
        orig_all, orig_mega = batch.apply_all_transformations, chain.fused_blur_rotate_image

        def flip(img):
            img = img.clone()
            img.view(-1)[0] ^= 1
            return img

        def all_altered(*a, **k):
            out = orig_all(*a, **k)
            v, img = out["contrast"]
            out["contrast"] = (v, flip(img))
            return out

        monkeypatch.setattr(batch, "apply_all_transformations", all_altered)
        monkeypatch.setattr(chain, "fused_blur_rotate_image",
                            lambda *a, **k: flip(orig_mega(*a, **k)))


FAULTS = ["unchanged", "half", "altered"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", [c for c in CELLS if not c.endswith(".inc")])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    if name.endswith(".c10c"):
        _sweep_faults(monkeypatch, fault)
    else:
        _transform_faults(monkeypatch, fault)
    res = _run(name)
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
def test_broken_imagenet_sweep_is_not_correct_on_the_card(cuda, monkeypatch, fault):
    _sweep_faults(monkeypatch, fault)
    res = _run("imagenet-resnet50.inc", device="cuda", images=512)
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name,images", [("cifar10-resnet56.augment", 512),
                                         ("imagenet-resnet50.chain", 64)])
def test_kernels_not_launched_is_not_correct(cuda, monkeypatch, name, images):
    """The cell's named kernels replaced by their plain versions: the output
    is the same, the launch counters do not move, and the run fails."""
    from imagetransformations_tpu_torch.ops import stencil
    from imagetransformations_tpu_torch.ops.hopper import megakernel, resample
    from imagetransformations_tpu_torch.pipeline import batch

    monkeypatch.setattr(megakernel, "luma_blur_rotate",
                        lambda x, *a, **k: megakernel.luma_blur_rotate_plain(x, *a))
    monkeypatch.setattr(megakernel, "rgb_blur_rotate",
                        lambda x, *a, slopes=None, **k: megakernel.rgb_blur_rotate_plain(x, *a, **k))
    monkeypatch.setattr(resample, "shear_bicubic", resample.shear_bicubic_plain)
    monkeypatch.setattr(batch, "blur_separable_batched",
                        lambda img, radii, taps=None: stencil.blur_batched_plain(img, radii, taps))
    r = cell.make_run(name, SEED, 0.5, False, time.perf_counter(), device="cuda", images=images)
    res, lines = cell.run_cell(r)
    print("\n".join(lines))
    assert res["checks"]["max_lsb"]["value"] == 0
    assert res["correct"] is False
