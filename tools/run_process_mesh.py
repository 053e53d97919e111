#!/usr/bin/env python3
"""The ranks' entry point of the port's process mesh: every rank of a
``torch.distributed`` group runs the mesh paths on its shard and writes
what it got, which the caller holds to the one-device run.

    python -m torch.distributed.run --standalone --nproc-per-node=4 \\
        tools/run_process_mesh.py --device=cpu [--inputs=FILE] [--out=DIR]

``--device=cuda`` (the default) puts rank r on ``cuda:{LOCAL_RANK %
device_count}``; the backend follows (``core.mesh``: gloo for
ranks that share a card). ``--tf32=on|off`` sets the caller's TF32 flags
(and cuDNN's deterministic one) in each rank; otherwise PyTorch's defaults
hold. With ``--start-file=PATH`` each rank, once started, writes
``PATH.rank{r}`` and waits for PATH to exist before the timed runs. The
workload is ``--inputs`` (a file of ``make_inputs``), or
``make_inputs("small")``. A CPU rank runs one torch thread. Rank 0 builds the
CUDA kernels (a no-op where the caller built them) before any rank loads
them. Each rank runs ``run_all`` and, with ``--out``, writes its results
(arrays, the kernels' launch counts, ms a run) to ``DIR/rank{r}.pt``; rank 0
prints one JSON line a run (ms, the backend). The runs: the file slice,
the global batch, ``psum_mean`` / ``sharded_accuracy``, ``sharded_chain_fn``
(static and per-image angles, gray and RGB), ``sharded_gaussian_blur``,
``evaluate_sharded``, the sweep's cells, ``make_train_step`` (SGD with
momentum), ``adversarial_train_step``, TENT steps and ``evaluate_with_tent``,
SWAG's ``bma_logits`` and ``fgsm_attack``. ``run_all(inputs, None, device)``
runs the same workload on one device. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

STARTED = time.time()  # before torch is imported: a rank's start-up is part of its wall time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: the workload's sizes: "small" for a group of CPU ranks, "full" for the
#: card (the shapes of chip_smoke.py's phase sharding)
SIZES = {
    "small": dict(chain=(8, 40, 48), blur=(2, 64, 48), blocks=(1, 1, 1), images=64,
                  train=32, steps=2, adv_steps=1, tent=(2, 32), tent_steps=2, bma=32, fgsm=32),
    "full": dict(chain=(32, 512, 512), blur=(32, 512, 512), blocks=(3, 3, 3), images=10000,
                 train=256, steps=4, adv_steps=2, tent=(4, 256), tent_steps=1, bma=256,
                 fgsm=256),
}
SWEEP_CELLS = (("gaussian_noise", 3), ("contrast", 3), ("rotation", 3))
BLUR_RADIUS, ANGLE, BAND = 1.5, 12.5, 4.5
TRAIN_LR, ADV_EPS, TENT_LR, FGSM_EPS, SWAG_SAMPLES = 0.01, 8.0 / 255, 1e-3, 0.03, 3
START_WAIT_S = 600
CHAINS = ("luma_blur_rotate", "luma_blur_rotate_traced", "rgb_blur_rotate",
          "rgb_blur_rotate_traced")


def make_inputs(size: str, seed: int = 0, world: int = 4, model_state=None, data=None) -> dict:
    """The workload: numpy draws from ``seed``; the model's state (default: a
    seeded ``CifarResNet`` of the size's blocks) and the 32x32 set
    ``data = (u8 NHWC, labels)`` (default: ``datasets.synthetic``) as
    given. The training steps take the set's labels and, at "full", its
    first images in model space; at "small", which the CPU test holds to
    JAX, standard normal inputs in model space (on the normalized images
    the training BatchNorm's gradient cancels where a channel's mean is
    large, and the port's and JAX's first convolution's gradients part by
    2e-3 of their largest entry, on one device as on the mesh). The
    per-image angles lie in -22.5..22.5 but for rank 0's shard, within 4.5
    degrees (a lower band, so its chain runs on the batch's budget)."""
    from imagetransformations_tpu_torch.models.resnet import CifarResNet
    from imagetransformations_tpu_torch.pipeline.datasets import synthetic

    sz = SIZES[size]
    rng = np.random.default_rng([seed, 18])
    n, h, w = sz["chain"]
    angles = rng.uniform(-22.5, 22.5, n).astype(np.float32)
    angles[: n // world] = rng.uniform(-BAND, BAND, n // world)
    angles[-1] = 22.5
    if model_state is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model_state = CifarResNet(sz["blocks"], device="cpu").state_dict()
    if data is None:
        data = synthetic(sz["images"], seed=seed)
    return {
        "size": size, "seed": seed, "world": world,
        "files": [f"img{i:03d}.png" for i in range(4 * world + 2)],
        "host_rows": rng.integers(0, 256, (2 * world, 8, 8, 3), dtype=np.uint8),
        "psum": {"values": rng.standard_normal(8 * world).astype(np.float32),
                 "logits": rng.standard_normal((8 * world, 10)).astype(np.float32),
                 "labels": rng.integers(0, 10, 8 * world)},
        "chain_images": rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8),
        "angles": angles,
        "blur_images": rng.integers(0, 256, (*sz["blur"], 3), dtype=np.uint8),
        "blocks": sz["blocks"], "model_state": model_state,
        "images": np.asarray(data[0]), "labels": np.asarray(data[1]),
        "train_x": (model_space(np.asarray(data[0])[: sz["train"]]).numpy() if size == "full"
                    else rng.standard_normal((sz["train"], 3, 32, 32)).astype(np.float32)),
        "sweep_cells": SWEEP_CELLS,
    }


def chain_specs(inputs: dict) -> dict:
    """The four chains of ``CHAINS``, by the kernel each routes to."""
    from imagetransformations_tpu_torch.pipeline.chain import OpSpec

    blur = OpSpec("blur", {"radius": BLUR_RADIUS})
    static, traced = OpSpec("rotation", {"angle": ANGLE}), OpSpec("rotation",
                                                                  {"angle": inputs["angles"]})
    return dict(zip(CHAINS, ([blur, static, OpSpec("grayscale")],
                             [blur, traced, OpSpec("grayscale")], [blur, static],
                             [blur, traced])))


def model_space(u8) -> torch.Tensor:
    """The CIFAR nets' NCHW f32 input of u8 NHWC images, contiguous."""
    from imagetransformations_tpu_torch.models.resnet import cifar_model_space

    return cifar_model_space(torch.as_tensor(u8)).contiguous()


def jittered_swag_state(model):
    """A SWAG state of 4 collections at the model's weights scaled by 1.01
    .. 1.04 (3 deviations kept), so that its samples spread."""
    from imagetransformations_tpu_torch.uq import swag

    base = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = swag.init(base, max_rank=3)
    for i in range(4):
        swag.update(state, {k: v * (1.0 + 0.01 * (i + 1)) for k, v in base.items()})
    return state


class _Clock:
    """ms of each run (host clock around work ended by a synchronize) and
    the kernels' launches during it (``_lib.LAUNCHES``, zeroed before)."""

    def __init__(self, device: torch.device):
        from imagetransformations_tpu_torch.ops.hopper import _lib

        self.cuda, self.launches = device.type == "cuda", _lib.LAUNCHES
        self.ms: dict[str, float] = {}
        self.counts: dict[str, dict] = {}

    def run(self, name: str, fn):
        for k in self.launches:
            self.launches[k] = 0
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if self.cuda:
            torch.cuda.synchronize()
        self.ms[name] = (time.perf_counter() - t0) * 1e3
        self.counts[name] = {k: v for k, v in self.launches.items() if v}
        return out


def _host(t):
    if isinstance(t, dict):
        return {k: _host(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_host(v) for v in t)
    return t.detach().cpu() if isinstance(t, torch.Tensor) else t


def run_all(inputs: dict, mesh=None, device=None) -> dict:
    """Every run of the workload on ``mesh`` (a ``ProcessMesh``: this rank's
    shard of each), or, with ``mesh`` None, on the one ``device``. Returns
    ``{"out": {run: result on the host}, "ms": {run: ms}, "launches": {run:
    counts}, "marks": {block: seconds to its end}}``; a gathered result is
    the whole array on every rank, the chains' and the blur's outputs are
    this rank's shard (batch rows, image rows)."""
    from imagetransformations_tpu_torch.adapt import tent
    from imagetransformations_tpu_torch.attacks.fgsm import fgsm_attack
    from imagetransformations_tpu_torch.evalx import harness as hs
    from imagetransformations_tpu_torch.models.resnet import CifarResNet, cifar_model_space
    from imagetransformations_tpu_torch.ops.sharded_stencil import sharded_gaussian_blur
    from imagetransformations_tpu_torch.ops.stencil import gaussian_blur
    from imagetransformations_tpu_torch.pipeline import io, sharding as shd
    from imagetransformations_tpu_torch.pipeline.chain import build_chain_fn
    from imagetransformations_tpu_torch.uq import swag

    dev = mesh.device if mesh is not None else torch.device(device)
    sz = SIZES[inputs["size"]]
    clock = _Clock(dev)
    out: dict = {}
    t_all, marks = time.perf_counter(), {}  # seconds from the start to each block's end

    def put(x):
        """The global array as this run takes it: sharded over the mesh, or
        whole on the device."""
        return shd.shard_images(x, mesh) if mesh is not None else torch.as_tensor(x).to(dev)

    def whole(x):
        return x.gather() if isinstance(x, shd.ShardedBatch) else x

    def own(x):
        return x.shards[0] if isinstance(x, shd.ShardedBatch) else x

    # the input layer: each rank's file slice and its rows of a global batch
    out["files"] = io.shard_files_for_host(inputs["files"])
    if mesh is not None:
        k = len(inputs["host_rows"]) // mesh.size
        local = inputs["host_rows"][mesh.rank * k: (mesh.rank + 1) * k]
        out["global_batch"] = io.global_batch_from_host_shards(local, mesh).gather()
        ps = inputs["psum"]
        out["psum_mean"] = shd.psum_mean(put(ps["values"]))
        out["sharded_accuracy"] = shd.sharded_accuracy(ps["logits"], ps["labels"], mesh)

    # the transforms: the chains (#1, #3, #4, #5) and the halo blur (#6)
    x = inputs["chain_images"]
    for kernel, chain in chain_specs(inputs).items():
        fn = (shd.sharded_chain_fn(chain, mesh) if mesh is not None
              else build_chain_fn(chain, device=dev))
        xd = put(x)
        fn(xd)  # warm-up
        out[kernel] = own(clock.run(kernel, lambda: fn(xd)))
    xb = inputs["blur_images"]
    if mesh is None:
        xb = torch.as_tensor(xb).to(dev)
    blur = ((lambda: sharded_gaussian_blur(xb, BLUR_RADIUS, mesh)) if mesh is not None
            else (lambda: gaussian_blur(xb, BLUR_RADIUS)))
    blur()
    out["blur"] = own(clock.run("blur", blur))

    marks["transforms"] = time.perf_counter() - t_all
    # evaluation: evaluate_sharded and the sweep's cells (#12 in rotation)
    # one device forwards batches of a shard's size, as each rank does
    model = CifarResNet(inputs["blocks"], device=dev)
    model.load_state_dict(inputs["model_state"])
    imgs, labels = inputs["images"], inputs["labels"]
    shard = len(imgs) // inputs["world"]
    evaluate = ((lambda: hs.evaluate_sharded(model, cifar_model_space, imgs, labels, mesh))
                if mesh is not None else
                (lambda: hs.evaluate_batched(model, cifar_model_space, imgs, labels,
                                             batch_size=shard, device=dev)))
    evaluate()
    res = clock.run("evaluate", evaluate)
    out["evaluate"] = {"logits": res["logits"], "accuracy": res["accuracy"]}
    for name, sev in inputs["sweep_cells"]:
        def cell():
            return hs.corruption_sweep(model, cifar_model_space, imgs, labels, mesh=mesh,
                                       seed=inputs["seed"], corruption_names=(name,),
                                       severities=(sev,), batch_size=shard,
                                       device=dev)[name][sev]
        cell()
        out[f"sweep {name} {sev}"] = clock.run(f"sweep {name} {sev}", cell)

    marks["evaluation"] = time.perf_counter() - t_all
    # SWAG's model average and FGSM, evaluation mode. The samples are drawn
    # from a generator seeded by rank: bma_logits takes rank 0's
    rank = mesh.rank if mesh is not None else 0
    nb = sz["bma"]
    gen = torch.Generator(device=dev).manual_seed(inputs["seed"] + rank)
    stacked = swag.sample_many(jittered_swag_state(model), SWAG_SAMPLES, gen)
    out["bma_samples"] = stacked
    xm = model_space(imgs[:nb]).to(dev)
    out["bma"] = clock.run("bma", lambda: swag.bma_logits(model, stacked, put(xm)))
    nf = sz["fgsm"]
    xf, yf = model_space(imgs[:nf]).to(dev), torch.as_tensor(labels[:nf]).to(dev)
    out["fgsm"] = whole(clock.run("fgsm", lambda: fgsm_attack(model, put(xf), yf, FGSM_EPS,
                                                              -3.0, 3.0)))

    marks["swag_fgsm"] = time.perf_counter() - t_all
    # TENT: the continuous protocol's first steps, then evaluate_with_tent
    n_b, b = sz["tent"]
    batches = [model_space(imgs[i * b: (i + 1) * b]).to(dev) for i in range(n_b)]
    ybs = [torch.as_tensor(labels[i * b: (i + 1) * b]).to(dev) for i in range(n_b)]
    state, tx = tent.init_tent(model, TENT_LR)
    step = tent.make_tent_step(model, tx)
    logits, bn = [], []

    def tent_steps():
        nonlocal state
        for xt in batches[: sz["tent_steps"]]:
            state, lg = step(state, put(xt))
            logits.append(whole(lg))
            bn.append(state.bn_params)

    clock.run("tent_steps", tent_steps)
    out["tent_steps"] = {"logits": logits, "bn": bn}
    out["tent_accuracy"] = clock.run("tent_accuracy", lambda: tent.evaluate_with_tent(
        model, [put(xt) for xt in batches], [put(y) for y in ybs], TENT_LR, "continuous",
        device=dev))

    marks["tent"] = time.perf_counter() - t_all
    out.update(train_runs(inputs, mesh, dev, clock=clock))
    marks["train"] = time.perf_counter() - t_all
    return {"out": _host(out), "ms": clock.ms, "launches": clock.counts, "marks": marks}


def train_runs(inputs: dict, mesh=None, device=None, dtype=torch.float32, clock=None) -> dict:
    """``make_train_step`` (SGD with momentum: a linear map of the
    gradients) over ``SIZES[size]["steps"]`` steps and
    ``adversarial_train_step`` over ``"adv_steps"``, each from the inputs'
    weights, on ``mesh`` or the one ``device``, the model and the inputs in
    ``dtype`` (f64 gives the floor that f32 rounding itself sets). Returns
    {"train": losses and accuracies, the first step's gradients and
    buffers, the last parameters; "adv_train": losses, parameters}."""
    from imagetransformations_tpu_torch.attacks.fgsm import adversarial_train_step
    from imagetransformations_tpu_torch.models.resnet import CifarResNet
    from imagetransformations_tpu_torch.models.training import make_train_step
    from imagetransformations_tpu_torch.pipeline import sharding as shd

    dev = mesh.device if mesh is not None else torch.device(device)
    sz = SIZES[inputs["size"]]
    clock = clock or _Clock(dev)

    def put(x):
        return shd.shard_images(x, mesh) if mesh is not None else x

    def fresh():
        model = CifarResNet(inputs["blocks"], device=dev)
        model.load_state_dict(inputs["model_state"])
        return model.to(dtype)

    xt = torch.as_tensor(inputs["train_x"]).to(dev, dtype)
    yt = torch.as_tensor(inputs["labels"][: len(xt)]).to(dev)
    net = fresh()
    train = make_train_step(net, torch.optim.SGD(net.parameters(), lr=TRAIN_LR, momentum=0.9))
    losses, first = [], {}

    def train_steps():
        for i in range(sz["steps"]):
            losses.append(train(put(xt), put(yt)))
            if i == 0:
                first["grads"] = {k: p.grad.clone() for k, p in net.named_parameters()}
                first["buffers"] = {k: v.clone() for k, v in net.named_buffers()}

    clock.run("train", train_steps)
    out = {"train": {"loss_acc": losses, **first, "params": dict(net.named_parameters())}}
    net = fresh()
    opt = torch.optim.SGD(net.parameters(), lr=TRAIN_LR, momentum=0.9)
    adv = clock.run("adv_train", lambda: [adversarial_train_step(net, opt, put(xt), put(yt),
                                                                  ADV_EPS)
                                           for _ in range(sz["adv_steps"])])
    out["adv_train"] = {"loss": adv, "params": dict(net.named_parameters())}
    return _host(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--start-file", default=None,
                    help="once ready, write FILE.rank{r} and wait until FILE exists before "
                         "the timed runs (a caller sharing the card starts them when it is "
                         "free)")
    ap.add_argument("--tf32", choices=("on", "off"), default=None,
                    help="the caller's TF32 flags (cuBLAS and cuDNN), with cuDNN "
                         "deterministic, so that only TF32 could tell two runs apart")
    args = ap.parse_args(argv)
    if args.tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32 = args.tf32 == "on"
        torch.backends.cudnn.allow_tf32 = args.tf32 == "on"
        torch.backends.cudnn.deterministic = True

    import torch.distributed as dist

    from imagetransformations_tpu_torch.pipeline.sharding import init_process_mesh

    t0 = time.perf_counter()
    mesh = init_process_mesh(args.device)
    stages = {"started": STARTED, "imported_s": time.time() - STARTED,
              "init_s": time.perf_counter() - t0}
    try:
        if mesh.device.type == "cpu":
            torch.set_num_threads(1)
        else:
            from imagetransformations_tpu_torch.ops.hopper import _lib

            if mesh.rank == 0:
                _lib.build_all()
            dist.barrier()
            for name in _lib.SIGNATURES:
                _lib.load(name)
        stages["load_kernels_s"] = time.perf_counter() - t0
        inputs = (torch.load(args.inputs, weights_only=False) if args.inputs
                  else make_inputs("small", 0, mesh.size))
        stages["inputs_s"] = time.perf_counter() - t0
        # PyTorch's first optimizer step imports torch._dynamo (seconds): a
        # throwaway step here keeps that out of the timed training runs
        w = torch.zeros(1, device=mesh.device, requires_grad=True)
        w.grad = torch.zeros_like(w)
        torch.optim.SGD([w], lr=0.0, momentum=0.9).step()
        if args.start_file:
            with open(f"{args.start_file}.rank{mesh.rank}", "w"):
                pass
            deadline = time.time() + START_WAIT_S
            while not os.path.exists(args.start_file):
                if time.time() > deadline:
                    raise TimeoutError(f"{args.start_file} did not appear in {START_WAIT_S} s")
                time.sleep(0.05)
        stages["ready_s"] = time.perf_counter() - t0
        if inputs["world"] != mesh.size:
            raise ValueError(f"the inputs are for {inputs['world']} ranks, the group has "
                             f"{mesh.size}")
        res = run_all(inputs, mesh)
        stages["runs_s"] = time.perf_counter() - t0
        res.update(rank=mesh.rank, world=mesh.size, backend=mesh.backend,
                   device=str(mesh.device), stages=stages)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            torch.save(res, os.path.join(args.out, f"rank{mesh.rank}.pt"))
        if mesh.rank == 0:
            for run, ms in res["ms"].items():
                print(json.dumps({"run": run, "ms": ms, "launches": res["launches"][run],
                                  "ranks": mesh.size, "backend": mesh.backend,
                                  "device": str(mesh.device)}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
