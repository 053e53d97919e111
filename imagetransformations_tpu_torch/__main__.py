"""CLI entry point: ``python -m imagetransformations_tpu_torch <command>``.

The port's counterpart of ``python -m imagetransformations_tpu``; the
reference ships ~100 standalone ``python <script>.py`` entry points with
hardcoded constants (SURVEY.md §5 'Config / flag system: none'). Commands:

- ``transform IN_DIR OUT_DIR [--size=WxH] [--seed=N] [--device=cuda|cpu]
  [--stats]`` — transformation.py __main__: the 8-type random-grid sweep
  over a folder.
- ``chain IN_DIR OUT_DIR --ops blur:1.5,rotation:15,grayscale [--size=WxH]
  [--strict-parity] [--fast-compile] [--seed=N] [--device=cuda|cpu]
  [--stats]`` — apply a declarative op-chain (fused kernels where it
  matches) to a folder.
- ``corrupt IN_DIR OUT_DIR [--corruptions=a,b] [--severities=1,3,5]
  [--size=WxH] [--seed=N] [--device=cuda|cpu] [--stats]`` — a
  CIFAR-10-C-style store from a folder: one PNG per (input, corruption,
  severity), ``{stem}_{name}_severity{sev}.png``; by default the store's 19
  corruptions at severities 1-5.

Every command runs on the card (``--device=cuda``, the default; it fails
without one) unless ``--device=cpu`` asks for the plain PyTorch versions.
With ``--size`` the images are decoded and encoded by the multithreaded C++
codec (``pipeline.native_io``) where it builds, else by PIL. ``--stats``
prints the run's stage seconds (decode, host-to-device copy, compute,
device-to-host copy, encode) as one JSON line. ``--seed`` seeds the
``torch.Generator`` that draws the sweep's values and feeds noise ops; in
``corrupt`` each (corruption, severity) cell has a generator of its own
from it (``workflows.corruption_generator``).

- ``sweep [--data-root=DIR] [--severities=N] [--batch-size=B]
  [--metrics=a,b] [--out-dir=DIR] [--seed=N] [--device=cuda|cpu] [--stats]
  [--data-parallel=true [--mesh-slots=N]]``
  — FINAL_cifar_corrupted.py: the demo ResNet-20 (``utils.demo``: CIFAR-10
  pickles under ``--data-root``, else synthetic data) through the 15
  canonical corruptions at severities 1..N (``evalx.corruption_sweep``, a
  generator a cell from ``--seed``); prints the accuracy / AUROC table and
  writes it as ``sweep.json`` and, with matplotlib, ``auc_{metric}.png`` to
  ``--out-dir``. ``--data-parallel=true`` runs each cell's forward over a
  one-process device mesh (``pipeline.sharding``): one slot a visible CUDA
  device, or ``--mesh-slots=N`` slots on the one ``--device``
  (``--device=cpu --mesh-slots=4`` included); with more than one slot it
  prints "data-parallel sweep over N devices", as the JAX CLI does. Under
  ``python -m torch.distributed.run --nproc-per-node=N`` (``WORLD_SIZE`` >
  1) and without ``--mesh-slots`` the mesh is the ranks'
  (``pipeline.sharding.init_process_mesh``): each rank on its ``--device`` (``cuda`` is
  ``cuda:{LOCAL_RANK % device_count}``), rank 0 alone printing and writing.
- ``report [--data-root=DIR] [--out-dir=DIR] [--seed=N] [--device=cuda|cpu]
  [--stats]`` — the demo model's uncertainty report
  (``workflows.uncertainty_report``): accuracy, each metric's AUROC and
  Youden threshold, histograms in ``--out-dir`` (with matplotlib).

Where matplotlib is missing the commands say that no PNG was written.
``--stats`` prints the stage seconds (``train_s``, ``sweep_s`` or
``report_s``) as one JSON line, last.
"""

from __future__ import annotations

import json
import os
import sys

#: default parameter key per op name, so ``blur:1.5`` parses without
#: spelling ``radius`` (full spellings like ``blur:radius=1.5`` also work)
_OP_PARAM = {
    "blur": "radius",
    "rotation": "angle",
    "brightness": "factor",
    "lighten_darken": "factor",
    "contrast": "alpha",
    "enhance_contrast": "factor",
    "enhance_color": "factor",
    "sharpness": "factor",
    "motion_blur": "ksize",
    "gaussian_noise": "std",
    "impulse_noise": "amount",
    "shot_noise": "lam",
    "translation": "tx",
    "zoom": "factor",
    "scale": "factor",
    "shear": "factor",
}
_NO_PARAM_OPS = {"grayscale", "invert", "histogram_equalization", "flip_vertical"}

def parse_ops(spec: str):
    """``"blur:1.5,rotation:15,grayscale"`` -> list[OpSpec]."""
    from imagetransformations_tpu_torch.pipeline.chain import OpSpec

    chain = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition(":")
        if name in _NO_PARAM_OPS:
            chain.append(OpSpec(name))
            continue
        if name not in _OP_PARAM:
            raise SystemExit(
                f"unknown op {name!r}; known: "
                f"{sorted(_OP_PARAM) + sorted(_NO_PARAM_OPS)}"
            )
        if not val:
            raise SystemExit(f"op {name!r} needs a value, e.g. {name}:1.5")
        key, _, kv = val.partition("=")
        if kv:  # explicit param name: blur:radius=1.5
            chain.append(OpSpec(name, {key: float(kv)}))
        else:
            p = float(val)
            chain.append(
                OpSpec(name, {_OP_PARAM[name]: int(p) if name == "motion_blur" else p})
            )
    if not chain:
        raise SystemExit("--ops parsed to an empty chain")
    return chain


def _parse_size(argv) -> tuple[int, int] | None:
    for a in argv:
        if a.startswith("--size="):
            w, _, h = a.split("=", 1)[1].partition("x")
            return (int(w), int(h or w))
    return None


def _option(argv, name: str, default: str) -> str:
    """The value of ``--name=value`` in ``argv``, else ``default``."""
    return next((a.split("=", 1)[1] for a in argv if a.startswith(f"--{name}=")), default)


def _positional(argv, n: int, usage: str):
    pos = [a for a in argv if not a.startswith("--")]
    if len(pos) < n:
        raise SystemExit(f"usage: python -m imagetransformations_tpu_torch {usage}")
    return pos


def _generator(argv, device: str):
    import torch

    return torch.Generator(device=device).manual_seed(int(_option(argv, "seed", "0")))


def _print_stats(argv, stats: dict) -> None:
    """With ``--stats``: the run's stage seconds as one JSON line."""
    if "--stats" in argv:
        print(json.dumps(stats), flush=True)


def cmd_transform(argv):
    from imagetransformations_tpu_torch.workflows import transform_folder

    in_dir, out_dir = _positional(
        argv, 2, "transform IN_DIR OUT_DIR [--size=WxH] [--seed=N] [--device=cuda|cpu] "
        "[--stats]")[:2]
    device = _option(argv, "device", "cuda")
    stats = {}
    written = transform_folder(in_dir, out_dir, generator=_generator(argv, device),
                               size=_parse_size(argv), device=device, stats=stats)
    n = sum(len(v) for v in written.values())
    print(f"wrote {n} transformed images ({len(written)} transform types) to {out_dir}")
    _print_stats(argv, stats)


def cmd_chain(argv):
    from imagetransformations_tpu_torch.workflows import chain_folder

    spec = None
    argv = list(argv)
    for i, a in enumerate(argv):
        if a.startswith("--ops="):
            spec = a.split("=", 1)[1]
        elif a == "--ops" and i + 1 < len(argv):
            spec = argv[i + 1]
            argv[i + 1] = "--"  # consumed: don't parse the value as a positional
    argv = [a for a in argv if a != "--"]
    in_dir, out_dir = _positional(
        argv, 2,
        "chain IN_DIR OUT_DIR --ops OP:V,... [--size=WxH] [--strict-parity] [--fast-compile] "
        "[--seed=N] [--device=cuda|cpu] [--stats]",
    )[:2]
    if spec is None:
        raise SystemExit("chain requires --ops, e.g. --ops=blur:1.5,rotation:15,grayscale")
    chain = parse_ops(spec)
    device = _option(argv, "device", "cuda")
    stats = {}
    written = chain_folder(in_dir, out_dir, chain,
                           strict_parity=any(a == "--strict-parity" for a in argv),
                           fast_compile=any(a == "--fast-compile" for a in argv),
                           generator=_generator(argv, device), size=_parse_size(argv),
                           device=device, stats=stats)
    if not written:
        raise SystemExit(f"no images found under {in_dir}")
    print(f"applied {len(chain)} ops to {len(written)} images -> {out_dir}")
    _print_stats(argv, stats)


def cmd_corrupt(argv):
    """A CIFAR-10-C-style corrupted store from a folder of images: one PNG
    per (input, corruption, severity)."""
    from imagetransformations_tpu_torch.evalx.harness import CORRUPTIONS, EXTRA_CORRUPTIONS
    from imagetransformations_tpu_torch.workflows import STORE_CORRUPTIONS, corrupt_folder

    in_dir, out_dir = _positional(
        argv, 2,
        "corrupt IN_DIR OUT_DIR [--corruptions=a,b] [--severities=1,3,5] [--size=WxH] "
        "[--seed=N] [--device=cuda|cpu] [--stats]",
    )[:2]
    names = _option(argv, "corruptions", ",".join(STORE_CORRUPTIONS)).split(",")
    sevs = [int(s) for s in _option(argv, "severities", "1,2,3,4,5").split(",")]
    known = set(CORRUPTIONS) | set(EXTRA_CORRUPTIONS)
    bad = [n for n in names if n not in known]
    if bad:
        raise SystemExit(f"unknown corruptions {bad}; known: {sorted(known)}")
    bad_sev = [s for s in sevs if not 1 <= s <= 5]
    if bad_sev:
        raise SystemExit(f"severities must be in 1..5, got {bad_sev}")
    stats = {}
    written = corrupt_folder(in_dir, out_dir, names, sevs, seed=int(_option(argv, "seed", "0")),
                             size=_parse_size(argv), device=_option(argv, "device", "cuda"),
                             stats=stats)
    if not written:
        raise SystemExit(f"no images found under {in_dir}")
    print(f"wrote {len(written)} corrupted images ({len(names)} corruptions x "
          f"{len(sevs)} severities) to {out_dir}")
    _print_stats(argv, stats)


def _demo(argv, stats: dict, device, verbose: bool = True):
    """The demo model (the module itself, so that a mesh can copy it to
    each device) and test data on ``device`` (``utils.demo``)."""
    import time

    from imagetransformations_tpu_torch.utils.demo import get_data, get_model

    xtr, ytr, xte, yte = get_data(_option(argv, "data-root", "./data"), verbose=verbose)
    t0 = time.perf_counter()
    _, to_model, model = get_model(xtr, ytr, device=device,
                                   seed=int(_option(argv, "seed", "0")))
    stats["train_s"] = time.perf_counter() - t0
    stats["images"] = int(len(xte))
    return model, to_model, xte, yte


def _timed(stats: dict, key: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; its wall seconds into ``stats[key]``, the
    card's queued work included."""
    import time

    import torch

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if torch.device(kwargs["device"]).type == "cuda":
        torch.cuda.synchronize()
    stats[key] = time.perf_counter() - t0
    return out


def _sweep_mesh(cfg, device: str):
    """The sweep's mesh with ``--data-parallel=true``: ``--mesh-slots`` slots
    on ``device``; else, under ``torchrun`` (``WORLD_SIZE`` > 1), the
    process mesh of its ranks; else one slot a visible CUDA device. None
    for one slot (or without ``--data-parallel``)."""
    if not cfg.data_parallel:
        return None
    import torch

    from imagetransformations_tpu_torch.pipeline.sharding import data_mesh, init_process_mesh

    if cfg.mesh_slots:
        mesh = data_mesh(cfg.mesh_slots, device=device)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return init_process_mesh(device)
    elif torch.device(device).type == "cuda":
        mesh = data_mesh()
    else:
        return None
    return mesh if mesh.size > 1 else None


def cmd_sweep(argv):
    """The corruption sweep. On a process mesh every rank trains the demo
    model, runs its shard of each cell with rank 0's weights and gets the
    whole result; rank 0 alone prints and writes."""
    import torch.distributed as dist

    from imagetransformations_tpu_torch.evalx import report
    from imagetransformations_tpu_torch.evalx.harness import corruption_sweep
    from imagetransformations_tpu_torch.pipeline.sharding import ProcessMesh
    from imagetransformations_tpu_torch.utils.config import SweepConfig

    cfg = SweepConfig.from_cli(argv)
    device = _option(argv, "device", "cuda")
    mesh = _sweep_mesh(cfg, device)
    ranks = isinstance(mesh, ProcessMesh)
    lead = not ranks or mesh.rank == 0
    if ranks:
        device = mesh.device
    try:
        stats: dict = {}
        model_fn, to_model, xte, yte = _demo(argv, stats, device, verbose=lead)
        metrics = tuple(cfg.metrics.split(","))
        if mesh is not None and lead:
            print(f"data-parallel sweep over {mesh.shape['data']} devices")
        sweep = _timed(stats, "sweep_s", corruption_sweep, model_fn, to_model, xte, yte,
                       seed=int(_option(argv, "seed", "0")),
                       severities=tuple(range(1, cfg.severities + 1)), metric_names=metrics,
                       batch_size=cfg.batch_size, mesh=mesh, device=device)
        if lead:
            _write_sweep(argv, cfg, metrics, stats, sweep, report)
    finally:
        if ranks:
            dist.destroy_process_group()


def _write_sweep(argv, cfg, metrics, stats: dict, sweep: dict, report) -> None:
    stats["cells"] = sum(len(v) for v in sweep.values())
    print(report.format_table(report.summary_table(sweep)))
    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(os.path.join(cfg.out_dir, "sweep.json"), "w") as fh:
        json.dump({n: {str(s): r for s, r in v.items()} for n, v in sweep.items()}, fh, indent=1)
    if report.matplotlib_available():
        for m in metrics:
            report.plot_severity_aucs(sweep, m, os.path.join(cfg.out_dir, f"auc_{m}.png"))
        print(f"sweep.json and plots in {cfg.out_dir}")
    else:
        print(f"sweep.json in {cfg.out_dir}; matplotlib is not installed: no PNG written")
    _print_stats(argv, stats)


def cmd_report(argv):
    from imagetransformations_tpu_torch.utils.config import SweepConfig
    from imagetransformations_tpu_torch.workflows import uncertainty_report

    cfg = SweepConfig.from_cli(argv)
    device = _option(argv, "device", "cuda")
    stats: dict = {}
    model_fn, to_model, xte, yte = _demo(argv, stats, device)
    res = _timed(stats, "report_s", uncertainty_report, model_fn, to_model, xte, yte,
                 out_dir=cfg.out_dir, device=device)
    print(f"accuracy: {res['accuracy']:.4f}")
    for m, row in res["thresholds"].items():
        print(f"  {m:>18s}: auroc={row['auroc']:.4f} threshold={row['threshold']:.4f}")
    if res["plots"]:
        print(f"histograms in {cfg.out_dir}")
    else:
        print("matplotlib is not installed: no PNG written")
    _print_stats(argv, stats)


_COMMANDS = {
    "transform": cmd_transform,
    "chain": cmd_chain,
    "corrupt": cmd_corrupt,
    "sweep": cmd_sweep,
    "report": cmd_report,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(__doc__)
        raise SystemExit(0)
    cmd = argv[0]
    if cmd not in _COMMANDS:
        raise SystemExit(
            f"unknown command {cmd!r}; available: {', '.join(_COMMANDS)}"
        )
    _COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    main()
