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

``sweep`` and ``report`` are not ported yet: they exit with a message
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import json
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

#: commands of the JAX CLI that the port does not have yet, and the ROADMAP
#: item that ports each
_NOT_PORTED = {
    "sweep": "A.6 (evaluation and the sweep / report CLI)",
    "report": "A.6 (evaluation and the sweep / report CLI)",
}


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


def _not_ported(name: str):
    def cmd(argv):
        raise SystemExit(f"{name} is not ported to imagetransformations_tpu_torch yet: "
                         f"ROADMAP {_NOT_PORTED[name]}; use python -m imagetransformations_tpu "
                         f"{name}")

    return cmd


_COMMANDS = {
    "transform": cmd_transform,
    "chain": cmd_chain,
    "corrupt": cmd_corrupt,
    **{name: _not_ported(name) for name in _NOT_PORTED},
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
