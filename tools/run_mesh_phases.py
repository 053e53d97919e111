#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases ``patches``, ``evolution``, ``sharding`` and
``processes`` alone on one GPU (the caller's TF32 on, as the script runs them), each to
its end: a phase that breaks a budget prints its row and its traceback, and
the exit code is then 1. The kernels are built first, as the script builds
them, so that no phase times a build. For iterating on these phases
without the whole script (naming phases runs those alone):

    python3 tools/run_mesh_phases.py [patches] [evolution] [sharding] [processes]
"""

import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(only: list[str]) -> int:
    if not torch.cuda.is_available():
        print("run_mesh_phases: no CUDA device available", file=sys.stderr)
        return 1
    from imagetransformations_tpu_torch.ops.hopper import _lib
    from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
    from imagetransformations_tpu_torch.pipeline.datasets import synthetic

    t0 = time.time()
    _lib.build_all()
    for name in _lib.SIGNATURES:
        _lib.load(name)
    print("build_s", time.time() - t0, flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    xtr, ytr = synthetic(cs.UQ_TRAIN_IMAGES, seed=cs.SEED)
    xte, yte = synthetic(cs.UQ_TEST_IMAGES, seed=cs.SEED + 1)
    rc = 0
    with cs.caller_tf32(torch, True):
        t0 = time.time()
        model, space = cs.demo_model(torch, xtr, ytr)
        print("model_s", time.time() - t0, flush=True)
        shard_ms: dict = {}

        def sharding():
            launched, ms = cs.sharding_phase(torch, mk, model, space, xte, yte)
            shard_ms.update(ms)
            return launched

        phases = (("patches", lambda: cs.patches_phase(torch, mk, model, space, xtr, ytr, xte,
                                                       yte)),
                  ("evolution", lambda: cs.evolution_phase(torch, mk, model, space, xte)),
                  ("sharding", sharding),
                  ("processes", lambda: cs.processes_phase(torch, mk, model, space, xte, yte,
                                                           shard_ms)))
        for name, phase in phases:
            if only and name not in only:
                continue
            t0 = time.time()
            try:
                print(name, "launches", phase(), flush=True)
            except RuntimeError:
                traceback.print_exc()
                rc = 1
            print(f"{name}_phase_s", time.time() - t0, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
