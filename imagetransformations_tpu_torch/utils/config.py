"""Typed configuration (the reference hardcodes every constant at module top;
SURVEY.md SS5 'Config / flag system: none'). Dataclasses + CLI override.

The port's own copy of ``imagetransformations_tpu/utils/config.py`` (the
port imports nothing of the JAX package); ``FrameworkConfig.device`` names
where the port runs ("cuda" unless the caller asks for "cpu").

Usage:  cfg = SweepConfig.from_cli()  # parses --field=value overrides
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any


@dataclasses.dataclass
class _Base:
    @classmethod
    def from_cli(cls, argv=None):
        cfg = cls()
        argv = sys.argv[1:] if argv is None else argv
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for arg in argv:
            if not arg.startswith("--") or "=" not in arg:
                continue
            k, v = arg[2:].split("=", 1)
            k = k.replace("-", "_")
            if k in fields:
                cur = getattr(cfg, k)
                if isinstance(cur, bool):
                    setattr(cfg, k, v.lower() in ("1", "true", "yes"))
                elif isinstance(cur, int):
                    setattr(cfg, k, int(v))
                elif isinstance(cur, float):
                    setattr(cfg, k, float(v))
                else:
                    setattr(cfg, k, v)
        return cfg


@dataclasses.dataclass
class FrameworkConfig(_Base):
    seed: int = 0
    batch_size: int = 256
    data_root: str = "./data"
    num_devices: int = 0  # 0 = all local
    device: str = "cuda"


@dataclasses.dataclass
class SweepConfig(_Base):
    """Corruption sweep (FINAL_cifar_corrupted.py constants)."""

    severities: int = 5
    batch_size: int = 256
    metrics: str = "shannon_entropy,msp,margin,energy"
    out_dir: str = "./plots"
    # shard each (corruption, severity) cell over all local devices
    # (evalx.evaluate_sharded); single-device runs are unaffected
    data_parallel: bool = False
    # with data_parallel: this many mesh slots on the one --device (0 =
    # one slot a visible CUDA device)
    mesh_slots: int = 0


@dataclasses.dataclass
class RefineConfig(_Base):
    """Reverse-FGSM refinement (cifar_iterative_mc.py:393-414,542)."""

    eps: float = 0.03
    max_iters: int = 10
    msp_stop: float = 0.998
    metric: str = "mc_dropout_entropy"
    threshold: float = 1.5


@dataclasses.dataclass
class TentConfig(_Base):
    """TENT sweep (TENT_Pipelines.py:34-45,354-360)."""

    lr: float = 2.5e-4
    protocol: str = "continuous"  # continuous | reset | conditional
    image_entropy_threshold: float = 1.16


@dataclasses.dataclass
class SwagConfig(_Base):
    """SWAG budgets (cifar_swag.py:133-214)."""

    collection_epochs: int = 50
    weight_samples: int = 30
    eval_mc_samples: int = 10
    max_rank: int = 20
    lr: float = 1e-4
