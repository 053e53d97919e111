"""The numbers that decide ``correct``, each beside its limit.

A number passes when it is at most its limit (``max``) or, for a launch
counter, at least it (``min``). ``correct`` is true when every number
passes."""

from __future__ import annotations

import math

import torch


class Checks:
    def __init__(self, limits: dict):
        self.limits = limits
        self.rows: dict[str, dict] = {}

    def at_most(self, name: str, value: float) -> bool:
        limit = float(self.limits[name])
        ok = not math.isnan(value) and value <= limit
        self.rows[name] = {"value": value, "max": limit, "ok": ok}
        return ok

    def at_least(self, name: str, value: float, limit: float) -> bool:
        ok = value >= limit
        self.rows[name] = {"value": value, "min": limit, "ok": ok}
        return ok

    @property
    def correct(self) -> bool:
        return bool(self.rows) and all(r["ok"] for r in self.rows.values())

    def lines(self) -> list[str]:
        out = []
        for name, r in self.rows.items():
            bound = f"<= {r['max']!r}" if "max" in r else f">= {r['min']!r}"
            out.append(f"check {name} = {r['value']!r} (limit {bound}) {'ok' if r['ok'] else 'FAIL'}")
        return out

    def as_json(self) -> dict:
        return {k: {kk: vv for kk, vv in r.items() if kk != "ok"} for k, r in self.rows.items()}


def rel_gap(port: torch.Tensor, ref: torch.Tensor) -> float:
    """max |port - ref| over max(1, max |ref|); inf where the shapes differ
    or the port holds a non-finite value."""
    if port.shape != ref.shape:
        return math.inf
    p, r = port.to(torch.float64), ref.to(torch.float64)
    if not torch.isfinite(p).all():
        return math.inf
    return float(torch.max(torch.abs(p - r)) / max(1.0, float(torch.max(torch.abs(r)))))


def lsb_gap(port: torch.Tensor, ref: torch.Tensor) -> float:
    """max |port - ref| of two u8 images, in LSB; inf where the shapes or
    types differ."""
    if port.shape != ref.shape or port.dtype != ref.dtype:
        return math.inf
    if port.numel() == 0:
        return 0.0
    return float(torch.max(torch.abs(port.to(torch.int16) - ref.to(torch.int16))))
