"""BENCHMARK.json against the contract's shape, and every cell, configuration,
traffic mix and metric found by its name."""

import json
import re

import pytest

from harness import spec

S = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion|"
                    r"experts_per_token|width)")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(S) == KEYS["top"]
    assert len(json.dumps(S)) <= 64 * 1024
    assert S["command"][:2] == ["python3", "benchmark/run.py"] and len(S["command"]) <= 32
    assert S["paths"] == ["benchmark"]


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_have_the_contract_keys_and_names(section):
    names = [e["name"] for e in S[section]]
    assert len(names) == len(set(names))
    for e in S[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_metric_sources_bounds_and_setup():
    for m in S["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in S["end_to_end"])
    for m in S["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in S["end_to_end"]}
        for cell in m.get("workloads", []):
            assert any(m["moves"] == e["name"] for e in spec.end_to_end(S, cell)), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in S["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end(S, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert spec.per_layer(S, w["name"]), w["name"]
        assert w["chips"] == 1 and NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_configs_are_used_and_reduce_no_width():
    used = {w["config"] for w in S["workloads"]}
    for c in S["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        cfg = spec.config(S, c["name"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and not WIDTHS.search(key), key
    pairs = [(w["config"], w["traffic"]) for w in S["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_cell_configuration_traffic_limits_and_metrics_load_by_name():
    for w in S["workloads"]:
        cfg = spec.config(S, w["config"])
        assert cfg["name"] == w["config"] and cfg["images"] > 0
        kind = spec.kind(spec.traffic(w["traffic"])["kind"])
        assert callable(kind.run) and callable(kind.control)
        assert spec.limits(w["name"])
    for m in S["per_layer"]:
        read = spec.metric_reader(m["name"])
        assert read({"trace": {}, "work": {}, "device": {}}) is None  # nothing to read


@pytest.mark.parametrize("name", ["sweep", "apply_all", "chain"])
def test_a_traffic_kind_is_its_own_module(name):
    mod = spec.kind(name)
    assert mod.__name__ == f"harness.{name}_kind"


@pytest.mark.parametrize("name", ["no_such", "../run", "sweep.x", ""])
def test_an_unknown_traffic_kind_is_refused(name):
    with pytest.raises((KeyError, ModuleNotFoundError)):
        spec.kind(name)


def test_a_metric_finds_the_reader_of_its_family():
    for m in S["per_layer"]:
        assert (spec.BENCH / "metrics" / f"{spec.family(m['name'])}.py").exists(), m["name"]
    assert spec.family("eval_images_per_s.c10c") == "eval_images_per_s"
    assert spec.family("setup_s") == "setup_s"
    read = spec.metric_reader("device_idle_pct.some-later-cell")
    assert read.__code__.co_filename.endswith("metrics/device_idle_pct.py")


def test_run_seconds_fit_a_full_check_of_24_cells():
    cells = 24
    total = (2 + 14 * cells) * (S["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert 1 <= S["run_seconds"] <= 51 and total <= 43200
