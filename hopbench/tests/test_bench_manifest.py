"""BENCHMARK.json and the files it names: names, units, which cells report
what, and every file each entry needs."""

import json
import re
from pathlib import Path

import pytest

from hopbench import harness

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["hopbench"] and M["command"] == ["python3", "hopbench/run.py"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text():
    metrics = M["end_to_end"] + M["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in M["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in M["workloads"]] + [w["traffic"] for w in M["workloads"]]:
        assert NAME.match(n), n
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for text in ([c["source"] for c in M["configs"]] + [c["why"] for c in M["configs"]]
                 + [w["why"] for w in M["workloads"]] + [m["layer"] for m in M["per_layer"]] + M["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        reported = [m["name"] for m in M["end_to_end"] if harness.reports(m, cell, M)]
        assert "setup_s" in reported and len(reported) >= 2, cell


def test_per_layer_metrics_report_what_they_move():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in CELLS and harness.reports(e2e[m["moves"]], cell, M), (m["name"], cell)
        reader = harness.load_metric(m["name"])
        assert reader.MOVES == m["moves"] and callable(reader.read)
        if m["unit"] == "%":
            assert re.search(r"roofline|mfu|share", m["name"]), m["name"]
    for cell in CELLS:
        assert any(harness.reports(m, cell, M) for m in M["per_layer"]), cell


def test_every_named_file_is_there():
    for w in M["workloads"]:
        cell = harness.resolve(w["name"])
        assert harness.load_driver(cell.traffic["kind"]).Session
        assert json.loads((ROOT / "hopbench" / "limits" / f"{w['name']}.json").read_text())
        assert w["chips"] == 1
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert used == {c["name"] for c in M["configs"]} and len(files) == len(set(files))
    for f in files:
        assert f.startswith("hopbench/") and (ROOT / f).exists()


@pytest.mark.parametrize("entry", M["configs"], ids=lambda c: c["name"])
def test_config_changes_only_what_it_lists(entry):
    """The configuration as run differs from the reference's published file
    (the port's registered copy of the file its source names) in the listed
    keys alone, and never in a width; a key the published file lacks is
    listed, with its origin, under ``assumed``."""
    from hopvae_torch.configs import get_config

    doc = json.loads((ROOT / entry["file"]).read_text())
    published = get_config(re.search(r"/configs/(\w+)_config\.py$", entry["source"]).group(1))
    assert doc["source"] == entry["source"] and doc["reduced"] == entry["reduced"]
    changed = sorted(k for k in published if published[k] != doc["config"].get(k))
    assert changed == sorted(entry["reduced"])
    assert doc["source_values"] == {k: published[k] for k in entry["reduced"]}
    assert set(doc["config"]) - set(published) <= set(doc["assumed"])
    widths = re.compile(r"_dim$|_rank$|hidden|num_filters|channels|image_size|representation")
    assert not [k for k in entry["reduced"] if widths.search(k)]
