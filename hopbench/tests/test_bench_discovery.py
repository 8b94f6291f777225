"""A configuration, a traffic mix and a per-layer metric are added by
adding files and entries: a copy of the benchmark with one of each added
runs its new cell with no edit to any file that was there."""

import json
import shutil
from pathlib import Path

import tiny

from hopbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_added_files_run_with_no_edit(tmp_path):
    shutil.copytree(ROOT / "hopbench", tmp_path / "hopbench", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "hopbench").rglob("*") if p.is_file()}

    # a configuration: the plain FFHQ 64 at another memory size
    doc = json.loads((tmp_path / "hopbench" / "configs" / "ffhq_64.json").read_text())
    doc["config"]["num_embeddings"] = 64
    (tmp_path / "hopbench" / "configs" / "ffhq_64_m64.json").write_text(json.dumps(doc))
    # a traffic mix of an existing kind: small reconstruct calls
    mix = {"kind": "recon", "batch": 4, "pool": 16, "checked_calls": 2, "trace_calls": 3}
    (tmp_path / "hopbench" / "traffic" / "recon_small.json").write_text(json.dumps(mix))
    # a per-layer metric: the calls the traced slice holds
    (tmp_path / "hopbench" / "metrics" / "calls_traced.serve.py").write_text(
        'MOVES = "recon_images_per_s"\n\n\ndef read(reading):\n    return float(reading.calls)\n')
    (tmp_path / "hopbench" / "limits" / "ffhq64m64-recon-small.json").write_text(json.dumps({"recon_err": 1e-3}))
    manifest["configs"].append({"name": "ffhq_64_m64", "source": "https://example.org/ffhq_64_m64",
                                "file": "hopbench/configs/ffhq_64_m64.json", "reduced": ["num_embeddings"],
                                "why": "added by a test"})
    manifest["workloads"].append({"name": "ffhq64m64-recon-small", "config": "ffhq_64_m64", "traffic": "recon_small",
                                  "chips": 1, "why": "added by a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "recon_images_per_s":
            m["workloads"].append("ffhq64m64-recon-small")
    manifest["per_layer"].append({"name": "calls_traced.serve", "unit": "calls", "better": "higher",
                                  "source": "host_clock", "layer": "InferenceEngine", "moves": "recon_images_per_s",
                                  "workloads": ["ffhq64m64-recon-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    config = {k: v for k, v in tiny.CONFIG.items() if k not in ("num_embeddings", "batch_size")}
    untraced = harness.run_cell("ffhq64m64-recon-small", tiny.SEED, 0.5, False, device="cpu", root=tmp_path,
                                config_overrides=config)["result"]
    assert untraced["correct"] and set(untraced["metrics"]) == {"recon_images_per_s", "setup_s"}
    traced = harness.run_cell("ffhq64m64-recon-small", tiny.SEED, 0.5, True, device="cpu", root=tmp_path,
                              config_overrides=config)["result"]
    assert traced["correct"] and traced["metrics"]["calls_traced.serve"] == {"value": 3.0, "unit": "calls"}
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "hopbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)
