"""The harness: the manifest, the files a cell is made of, one run of a cell.

``BENCHMARK.json`` (beside this folder) names every cell, configuration
and metric. Everything that belongs to one of them is a file found by its
name, so a later cell, traffic mix or metric is a file added here and an
entry added there:

- ``configs/<config>.json``: the configuration as it is run (``config``),
  its source, the keys changed from it and the precisions it states;
- ``traffic/<traffic>.json``: a traffic mix, the parameters of its
  ``kind``; ``drivers/<kind>.py`` is the general driver of that kind;
- ``metrics/<metric>.py``: a per-layer reader, ``read(reading)`` returning
  a number or None, with ``MOVES``, the end-to-end metric it moves;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct`` (:mod:`hopbench.checks`).

:func:`run_cell` runs one cell once: set-up, then the window (or with
``trace`` a traced slice of it), the device's peak memory, the calls
after the window that only the check reads (a driver's ``after_window``),
the program freed, the comparison with the plain reference, and the
result.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
import types
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hopvae_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def _find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in the manifest")


def reports(metric: dict, cell: str, manifest: dict) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` key
    lists, or without the key every cell (for a per-layer metric: every cell
    that reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return reports(_find(manifest["end_to_end"], metric["moves"], "end-to-end metric"), cell, manifest)
    return True


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict  # the configuration's keys as run
    precision: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: list = field(default_factory=list)  # names reported with trace 0
    per_layer: list = field(default_factory=list)  # names reported with trace 1

    def namespace(self) -> types.SimpleNamespace:
        """The configuration as attributes (what the reference and the
        yardstick read)."""
        return types.SimpleNamespace(**self.config)


def resolve(name: str, manifest: dict | None = None, root: Path = ROOT, config_overrides: dict | None = None,
            traffic_overrides: dict | None = None) -> Cell:
    """The cell ``name`` from the manifest and its files under ``root``."""
    manifest = load_manifest(root / "BENCHMARK.json") if manifest is None else manifest
    w = _find(manifest["workloads"], name, "workload")
    conf = _find(manifest["configs"], w["config"], "configuration")
    doc = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "hopbench" / "traffic" / f"{w['traffic']}.json").read_text())
    config = {**doc["config"], **(config_overrides or {})}
    traffic = {**traffic, **(traffic_overrides or {})}
    return Cell(
        name=name, config_name=w["config"], config=config, precision=doc.get("precision", {}),
        traffic_name=w["traffic"], traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m["name"] for m in manifest["end_to_end"] if reports(m, name, manifest)],
        per_layer=[m["name"] for m in manifest["per_layer"] if reports(m, name, manifest)],
    )


def load_driver(kind: str, root: Path = ROOT):
    return _load_file(root / "hopbench" / "drivers" / f"{kind}.py", f"hopbench_driver_{kind}")


def load_metric(name: str, root: Path = ROOT):
    return _load_file(root / "hopbench" / "metrics" / f"{name}.py", f"hopbench_metric_{name.replace('.', '_')}")


def _load_file(path: Path, module_name: str):
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _finite_or_none(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def device_info(torch, device, count: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}


def release(torch, device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float | None = None, device=None,
             root: Path = ROOT, config_overrides: dict | None = None, traffic_overrides: dict | None = None) -> dict:
    """One run of the cell; returns ``{"result": the result line's object,
    "checks_text": the numbers beside their limits}``. ``device`` None is
    the card, with the production settings; a CPU device (the tests) runs
    the program's plain path in float32."""
    import torch

    from hopbench import checks, devtrace

    t_start = time.perf_counter() if t_start is None else t_start
    cell = resolve(name, root=root, config_overrides=config_overrides, traffic_overrides=traffic_overrides)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and trace:
        devtrace.warm_profiler()
    driver = load_driver(cell.traffic["kind"], root)
    session = driver.Session(cell, seed, device)
    setup_s = time.perf_counter() - t_start

    if trace:
        reading = session.traced()
    else:
        window = session.window(seconds)
    info = device_info(torch, device, cell.chips)
    if hasattr(session, "after_window"):  # the program's calls that only the check reads
        session.after_window()
    session.release()
    release(torch, device)

    numbers = session.check()
    limits = checks.limits(name, root)
    correct, shown = checks.judge(numbers, limits)
    for item in shown.values():
        item["value"] = _finite_or_none(item["value"])

    metrics, breakdown = {}, None
    if trace:
        tr = reading.trace
        if tr is not None and tr.window_s > 0:
            info["busy_s"] = tr.busy_s()
            info["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
        for metric in load_manifest(root / "BENCHMARK.json")["per_layer"]:
            if metric["name"] in cell.per_layer:
                value = load_metric(metric["name"], root).read(reading)
                if value is not None and math.isfinite(value):
                    metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in load_manifest(root / "BENCHMARK.json")["end_to_end"]}
        window["setup_s"] = setup_s
        for metric in cell.end_to_end:
            if metric in window:
                metrics[metric] = {"value": window[metric], "unit": units[metric]}

    result = {"correct": bool(correct), "attempted": session.attempted, "failed": session.failed,
              "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = shown
    notes = {k.lstrip("_"): v for k, v in numbers.items() if k not in limits}
    text = "\n".join(f"check {k}: {v['value']} (limit {v['limit']})" for k, v in shown.items())
    if notes:
        text = "\n".join(f"note {k}: {v}" for k, v in notes.items()) + "\n" + text
    return {"result": result, "checks_text": text}
