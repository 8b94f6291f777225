"""Read the program's spans in one cell beside its device trace: the span
readers' values, where the host's time and the device's idle time go, and
what recording spans costs a call.

    python3 hopbench/span_probe.py --workload <cell> --seed <n> [--rounds 5] [--out <file.json>]

On a card, from the root of a checkout. It builds the cell's session as a
traced run does, with spans on through set-up, then makes ``rounds`` times
four blocks of ``trace_calls`` calls with the profiler off, spans off, on,
on, off (each call's host ms), then ``trace_calls`` calls profiled with
spans on, the card alone as in :func:`hopbench.devtrace.profiled`. It
prints one JSON object: the median host ms a call with spans off and on,
the span readers and the cell's existing per-layer readers on the profiled
slice, each span's host ms, device ms and device-idle ms a call, and the
slice's idle ms a call, which the four ``idle_*_ms.serve`` buckets sum to.
``--out`` also keeps every call's host ms and, with spans on, its
``sampler.replay`` host ms.
"""

import argparse
import gzip
import json
import os
import statistics
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _block(session, n: int) -> list[tuple[int, int]]:
    """``n`` calls; each one's (start, end) in ``perf_counter_ns``."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter_ns()
        session._call()
        out.append((t0, time.perf_counter_ns()))
    return out


def _profiled_chrome(torch, session, n: int) -> tuple[dict, float]:
    """``n`` calls under a profile of the card alone (of the CPU's operators
    on a CPU device, whose trace holds no slice), between two synchronises;
    the chrome trace with the spans recorded meanwhile added on its clock,
    and the calls' host seconds."""
    from torch.profiler import ProfilerActivity, profile

    from hopvae_torch.utils import tracing

    cuda = session.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU], record_shapes=False,
                 with_stack=False, profile_memory=False) as prof:
        sync()
        t0 = time.perf_counter()
        _block(session, n)
        elapsed = time.perf_counter() - t0
        sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
            chrome = json.load(f)
    finally:
        os.remove(path)
    chrome["traceEvents"].extend(tracing.chrome_events(chrome.get("baseTimeNanoseconds", 0)))
    return chrome, elapsed


def _per_call_ms(calls) -> list[float]:
    return [(e - s) * 1e-6 for s, e in calls]


def _in_calls(recorded, calls, name: str) -> list[float]:
    """Each call's host ms in spans named ``name``."""
    return [1e-6 * sum(sp.end - sp.start for sp in recorded if sp.name == name and s <= sp.start <= e)
            for s, e in calls]


def probe(name: str, seed: int, rounds: int, device, *, config_overrides: dict | None = None,
          traffic_overrides: dict | None = None) -> tuple[dict, dict]:
    """The probe of cell ``name`` on ``device``; returns (the printed
    object, the detail ``--out`` keeps)."""
    import torch

    from hopbench import devtrace, harness, spans
    from hopvae_torch.utils import tracing

    cell = harness.resolve(name, config_overrides=config_overrides, traffic_overrides=traffic_overrides)
    if device.type == "cuda":
        devtrace.warm_profiler()
    tracing.enable()
    t0 = time.perf_counter()
    session = harness.load_driver(cell.traffic["kind"]).Session(cell, seed, device)
    setup_s = time.perf_counter() - t0
    setup_spans = tracing.spans()
    tracing.disable()

    n = session.trace_calls
    off, on, host_spans = [], [], []
    for _ in range(rounds):
        for spans_on in (False, True, True, False):  # in turns, so that a drift in the host's speed cancels
            if not spans_on:
                off.append(_block(session, n))
                continue
            tracing.enable()
            on.append(_block(session, n))
            host_spans.append(tracing.spans())
            tracing.disable()
    tracing.enable()
    chrome, elapsed = _profiled_chrome(torch, session, n)
    tracing.disable()
    session.release()

    batch = getattr(session, "batch", None) or session.n
    off_ms = [_per_call_ms(b) for b in off]
    reading = types.SimpleNamespace(
        trace=devtrace.Trace(chrome), spans=spans.SpanTrace(chrome), cfg=session.cfg, batch=batch, calls=n,
        images=n * batch, pixel_steps=n * session.cfg.representation_dim**2, seconds=elapsed,
        call_ms=off_ms[-1], host_spans=[s for round_ in host_spans for s in round_], setup_spans=setup_spans)

    manifest = harness.load_manifest()
    names = list(cell.per_layer) + sorted(
        p.stem for p in (ROOT / "hopbench" / "metrics").glob("*.py")
        if p.stem not in cell.per_layer and harness.reports({"moves": harness.load_metric(p.stem).MOVES}, cell.name,
                                                            manifest))
    tr, st = reading.trace, reading.spans
    span_names = sorted({s.name for s in reading.host_spans})
    on_calls = [c for b in on for c in b]
    out = {
        "workload": cell.name, "seed": seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu", "setup_s": setup_s,
        "rounds": rounds, "calls_a_block": n,
        "off_ms_median": statistics.median(ms for b in off_ms for ms in b),
        "on_ms_median": statistics.median(ms for b in on for ms in _per_call_ms(b)),
        "profiled_ms_a_call": 1e3 * elapsed / n,
        "metrics": {name: harness.load_metric(name).read(reading) for name in names},
        "slice_idle_ms_a_call": 1e3 * (tr.window_s - tr.busy_s()) / n if tr.window_s > 0 else None,
        "host_ms_a_call": {k: 1e-6 * sum(s.end - s.start for s in reading.host_spans if s.name == k) / len(on_calls)
                           for k in span_names},
        "device_ms_a_call": {k: 1e3 * st.device_s((k,)) / n for k in span_names if st.count(k)},
        "idle_ms_a_call": {k: 1e3 * st.idle_s((k,)) / n for k in span_names if st.count(k)},
        "spans_a_call": {k: st.count(k) / n for k in span_names if st.count(k)},
    }
    detail = {**out, "off_ms": off_ms, "on_ms": [_per_call_ms(b) for b in on],
              "on_replay_ms": [_in_calls(r, b, "sampler.replay") for r, b in zip(host_spans, on)],
              "setup_span_s": {k: tracing.seconds(k, setup_spans) for k in sorted({s.name for s in setup_spans})}}
    return out, detail


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "hopbench" / "_cache" / "triton"))
    sys.path[0] = str(ROOT)

    import torch

    if not torch.cuda.is_available():
        print(f"error: {args.workload} needs a CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, torch.get_num_threads()))
    out, detail = probe(args.workload, args.seed, args.rounds, torch.device("cuda"))
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(detail))
    return 0


if __name__ == "__main__":
    sys.exit(main())
