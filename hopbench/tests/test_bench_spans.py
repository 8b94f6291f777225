"""The span readers on two small synthetic chrome traces (``fixtures/``): a
slice of two reconstruct calls and one of a sample call with two graph
replays, each value worked out by hand; the cell's existing readers on the
same traces; every reader None without spans; and a window that never turns
the program's recorder on."""

import json
import types
from pathlib import Path

import pytest
import tiny

from hopbench import harness, spans
from hopbench.arith import flops
from hopbench.devtrace import Trace
from hopvae_torch.utils import tracing
from hopvae_torch.utils.tracing import Span

FIXTURES = Path(__file__).resolve().parent / "fixtures"
SERVE = ["idle_input_ms.serve", "idle_launch_ms.serve", "idle_output_ms.serve", "idle_client_ms.serve"]
NEW = SERVE + ["conv_stacks_ms.serve", "lookups_ms.serve", "idle_replay_ms.sample", "replay_host_ms.sample",
               "pixel_step_ms.sample", "warmup_s.setup"]


def _chrome(name: str) -> dict:
    return json.loads((FIXTURES / name).read_text())


def _reading(name: str, calls: int, **extra):
    chrome = _chrome(name)
    cfg = harness.resolve("ffhq64-recon").namespace()
    return types.SimpleNamespace(trace=Trace(chrome), spans=spans.SpanTrace(chrome), calls=calls, cfg=cfg,
                                 batch=256, images=256 * calls, **extra)


def _read(metric: str, reading):
    return harness.load_metric(metric).read(reading)


@pytest.fixture
def recon():
    # the slice [10, 1000] µs: busy [110, 290], [310, 340] and 450 µs later; idle 570 µs
    return _reading("recon_trace.json", 2, call_ms=[1.0, 1.2])


@pytest.fixture
def sample():
    host = [Span("sampler.replay", 0, 2_000_000, 1, 1), Span("sampler.rows", 2_000_000, 2_500_000, 1, 1),
            Span("sampler.replay", 5_000_000, 8_000_000, 1, 1)]
    setup = [Span("engine.warmup", 0, 1_500_000_000, 0, 1), Span("graph.capture", 10, 20, 1, 1),
             Span("engine.warmup", 2_000_000_000, 2_500_000_000, 0, 1)]
    return _reading("sample_trace.json", 1, pixel_steps=2, host_spans=host, setup_spans=setup)


@pytest.mark.parametrize("metric, value", [
    ("idle_input_ms.serve", 0.090),  # [20, 110] and [470, 560]
    ("idle_launch_ms.serve", 0.010),  # [290, 300] and [740, 750]
    ("idle_output_ms.serve", 0.090),  # [300, 310], [340, 420] and their twins
    ("idle_client_ms.serve", 0.095),  # [10, 20], [420, 470], [870, 1000]
    ("conv_stacks_ms.serve", 0.090),  # the encoder's conv (40) and the decoder's (50); not the cast of the forward
    ("lookups_ms.serve", 0.030),
])
def test_recon_readers_by_hand(recon, metric, value):
    assert _read(metric, recon) == pytest.approx(value, abs=1e-12)


@pytest.mark.parametrize("metric, value", [
    ("idle_replay_ms.sample", 0.080),  # [60, 80] and [200, 260]
    ("pixel_step_ms.sample", 0.0675),  # (70 + 65) / 2: the second replay's kernels run after its span, by correlation
    ("replay_host_ms.sample", 2.5),
    ("warmup_s.setup", 2.0),
])
def test_sample_readers_by_hand(sample, metric, value):
    assert _read(metric, sample) == pytest.approx(value, abs=1e-12)


def test_idle_buckets_partition_the_idle_time(recon):
    tr = recon.trace
    idle_ms = 1e3 * (tr.window_s - tr.busy_s()) / recon.calls
    assert sum(_read(m, recon) for m in SERVE) == pytest.approx(idle_ms, abs=1e-9)
    assert idle_ms == pytest.approx(0.285)


def test_existing_readers_on_the_fixtures(recon, sample):
    assert _read("idle_share.serve", recon) == pytest.approx(100 * 570 / 990)
    assert _read("recon_host_ms.serve", recon) == pytest.approx(1.1 - 0.210)
    least = 2 * flops.lookups_least_seconds(recon.cfg, 256, ("K1",))
    assert _read("hopfield_roofline.serve", recon) == pytest.approx(100 * least / 60e-6)
    assert _read("mfu.serve", recon) == pytest.approx(
        100 * flops.forward_flops_per_image(recon.cfg) * 512 / 990e-6 / flops.PEAK_BF16_FLOPS)
    assert _read("idle_share.sample", sample) == pytest.approx(100 * 375 / 590)
    assert _read("sampler_ms.sample", sample) == pytest.approx(_read("pixel_step_ms.sample", sample))


def test_innermost_span_decides():
    st = spans.SpanTrace(_chrome("recon_trace.json"))
    assert [st.innermost(t) for t in (15, 20, 125, 130, 180, 219, 220, 295, 300, 440)] == [
        None, "engine.input", "engine.forward", "model.encoder", "model.lookups", "model.lookups", "model.decoder",
        "engine.forward", "engine.output", None]
    assert st.count("engine.input") == 2 and st.count("sampler.replay") == 0


@pytest.mark.parametrize("metric", NEW)
def test_readers_give_none_without_their_spans(recon, metric):
    """A reading of a run that records no spans (the parent's), and one whose
    trace and records hold none."""
    assert _read(metric, types.SimpleNamespace(trace=recon.trace, calls=2, pixel_steps=2)) is None
    chrome = _chrome("recon_trace.json")
    chrome["traceEvents"] = [e for e in chrome["traceEvents"] if e["cat"] != spans.CAT]
    bare = types.SimpleNamespace(trace=Trace(chrome), spans=spans.SpanTrace(chrome), calls=2, pixel_steps=2,
                                 host_spans=[], setup_spans=[])
    assert _read(metric, bare) is None


def test_readers_move_an_end_to_end_metric():
    manifest = harness.load_manifest()
    for metric in NEW:
        assert harness.load_metric(metric).MOVES in {m["name"] for m in manifest["end_to_end"]}


def test_window_never_records_spans():
    tracing.enable()
    tracing.disable()
    cell = harness.resolve("ffhq64-recon")
    out = harness.run_cell("ffhq64-recon", tiny.SEED, 0.3, False, device="cpu", config_overrides=tiny.CONFIG,
                           traffic_overrides=tiny.traffic(cell))
    assert out["result"]["correct"] and tracing.spans() == []


@pytest.mark.parametrize("name", ["ffhq64-recon", "pixelcnn-mnist28-sample"])
def test_probe_runs_on_the_cpu(name):
    """The probe's calls, spans and readers at the tiny size: spans on the
    host in every on-block, none in the off-blocks' time, and the device's
    readers None (a CPU trace holds no slice)."""
    import torch

    from hopbench import span_probe

    cell = harness.resolve(name)
    out, detail = span_probe.probe(name, tiny.SEED, 2, torch.device("cpu"), config_overrides=tiny.CONFIG,
                                   traffic_overrides=tiny.traffic(cell))
    n = tiny.traffic(cell)["trace_calls"]
    assert len(detail["off_ms"]) == len(detail["on_ms"]) == 4 and len(detail["on_ms"][0]) == n
    assert out["off_ms_median"] > 0 and out["on_ms_median"] > 0
    assert out["metrics"]["warmup_s.setup"] > 0 and detail["setup_span_s"]["engine.warmup"] > 0
    assert out["host_ms_a_call"]["engine.forward"] > 0 and out["device_ms_a_call"] == {}
    if name == "pixelcnn-mnist28-sample":
        assert out["metrics"]["replay_host_ms.sample"] > 0
        assert all(v > 0 for block in detail["on_replay_ms"] for v in block)
        device_readers = ["idle_replay_ms.sample", "pixel_step_ms.sample", "idle_share.sample", "sampler_ms.sample"]
    else:
        device_readers = [m for m in out["metrics"] if m.endswith(".serve")]
    assert {m: out["metrics"][m] for m in device_readers} == dict.fromkeys(device_readers)
