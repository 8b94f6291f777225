"""The port's spans (``hopvae_torch.utils.tracing``) on the CPU: the
recorder off and on, its clock against ``time.time_ns()`` and against a
``torch.profiler`` trace, the spans a reconstruct and a sample call open,
the engine's warm-up, and ``train.profiled``'s trace with the spans in it."""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import json
import time

import numpy as np
import pytest
import torch

from hopvae_torch import HopVAE, load_config
from hopvae_torch import train as ttrain
from hopvae_torch.serving import InferenceEngine
from hopvae_torch.utils import tracing
from hopvae_torch.utils.tracing import span

SMALL = {"num_hiddens": 16, "num_residual_hiddens": 8, "num_embeddings": 64}
TINY_PIXELCNN = {"prior_num_filters": 24, "prior_num_res_blocks": 2}
RECON = ["engine.input", "engine.forward", "model.encoder", "model.lookups", "model.decoder", "engine.output"]


@pytest.fixture
def recording():
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()


def _config(name: str, **over):
    cfg = load_config(name)
    for k, v in {**SMALL, **over}.items():
        setattr(cfg, k, v)
    return cfg


def _engine(cfg, **kw):
    torch.manual_seed(0)
    state = HopVAE(cfg, impl="torch", device="cpu").state_dict()
    return InferenceEngine(cfg, state, impl="torch", compute_dtype=None, device="cpu", **kw)


def _opened(recorded):
    """(name, depth) of each span, in the order they opened."""
    return [(s.name, s.depth) for s in sorted(recorded, key=lambda s: s.start)]


def test_off_records_nothing_and_allocates_nothing():
    tracing.disable()
    first = span("engine.forward")
    with first, span("model.encoder"):
        pass
    assert span("engine.output") is first and not tracing.spans()


def test_on_nests_and_enable_clears(recording):
    with span("a"):
        with span("b"):
            with span("c"):
                pass
        with span("d"):
            pass
    assert _opened(tracing.spans()) == [("a", 0), ("b", 1), ("c", 2), ("d", 1)]
    by_start = sorted(tracing.spans(), key=lambda s: s.start)
    for outer, inner in ((0, 1), (1, 2), (0, 3)):
        o, i = by_start[outer], by_start[inner]
        assert o.start <= i.start <= i.end <= o.end
    tracing.enable()
    assert tracing.spans() == []
    with span("e"):
        pass
    tracing.disable()
    with span("f"):
        pass
    assert [s.name for s in tracing.spans()] == ["e"]


def test_depth_recovers_after_an_exception(recording):
    with pytest.raises(ValueError):
        with span("outer"):
            raise ValueError("inside")
    with span("next"):
        pass
    assert _opened(tracing.spans()) == [("outer", 0), ("next", 0)]


def test_clock_matches_time_ns(recording):
    before = time.time_ns()
    with span("probe"):
        time.sleep(0.002)
    after = time.time_ns()
    (s,) = tracing.spans()
    start, end = tracing.unix_ns(s.start), tracing.unix_ns(s.end)
    assert before - 1_000_000 <= start < end <= after + 1_000_000
    assert tracing.seconds("probe") == pytest.approx((s.end - s.start) * 1e-9)


def test_spans_land_on_the_profiler_clock(tmp_path):
    """A span around an op holds the op's event of a CPU profile, within
    1 ms at each end (the profiler pairs its own clocks; a loaded CPU moves
    that pair), once converted with the trace's base time."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.enable()
        with span("probe"):
            x.sum()
        tracing.disable()
    path = tmp_path / "cpu.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    (probe,) = tracing.chrome_events(doc["baseTimeNanoseconds"])
    ops = [e for e in doc["traceEvents"] if e.get("name") == "aten::sum"]
    assert ops and all(probe["ts"] - 1000 <= e["ts"] and e["ts"] + e["dur"] <= probe["ts"] + probe["dur"] + 1000
                       for e in ops)
    (s,) = tracing.spans()
    assert probe["dur"] == (s.end - s.start) / 1e3 and probe["args"] == {"depth": 0}


def test_reconstruct_opens_the_listed_spans(recording):
    cfg = _config("mnist_28")
    eng = _engine(cfg, max_batch=2, ops=("reconstruct",))
    tracing.enable()
    eng.reconstruct(np.zeros((1, 28, 28, 1), np.float32))
    assert _opened(tracing.spans()) == [(n, 1 if n.startswith("model.") else 0) for n in RECON]


def test_sample_opens_the_listed_spans(recording):
    """The eager sampler: the taps and reset, then each row's noise and its
    r steps, then the decode's lookup and the decoder."""
    cfg = _config("pixelcnn_mnist_28", **TINY_PIXELCNN)
    r = cfg.representation_dim
    eng = _engine(cfg, max_batch=2, n_sample=2, ops=("sample",))
    tracing.enable()
    eng.sample(3)
    rows = [("sampler.rows", 1)] + ([("sampler.rows", 1)] + [("sampler.replay", 1)] * r) * r
    assert _opened(tracing.spans()) == [("engine.forward", 0), *rows, ("model.lookups", 1), ("model.decoder", 1),
                                        ("engine.output", 0)]


def test_warmup_spans_hold_each_op(recording):
    cfg = _config("mnist_28")
    _engine(cfg, max_batch=2, ops=("reconstruct", "encode"))
    opened = _opened(tracing.spans())
    assert [n for n, d in opened if d == 0] == ["engine.warmup", "engine.warmup"]
    assert [n for n, d in opened if d == 1] == [n for n in RECON if n.startswith("engine.")] * 2
    assert [n for n, d in opened if d == 2] == [n for n in RECON if n.startswith("model.")] + ["model.encoder"]
    assert tracing.seconds("engine.warmup") > 0


def test_profiled_writes_the_spans_on_the_trace_clock(tmp_path):
    """``train.profiled``'s trace holds the model's spans, and the encoder's
    span holds the encoder's first convolution on the trace's clock (within
    1 ms: the CPU profiler pairs its own clocks)."""
    cfg = _config("mnist_28")
    torch.manual_seed(0)
    model = HopVAE(cfg, impl="torch", device="cpu")
    x = torch.zeros(2, 28, 28, 1)
    with ttrain.profiled(str(tmp_path), cuda=False), torch.no_grad():
        model(x)
    with span("after the block"):
        pass
    (trace,) = (tmp_path / "trace").iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert sorted(spans) == ["model.decoder", "model.encoder", "model.lookups"] == sorted(
        s.name for s in tracing.spans())
    enc = spans["model.encoder"]
    conv = min((e for e in events if e.get("name") == "aten::convolution"), key=lambda e: e["ts"])
    assert enc["ts"] - 1000 <= conv["ts"] and conv["ts"] + conv["dur"] <= enc["ts"] + enc["dur"] + 1000
    assert enc["ts"] + enc["dur"] <= spans["model.lookups"]["ts"]
