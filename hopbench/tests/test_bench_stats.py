"""The window's arithmetic: a stall inside the window moves the rate and
the idle share, each taken over all the work and all the time."""

import time
import types

import numpy as np

from hopbench import devtrace, readers, stats


def _recon_session(delays):
    """The recon driver's window over a fake engine whose i-th call sleeps
    ``delays[i]`` seconds (the last delay repeats)."""
    from hopbench.drivers import recon

    calls = iter(delays)
    last = [delays[-1]]

    class Engine:
        def reconstruct(self, x):
            time.sleep(next(calls, last[0]))
            return x

    s = recon.Session.__new__(recon.Session)
    s.engine, s.batch, s.pool, s.calls = Engine(), 2, np.zeros((8, 1, 1, 1), np.float32), 0
    s.attempted = s.failed = 0
    s.kept = stats.Reservoir(2, np.random.default_rng(0))
    return s


def test_recon_rate_sees_a_stall():
    steady = _recon_session([0.002])
    base = steady.window(0.4)
    stalled = _recon_session([0.002] * 20 + [0.05] * 10 + [0.002])  # a slow stretch inside the window
    slow = stalled.window(0.4)
    assert slow["recon_images_per_s"] < 0.8 * base["recon_images_per_s"]
    assert steady.attempted == steady.calls and steady.failed == 0


def test_sample_rate_sees_a_stall():
    from hopbench.drivers import sample

    def session(stall_at):
        count = [0]

        class Engine:
            def sample(self, seed):
                count[0] += 1
                time.sleep(0.3 if count[0] == stall_at else 0.01)
                return np.zeros((2, 1, 1, 1), np.float32)

        s = sample.Session.__new__(sample.Session)
        s.engine, s.n, s.shape, s.seed, s.calls, s.attempted, s.failed = Engine(), 2, (2, 1, 1, 1), 5, 0, 0, 0
        return s

    fast, slow = session(-1).window(0.5), session(3).window(0.5)
    assert slow["sample_images_per_s"] < 0.75 * fast["sample_images_per_s"]


def _chrome(kernels, lo, hi):
    """A slice from ``lo`` to ``hi`` (the ends of its two synchronises) and
    its kernels, each launched by a runtime call just before it."""
    events = [{"ph": "X", "cat": "cuda_runtime", "name": devtrace.SYNC, "ts": t - 1.0, "dur": 1.0} for t in (lo, hi)]
    for i, (n, s, d) in enumerate(kernels):
        events.append({"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": d, "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": s - 0.5, "dur": 0.25,
                       "args": {"correlation": i}})
    return {"traceEvents": events}


def test_idle_share_busy_and_gaps():
    steady = [("k", 10.0 * i, 9.0) for i in range(100)]  # busy 90%
    stalled = [("k", 10.0 * i + (300.0 if i >= 50 else 0.0), 9.0) for i in range(100)]  # a 300 µs stall
    a = devtrace.Trace(_chrome(steady, 0.0, 1000.0))
    b = devtrace.Trace(_chrome(stalled, 0.0, 1300.0))
    ra, rb = (types.SimpleNamespace(trace=t) for t in (a, b))
    assert abs(readers.idle_share(ra) - 10.0) < 1e-9
    assert readers.idle_share(rb) > readers.idle_share(ra) + 15.0
    assert abs(a.busy_s() - 900e-6) < 1e-12 and abs(a.device_s("k") - 900e-6) < 1e-12
    assert b.idle_gaps(1)[0][1] > 300e-6 - 1e-12
    assert a.device_s(launch="cudaLaunchKernel") == a.device_s() and a.device_s(launch="cudaGraphLaunch") == 0
    assert a.top_ops()[0][0] == "k" and abs(a.top_ops()[0][1] - a.device_s()) < 1e-12


def test_overlapping_events_count_once_and_outside_the_slice_not_at_all():
    t = devtrace.Trace(_chrome([("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 200.0, 10.0)], 0.0, 100.0))
    assert abs(t.busy_s() - 15e-6) < 1e-12 and abs(t.device_s() - 20e-6) < 1e-12


def test_reservoir():
    r = stats.Reservoir(3, np.random.default_rng(1))
    for i in range(1000):
        r.offer(i)
    assert len(r.items) == 3 and r.seen == 1000 and max(r.items) > 10
