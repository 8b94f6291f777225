"""Traffic kind ``recon``: one closed-loop client of ``InferenceEngine.reconstruct``.

Parameters: ``batch`` (the engine's ``max_batch`` and every call's size),
``pool`` (seeded images held on the host as numpy), ``checked_calls`` (a
seeded reservoir of calls whose answers the reference checks) and
``trace_calls`` (the traced slice, after as many calls untraced whose
host ms the traced run reports). Call ``i`` sends the pool's ``i``-th
batch (cyclically) and waits for its numpy result; the traced run times
each call on the host clock. The engine serves only ``reconstruct``, so
only that op's shapes warm up.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from hopbench import seeded
from hopbench.devtrace import profiled
from hopbench.program import program_config, program_settings
from hopbench.stats import Reservoir
from hopbench.reference.model import Model, exact_f32, stated_mode


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        from hopvae_torch.serving import InferenceEngine

        t = cell.traffic
        self.cell, self.device, self.cfg = cell, device, cell.namespace()
        self.batch, self.trace_calls = int(t["batch"]), int(t["trace_calls"])
        self.attempted = self.failed = 0
        self.rng = np.random.default_rng(seed & seeded.SEED_MASK)
        self.kept = Reservoir(int(t["checked_calls"]), self.rng)
        self.state = seeded.state(self.cfg, seed, device)
        self.pool = seeded.images(self.cfg, int(t["pool"]), seed, device).cpu().numpy()
        if len(self.pool) < self.batch:
            raise ValueError(f"a pool of {len(self.pool)} images is smaller than a call of {self.batch}")
        self.engine = InferenceEngine(program_config(cell), self.state, max_batch=self.batch, device=device,
                                      ops=("reconstruct",), **program_settings(cell, device))
        self.calls = 0
        self._call()  # a real batch through the warmed engine
        self.calls, self.attempted, self.failed, self.kept.items, self.kept.seen = 0, 0, 0, [], 0

    def _call(self) -> float:
        starts = len(self.pool) // self.batch
        at = (self.calls % starts) * self.batch
        x = self.pool[at : at + self.batch]
        t0 = time.perf_counter()
        y = self.engine.reconstruct(x)
        dt = time.perf_counter() - t0
        self.attempted += 1
        if y.shape != x.shape:
            self.failed += 1
        self.kept.offer((at, y))
        self.calls += 1
        return dt

    def window(self, seconds: float) -> dict:
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._call()
            n += 1
        return {"recon_images_per_s": n * self.batch / (time.perf_counter() - t0)}

    def traced(self):
        untraced = [self._call() for _ in range(self.trace_calls)]  # host ms without the profiler
        holder, latencies = {}, []
        with profiled(holder):
            t0 = time.perf_counter()
            for _ in range(self.trace_calls):
                latencies.append(self._call())
            elapsed = time.perf_counter() - t0
        return types.SimpleNamespace(trace=holder.get("trace"), cfg=self.cfg, batch=self.batch,
                                     calls=len(latencies), images=len(latencies) * self.batch,
                                     call_ms=[1e3 * v for v in untraced], seconds=elapsed)

    def release(self) -> None:
        self.engine = None

    def inputs(self, at: int) -> torch.Tensor:
        return torch.from_numpy(self.pool[at : at + self.batch]).to(self.device)

    def check(self) -> dict:
        from hopbench import checks

        ref = Model(self.cfg, self.state, "reference")
        stated = Model(self.cfg, self.state, stated_mode(self.cell.precision))
        with torch.no_grad(), exact_f32():
            refs = [ref.forward(self.inputs(at))[0].cpu() for at, _ in self.kept.items]
            states = [stated.forward(self.inputs(at))[0].cpu() for at, _ in self.kept.items]
        return checks.image_numbers("recon", [torch.from_numpy(np.asarray(y)) for _, y in self.kept.items], refs, states)
