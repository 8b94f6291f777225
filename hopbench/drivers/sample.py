"""Traffic kind ``sample``: one closed-loop client of ``InferenceEngine.sample``.

Parameters: ``n_sample`` (images a call), ``checked_calls`` (the calls
after the window whose draws the reference checks) and ``trace_calls``
(the traced slice).

Call ``i`` is ``engine.sample(seed_i)``, with a seed derived from the
run's seed and ``i``, and returns its images as numpy; the window times
these calls alone. The engine serves only ``sample``, so only that op
warms up (its sampler's graph included).

Once the window has closed and the device's peak is read, the checked
calls go through the engine's own model as ``engine.sample`` does (the
prior's ``sample``, then ``decode_grid``), at the window's batch, with
Gumbel noise drawn here from the seed in place of the generator's: the
prior's ``_gumbel`` input, which the sampler copies into the buffer its
captured step reads. Each drawn level is then the argmax of its logit
plus noise the reference knows, so the reference can check every level of
every pixel and channel, and the decoded images.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from hopbench import seeded
from hopbench.devtrace import profiled
from hopbench.program import program_config, program_settings
from hopbench.reference.model import Model, exact_f32, stated_mode

NOISE_STREAM = 2  # the checked calls' noise: streams 2, 3, ...


class Session:
    def __init__(self, cell, seed: int, device: torch.device):
        from hopvae_torch.serving import InferenceEngine

        t = cell.traffic
        self.cell, self.device, self.cfg, self.seed = cell, device, cell.namespace(), seed
        self.n, self.trace_calls, self.n_checked = int(t["n_sample"]), int(t["trace_calls"]), int(t["checked_calls"])
        self.shape = (self.n, self.cfg.image_size, self.cfg.image_size, self.cfg.num_channels)
        self.attempted = self.failed = 0
        self.checked = []  # (noise stream, drawn levels, decoded images) of each checked call
        self.state = seeded.state(self.cfg, seed, device)
        self.engine = InferenceEngine(program_config(cell), self.state, max_batch=self.n, device=device,
                                      n_sample=self.n, ops=("sample",), **program_settings(cell, device))
        self.calls = 0
        self._call()  # a real call through the warmed engine
        self.calls = self.attempted = self.failed = 0

    def _call(self) -> None:
        images = self.engine.sample((self.seed * 1_000_003 + self.calls) & seeded.SEED_MASK)
        self.attempted += 1
        if images.shape != self.shape or not np.isfinite(images).all():
            self.failed += 1
        self.calls += 1

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self._call()
            n += 1
        return {"sample_images_per_s": n * self.n / (time.perf_counter() - t0)}

    def traced(self):
        holder = {}
        with profiled(holder):
            t0 = time.perf_counter()
            for _ in range(self.trace_calls):
                self._call()
            elapsed = time.perf_counter() - t0
        return types.SimpleNamespace(trace=holder.get("trace"), cfg=self.cfg, batch=self.n, calls=self.trace_calls,
                                     images=self.trace_calls * self.n,
                                     pixel_steps=self.trace_calls * self.cfg.representation_dim**2, seconds=elapsed)

    def noise(self, stream: int) -> torch.Tensor:
        """A checked call's noise, ``(r², C, n_sample, L)`` as the prior takes it."""
        r, c, lvl = self.cfg.representation_dim, self.cfg.index_dim, self.cfg.num_levels
        return seeded.gumbel((r * r, c, self.n, lvl), self.seed, self.device, stream)

    def after_window(self) -> None:
        """The checked calls, on the engine's model at the window's batch."""
        model = self.engine.model
        for k in range(self.n_checked):
            with torch.inference_mode():
                grid = model.prior.sample(self.n, _gumbel=self.noise(NOISE_STREAM + k))
                images = model.decode_grid(grid.to(torch.int32).float()).cpu().numpy()
            self.checked.append((NOISE_STREAM + k, grid.cpu(), images))

    def release(self) -> None:
        self.engine = None

    def scores_noise(self, stream: int) -> torch.Tensor:
        """A checked call's noise arranged as the reference's logits, ``(n, r, r, C, L)``."""
        r = self.cfg.representation_dim
        g = self.noise(stream)
        return g.permute(2, 0, 1, 3).reshape(self.n, r, r, g.shape[1], g.shape[3]).clone()

    def check(self) -> dict:
        from hopbench import checks

        ref = Model(self.cfg, self.state, "reference")
        stated = Model(self.cfg, self.state, stated_mode(self.cell.precision))
        gap, refs, states = (0.0 if self.checked else float("inf")), [], []
        with torch.no_grad(), exact_f32():
            for stream, grid, _ in self.checked:
                grid = grid.to(self.device).float()
                gap = max(gap, checks.logit_gap(ref.pixelcnn_logits(grid), self.scores_noise(stream), grid))
                refs.append(ref.decode_grid(grid).cpu())
                states.append(stated.decode_grid(grid).cpu())
        images = [torch.from_numpy(np.asarray(im)) for _, _, im in self.checked]
        return {"logit_gap": gap, **checks.image_numbers("decode", images, refs, states)}
