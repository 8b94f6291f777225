"""The buffers and the CUDA graphs of the Transformer prior's KV-cached decode.

Port of the loop of ``_decode_all`` in
``hopvae_tpu/models/priors/transformer.py`` (its step is
``TransformerPrior._decode_step``):

- The S positions run in segments of T (``prior_decode_segment``):
  segment k covers ``[kT, min((k+1)T, S))`` and its steps read the
  caches' prefix ``[:min((k+1)T, S)]``. JAX grows its caches by
  concatenation between segments; here each layer's caches are allocated
  once at full length and a segment reads a prefix view. The numbers are
  the same: a position past ``t`` is masked to -1e30 and weighs 0 in both.
- The position ``t``, the previous token and the outputs (draws or
  logits) live in device tensors, and the step advances ``t`` itself.
- On a CUDA device :meth:`Decoder.capture` records one step for each
  segment in a ``torch.cuda.CUDAGraph`` (warmed up on a side stream first;
  all graphs share one memory pool), and :meth:`Decoder.run` replays it
  once for each position of its segment. A failed capture or replay
  raises; nothing falls back to the eager loop. Elsewhere the step runs
  eagerly (the CPU's path).
- The sampler's noise is drawn outside the graphs, a block for each
  segment, into the buffer the step reads (``fill``).
"""

from __future__ import annotations

import torch

from hopvae_torch.utils.graphs import collector_held
from hopvae_torch.utils.tracing import span

# the largest code of a quantized cache; int4's codes are kept in int8
# (JAX's S4 packs two a byte: the values are the same, the bytes are not)
QMAX = {"int8": 127.0, "int4": 7.0}


class Decoder:
    """One decode's state at batch ``b``: the caches, ``t``, the previous
    token, the outputs (``out``: draws ``(S, B)`` int64, or logits
    ``(S, B, L)``), the noise of a segment (``noise`` ``(T, B, L)``) or the
    teacher-forced tokens (``tokens`` ``(B, S)``), and once captured the
    segments' graphs."""

    def __init__(self, prior, b: int, cache_dtype: str, mode: str):
        """``mode``: ``"sample"`` or ``"logits"`` (teacher-forced)."""
        dev, s, lvl = prior.tok_emb.device, prior.seq, prior.num_levels
        seg = min(prior.decode_segment, s)
        self.prior, self.mode, self.batch = prior, mode, b
        self.segments = [(a, min(a + seg, s)) for a in range(0, s, seg)]
        self.qmax = QMAX.get(cache_dtype)
        self.caches = prior._empty_caches(b, cache_dtype)
        self.positions = torch.arange(s, device=dev)
        self.t = torch.zeros(1, dtype=torch.int64, device=dev)
        self.prev = torch.zeros(b, dtype=torch.int64, device=dev)
        if mode == "sample":
            self.noise = torch.zeros(seg, b, lvl, device=dev)
            self.out = torch.zeros(s, b, dtype=torch.int64, device=dev)
        else:
            self.tokens = torch.zeros(b, s, dtype=torch.int64, device=dev)
            self.out = torch.zeros(s, b, lvl, device=dev)
        self.graphs: list | None = None

    def reset(self, t: int = 0) -> None:
        """Zeroed caches, ``t`` at the given position, previous token 0."""
        for cache in self.caches:
            for buf in cache.values():
                buf.zero_()
        self.t.fill_(t)
        self.prev.zero_()

    def step(self, segment: int) -> None:
        """One position of segment ``segment``, eagerly."""
        self.prior._decode_step(self, *self.segments[segment])

    def capture(self) -> None:
        """Capture one step of each segment in a CUDA graph, all in one
        memory pool, after a warm-up step of each on a side stream (the
        span ``graph.capture``)."""
        with span("graph.capture"):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for k, (start, _stop) in enumerate(self.segments):
                    self.t.fill_(start)
                    self.step(k)
            torch.cuda.current_stream().wait_stream(side)
            pool = torch.cuda.graph_pool_handle()
            graphs = []
            with collector_held():
                for k in range(len(self.segments)):
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=pool):
                        self.step(k)
                    graphs.append(graph)
            torch.cuda.synchronize()
            self.graphs = graphs

    def run(self, fill=None) -> torch.Tensor:
        """Every position from 0, segment by segment: ``fill(noise, start,
        stop)`` first writes a sampling segment's noise rows, then the step
        runs once for each position (its graph's replay, once captured).
        Returns ``out``, which the next run overwrites."""
        self.reset()
        for k, (start, stop) in enumerate(self.segments):
            if fill is not None:
                fill(self.noise[: stop - start], start, stop)
            for _ in range(stop - start):
                if self.graphs is None:
                    self.step(k)
                else:
                    self.graphs[k].replay()
        return self.out
