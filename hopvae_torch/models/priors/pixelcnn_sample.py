"""The PixelCNN prior's column-incremental sampler and its CUDA graph.

Port of ``PixelCNNPrior._sample_scan_colchain`` in
``hopvae_tpu/models/priors/pixelcnn.py`` (with ``_center_mats``,
``_col_taps`` and ``_center_chain_h``), the JAX package's production
``sample``. A change to pixel (i, j)'s own channels reaches its logits
only through the convs' center taps, so each of the r² pixel steps is a
handful of small matmuls and no conv:

- the partial of each layer at (i, j), from the pixels before it: the
  7×7 first conv's upper window (the rows above and the columns to the
  left, the center tap excluded) gathered from the padded level grid,
  and for each 3×3 conv three taps on the row above and one to the left,
  read from that layer's cached activations;
- then for each channel in turn the center chain (the center taps of
  every layer on the pixel's vector, the channels drawn so far set) gives
  that channel's logits and its draw; after the last one, the chain once
  more gives the layers' activations at (i, j), written into the caches.

The caches are double-buffered by row parity, as in JAX: one ``(B, 2,
r+2, f)`` buffer a block, column ``jj`` at index ``jj+1`` and permanent
zero pads at 0 and ``r+1``; row ``i`` writes plane ``i & 1`` and reads its
above-taps from plane ``1 - (i & 1)``. The level grid carries three rows
of padding on top and three columns on each side, raw level 0 there,
and the window is masked to 0 in normalized space outside the grid
(raw level 0 would normalize to -1).

The step reads the pixel index ``s`` from a device tensor and advances
it itself, and every gather and write takes device indices
(``index_select``, ``index_copy_``), so one captured step replays for
each of the r² pixels. On a CUDA device :meth:`ColumnSampler.capture`
records it in a ``torch.cuda.CUDAGraph`` after a warm-up step on a side
stream (the prior's samplers share one memory pool); a failed capture or
replay raises. Elsewhere the step runs eagerly (the CPU's path). The
Gumbel noise of each row of pixels is drawn outside the graph into the
buffer the step reads. The tap matrices are buffers of the sampler,
refreshed from the prior's parameters at every run, so a sampler stays
right while the prior trains.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hopvae_torch.models.priors.transformer import gumbel_
from hopvae_torch.utils.graphs import collector_held
from hopvae_torch.utils.tracing import span


class ColumnSampler:
    """One sampler's state at batch ``b``: the padded level grid, the
    layers' parity caches, the pixel index ``s``, the taps, and in
    ``mode="sample"`` the noise of a row of pixels ``(r, C, B, L)``, in
    ``mode="logits"`` (teacher-forced) the grid's levels ``(B, r², C)``
    and the logits of every step ``(r², C, B, L)``."""

    def __init__(self, prior, b: int, mode: str):
        if mode not in ("sample", "logits"):
            raise ValueError(f"mode must be 'sample' or 'logits', got {mode!r}")
        dev = prior.conv_in.weight.device
        r, c, f, lvl = prior.representation_dim, prior.index_dim, prior.features, prior.num_levels
        self.prior, self.mode, self.batch = prior, mode, b
        self.grid = torch.zeros(b, r + 3, r + 6, c, device=dev)
        self.hbufs = [torch.zeros(b, 2, r + 2, f, device=dev) for _ in range(prior.n_res)]
        self.s = torch.zeros(1, dtype=torch.int64, device=dev)
        self.rows4, self.cols7, self.cols3 = (torch.arange(k, device=dev) for k in (4, 7, 3))
        self.taps = self._taps()
        if mode == "sample":
            self.noise = torch.zeros(r, c, b, lvl, device=dev)
        else:
            self.tokens = torch.zeros(b, r * r, c, device=dev)
            self.out = torch.zeros(r * r, c, b, lvl, device=dev)
        self.graph: torch.cuda.CUDAGraph | None = None

    def _taps(self) -> dict:
        """The step's matrices, ``(in, out)``, from the masked weights:
        ``in`` the first conv's upper window ``(4·7·C, f)`` with its center
        tap zeroed, flattened (row, column, channel) as the window is;
        ``above.<b>`` ``(3f, f)`` and ``left.<b>`` of each 3×3 conv; the
        center taps ``cm_in``, ``ca.<b>``, ``cb.<b>`` (the 1×1 conv whole),
        ``o1`` and ``o2.<c>``, the last head's columns of channel c; and
        the biases. The 1×1 conv of the last block is left out: no cache
        holds its output."""
        p, c, lvl = self.prior, self.prior.index_dim, self.prior.num_levels

        def hwio(conv):
            return conv.masked_weight().detach().permute(2, 3, 1, 0)

        kin = hwio(p.conv_in).clone()
        taps = {"cm_in": kin[3, 3].clone(), "in_b": p.conv_in.bias.detach().clone()}
        kin[3, 3] = 0.0
        taps["in"] = kin[:4].reshape(-1, kin.shape[-1])
        for b, block in enumerate(p.res):
            ka = hwio(block.conv_a)
            taps.update({f"above.{b}": ka[0].reshape(-1, ka.shape[-1]), f"left.{b}": ka[1, 0], f"ca.{b}": ka[1, 1],
                         f"a_b.{b}": block.conv_a.bias.detach(), f"cb.{b}": hwio(block.conv_b)[0, 0],
                         f"b_b.{b}": block.conv_b.bias.detach()})
        o2 = hwio(p.conv_out2)[0, 0]
        taps.update({"o1": hwio(p.conv_out1)[0, 0], "b1": p.conv_out1.bias.detach()})
        for ch in range(c):
            taps[f"o2.{ch}"] = o2[:, ch * lvl : (ch + 1) * lvl]
            taps[f"b2.{ch}"] = p.conv_out2.bias.detach()[ch * lvl : (ch + 1) * lvl]
        return {k: v.contiguous().clone() for k, v in taps.items()}

    def load_taps(self) -> None:
        """Refresh the taps from the prior's current parameters, in place."""
        for name, val in self._taps().items():
            self.taps[name].copy_(val)

    def reset(self) -> None:
        """Zeroed grid and caches, ``s`` at pixel 0. A cell's level before
        its pixel is drawn reaches no logit: the taps that read it are
        masked to exact zeros."""
        self.grid.zero_()
        for hb in self.hbufs:
            hb.zero_()
        self.s.zero_()

    def _chain(self, partials: list, x: torch.Tensor, ch: int | None = None):
        """The center chain on the pixel vector ``x`` ``(B, C)``: channel
        ``ch``'s logits ``(B, L)``, or with ``ch=None`` the activations at
        the pixel that the caches hold, one a block."""
        t, n_res = self.taps, self.prior.n_res
        h = partials[0] + x @ t["cm_in"]
        hs = [h]
        for b in range(n_res if ch is not None else n_res - 1):
            a = partials[1 + b] + F.relu(h) @ t[f"ca.{b}"]
            h = h + (F.relu(a) @ t[f"cb.{b}"] + t[f"b_b.{b}"])
            hs.append(h)
        if ch is None:
            return hs
        o = F.relu(h) @ t["o1"] + t["b1"]
        return F.relu(o) @ t[f"o2.{ch}"] + t[f"b2.{ch}"]

    def step(self) -> None:
        """Pixel ``s``: the partials, the C channel draws (``argmax(logits +
        noise)``, or the grid's levels with the logits kept), the levels
        into the grid, the activations into this row's cache plane, then
        ``s`` advances by one."""
        prior, t, n = self.prior, self.taps, self.batch
        r, c, f = prior.representation_dim, prior.index_dim, prior.features
        scale = prior.num_levels - 1
        s = self.s
        i = torch.div(s, r, rounding_mode="floor")
        j = s - i * r
        p = torch.bitwise_and(i, 1)  # this row's plane; 1 - p holds row i - 1
        win = self.grid.index_select(1, i + self.rows4).index_select(2, j + self.cols7)
        valid = ((self.rows4 >= 3 - i)[:, None] & (self.cols7 >= 3 - j) & (self.cols7 < r + 3 - j))[None, :, :, None]
        xw = torch.where(valid, win / scale * 2.0 - 1.0, 0.0)
        partials = [xw.reshape(n, -1) @ t["in"] + t["in_b"]]
        for b, hb in enumerate(self.hbufs):
            above = F.relu(hb.index_select(1, 1 - p).index_select(2, j + self.cols3)).reshape(n, 3 * f)
            left = F.relu(hb.index_select(1, p).index_select(2, j)).reshape(n, f)
            partials.append(above @ t[f"above.{b}"] + left @ t[f"left.{b}"] + t[f"a_b.{b}"])
        x = self.grid.index_select(1, i + 3).index_select(2, j + 3).reshape(n, c) / scale * 2.0 - 1.0
        if self.mode == "sample":
            noise = self.noise.index_select(0, j)[0]
        else:
            given = self.tokens.index_select(1, s)[:, 0]
        levels = []
        for ch in range(c):
            logits = self._chain(partials, x, ch)
            if self.mode == "sample":
                level = torch.argmax(logits + noise[ch], dim=-1).float()
            else:
                self.out.view(-1, n, logits.shape[-1]).index_copy_(0, s * c + ch, logits[None])
                level = given[:, ch]
            levels.append(level)
            x[:, ch] = level / scale * 2.0 - 1.0
        self.grid.view(n, -1, c).index_copy_(1, (i + 3) * (r + 6) + j + 3, torch.stack(levels, -1)[:, None])
        for hb, h in zip(self.hbufs, self._chain(partials, x)):
            hb.view(n, -1, f).index_copy_(1, p * (r + 2) + j + 1, h[:, None])
        s.add_(1)

    def capture(self) -> None:
        """Capture one step in a CUDA graph, in the prior's memory pool,
        after a warm-up step on a side stream (the span ``graph.capture``)."""
        with span("graph.capture"):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.reset()
                self.step()
            torch.cuda.current_stream().wait_stream(side)
            if getattr(self.prior, "_graph_pool", None) is None:
                self.prior._graph_pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with collector_held(), torch.cuda.graph(graph, pool=self.prior._graph_pool):
                self.step()
            torch.cuda.synchronize()
            self.graph = graph

    def run(self, *, generator: torch.Generator | None = None, gumbel: torch.Tensor | None = None,
            grid: torch.Tensor | None = None) -> torch.Tensor:
        """Every pixel from 0, row by row: a sampling row's noise first
        (``gumbel`` ``(r², C, B, L)``'s rows, else fresh draws from
        ``generator``), then the step once for each pixel of the row (its
        graph's replay, once captured). Returns the drawn levels ``(B, r, r,
        C)`` (``mode="sample"``) or, given ``grid`` ``(B, r, r, C)``, the
        logits ``(r², C, B, L)``; the next run overwrites either."""
        r, c, n = self.prior.representation_dim, self.prior.index_dim, self.batch
        with span("sampler.rows"):
            self.load_taps()
            self.reset()
        if self.mode == "logits":
            self.tokens.copy_(grid.reshape(n, r * r, c))
        for i in range(r):
            if self.mode == "sample":
                with span("sampler.rows"):
                    if gumbel is not None:
                        self.noise.copy_(gumbel[i * r : (i + 1) * r])
                    else:
                        torch.rand(self.noise.shape, generator=generator, device=self.noise.device, out=self.noise)
                        gumbel_(self.noise)
            for _ in range(r):
                with span("sampler.replay"):
                    if self.graph is None:
                        self.step()
                    else:
                        self.graph.replay()
        return self.grid[:, 3:, 3 : r + 3] if self.mode == "sample" else self.out
