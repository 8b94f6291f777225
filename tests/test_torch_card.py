"""Checks that need a CUDA card and the built kernels: on a host without
one each test skips with its reason. On the card, from the repository root
(``tests/conftest.py`` imports JAX, which the card's host lacks):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py -q -m cuda

Past ``BWD_WIDE_MAX`` the backward kernels take every multiple of 128 on
their window kernels: ``backward_attributes`` reports the window kernel's
build, with no cluster, and ``backward_workspace`` and ``forward_workspace``
plan split scratch within 64 MiB, as ``split_plan`` says; so do K2's and
K3's split products past 8192 and K1's score pass past its split cap
(``hopfield_cuda.split_plan``). A CUDA graph
left dead in a reference cycle does not break a later capture.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import gc

import pytest
import torch

from hopvae_torch.ops import attention_cuda as ac
from hopvae_torch.ops import hopfield_cuda as hc
from hopvae_torch.utils.graphs import collector_held

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels' library builds with nvcc and reads the card's attributes")


@pytest.mark.parametrize("width", [8320, 16384])
def test_window_backward_attributes_and_workspace(card, width):
    """Nothing refuses the width: each backward kernel reports its window
    build (no cluster, a block an SM at least), and its scratch and the
    forward's fit 64 MiB at B 2, S 37 and at B 1, S 2100."""
    for kernel in ("dkv", "dq"):
        attrs = ac.backward_attributes(kernel, width)
        assert "cluster" not in attrs and attrs["blocks_per_sm"] >= 1 and attrs["threads"] == 128
    for b, s in ((2, 37), (1, 2100)):
        for kernel in ("dkv", "dq"):
            assert 0 < ac.backward_workspace(b, s, 1, width, kernel) * 4 <= 64 << 20
            assert ac.split_plan(kernel, b, s, 1, width)["slabs"] >= 1
        assert 0 < ac.forward_workspace(b, s, 1, width) * 4 <= 64 << 20


@pytest.mark.parametrize("kernel", ["dx", "dku"])
@pytest.mark.parametrize("sizes", [(4096, 64, 8320, 3), (256, 2048, 8320, 3), (256, 256, 8320, 8320),
                                   (73984, 4096, 1280, 3), (73984, 4096, 8192, 3)])
def test_lookup_split_plans_fit_the_cap(card, kernel, sizes):
    """K2's and K3's products past 8192, whose sums and parts pass 64 MiB
    whole, split slab after slab within it: the library's plan has a slab
    at least, a round of parts at least, and scratch within the cap."""
    plan = hc.split_plan(kernel, *sizes)
    assert plan["slabs"] >= 1 and plan["rounds"] >= 1 and 0 < plan["scratch_floats"] * 4 <= 64 << 20


@pytest.mark.parametrize("kernel", ["dx", "dku"])
@pytest.mark.parametrize("sizes", [(4096, 512, 384, 3), (73984, 4096, 384, 3), (4096, 512, 300, 64)])
def test_whole_window_plans_split_nothing(card, kernel, sizes):
    """Where K2 and K3 take their whole window, the library's plan splits
    no product: no slab, no scratch past the partial sums."""
    assert hc.narrow_split(kernel, sizes[0], sizes[1], *sizes[2:], 132) == "whole"
    assert not any(hc.split_plan(kernel, *sizes).values())


@pytest.mark.parametrize("sizes", [(4096, 64, 8320, 3), (256, 2048, 8320, 3), (16384, 512, 384, 3),
                                   (4096, 4096, 384, 3)])
def test_forward_slab_plans_fit_the_cap(card, sizes):
    """K1's score pass past its split cap: the library's plan covers every
    token tile in its slabs, gives a block a pattern tile at least, and
    holds a slab's S within 64 MiB."""
    plan = hc.split_plan("fwd", *sizes)
    assert plan["slabs"] * plan["units_per_slab"] >= -(-sizes[0] // hc.TOKEN_TILE)
    assert plan["pattern_tiles_per_block"] >= 1 and 0 < plan["scratch_floats"] * 4 <= 64 << 20


def test_capture_survives_a_dead_graph_in_a_cycle(card):
    """A graph in a dead reference cycle (as a ``Trainer`` and its epoch
    runner leave theirs) is freed by ``collector_held``'s collection before
    the capture: a collection inside finds nothing to free. Without it the
    graph's destructor runs inside the capture, and CUDA invalidates it."""
    x = torch.ones(4, device="cuda")
    cycle = {"graph": torch.cuda.CUDAGraph()}
    cycle["self"] = cycle
    with collector_held(), torch.cuda.graph(cycle["graph"]):
        x.add_(1)
    del cycle
    graph = torch.cuda.CUDAGraph()
    with collector_held(), torch.cuda.graph(graph):
        x.mul_(2)
        gc.collect()
    graph.replay()
    torch.cuda.synchronize()
    assert x.tolist() == [2.0] * 4  # the dead graph never replayed
