"""Checks that need a CUDA card and the built kernels: on a host without
one each test skips with its reason. On the card, from the repository root
(``tests/conftest.py`` imports JAX, which the card's host lacks):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card.py -q -m cuda

Past ``BWD_WIDE_MAX`` the backward kernels take every multiple of 128 on
their window kernels: ``backward_attributes`` reports the window kernel's
build, with no cluster, and ``backward_workspace`` and ``forward_workspace``
plan split scratch within 64 MiB, as ``split_plan`` says. A CUDA graph
left dead in a reference cycle does not break a later capture.
"""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import gc

import pytest
import torch

from hopvae_torch.ops import attention_cuda as ac
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
