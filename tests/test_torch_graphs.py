"""``utils.graphs.collector_held``, which every CUDA graph capture of the
port runs in: one collection before the block, the cyclic collector off
inside it and back on after. On the card, ``tests/test_torch_card.py``
captures a graph while another lies dead in a reference cycle."""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import gc

import pytest

from hopvae_torch.utils.graphs import collector_held


class _Cycle:
    """An object in a reference cycle, which only the collector frees."""

    def __init__(self, freed: list):
        self.me, self.freed = self, freed

    def __del__(self):
        self.freed.append(True)


def test_collector_held_collects_first_and_holds_the_collector_off():
    assert gc.isenabled()
    freed = []
    _Cycle(freed)
    with collector_held():
        assert freed == [True] and not gc.isenabled()
        _Cycle(freed)
        with collector_held():
            assert len(freed) == 2 and not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
    with pytest.raises(RuntimeError, match="inside"), collector_held():
        raise RuntimeError("raised inside the block")
    assert gc.isenabled()
    gc.disable()
    try:
        with collector_held():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
