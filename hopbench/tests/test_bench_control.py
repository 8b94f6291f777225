"""The control, the reference one precision step below the configuration
in the program's place, and an answer altered where it is produced, come
out as not correct under each cell's limits: here at a tiny size on the
CPU, and (marked ``cuda``) at the cell's own size on the card, on three
seeds each."""

import pytest
import tiny
import torch

from hopbench import checks, control, harness

CELLS = ["ffhq64-recon", "pixelcnn-mnist28-sample"]
SEEDS = (tiny.SEED, tiny.SEED + 1, tiny.SEED + 2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's own size")


def _fails(numbers, limits):
    return not checks.judge({k: v for k, v in numbers.items() if k in limits}, limits)[0]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_a_tiny_size(name):
    """At a tiny size the program runs its float32 plain path, so the
    limits' lower side is not what is tested here; the control has to fail
    one number, and the sound program none."""
    cell = harness.resolve(name)
    limits = checks.limits(name)
    for seed in SEEDS:
        r = control.readings(name, seed, device="cpu", config_overrides=tiny.CONFIG,
                             traffic_overrides=tiny.traffic(cell), calls=6)
        assert not _fails(r["program"], limits), r["program"]
        assert _fails(r["control"], limits), r["control"]
        assert _fails(r["altered"], limits), r["altered"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    limits = checks.limits(name)
    for seed in SEEDS:
        r = control.readings(name, seed, calls=8)
        assert not _fails(r["program"], limits), r["program"]
        assert _fails(r["control"], limits), r["control"]
        assert _fails(r["altered"], limits), r["altered"]
