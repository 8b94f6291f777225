"""A run with its timed path broken underneath comes out not correct,
under each cell's committed limits: the harness's look for a card is
skipped (the CPU at a tiny size), the rest of the run is driven whole."""

import pytest
import tiny

from hopbench import harness


def _run(name, trace=False):
    cell = harness.resolve(name)
    return harness.run_cell(name, tiny.SEED, 0.3, trace, device="cpu", config_overrides=tiny.CONFIG,
                            traffic_overrides=tiny.traffic(cell))["result"]


@pytest.mark.parametrize("name", ["ffhq64-recon", "pixelcnn-mnist28-sample"])
def test_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["failed"] == 0 and result["attempted"] > 0


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from hopvae_torch.serving import InferenceEngine

    reconstruct = InferenceEngine.reconstruct

    def altered(self, x):
        y = reconstruct(self, x).copy()
        y[-1] = -y[-1]
        return y

    monkeypatch.setattr(InferenceEngine, "reconstruct", altered)
    assert not _run("ffhq64-recon")["correct"]


def test_a_level_altered_where_it_is_drawn(monkeypatch):
    from hopvae_torch.models.priors.pixelcnn import PixelCNNPrior

    sample = PixelCNNPrior.sample

    def altered(self, *a, **kw):
        grid = sample(self, *a, **kw)
        grid[0, 0, 0, 0] = (grid[0, 0, 0, 0] + 1) % self.num_levels
        return grid

    monkeypatch.setattr(PixelCNNPrior, "sample", altered)
    result = _run("pixelcnn-mnist28-sample")
    assert not result["correct"] and result["checks"]["logit_gap"]["value"] > 0


def test_an_image_altered_where_it_is_decoded(monkeypatch):
    from hopvae_torch.models.hopvae import HopVAE

    decode = HopVAE.decode_grid
    def altered(self, grid):
        images = decode(self, grid)
        images[-1] = -images[-1]
        return images

    monkeypatch.setattr(HopVAE, "decode_grid", altered)
    result = _run("pixelcnn-mnist28-sample")
    assert not result["correct"] and result["checks"]["decode_ratio"]["value"] > 10
