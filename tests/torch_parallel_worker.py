"""One rank of ``tests/test_torch_parallel.py``'s two-process run: the port's
``Trainer`` under a gloo group on the CPU, at a tiny ``mnist_28`` with 96
patterns, one epoch of two Adam steps with the gradients watched and an
evaluation, every rank's results written to ``<out>/rank<r>.pt``.

    python tests/torch_parallel_worker.py RANK WORLD PORT N_MODEL OUT
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from hopvae_torch import HopVAE, load_config  # noqa: E402
from hopvae_torch import data as tdata  # noqa: E402
from hopvae_torch import train as ttrain  # noqa: E402
from hopvae_torch.parallel import mesh as mesh_lib  # noqa: E402

TINY = {"num_hiddens": 16, "num_residual_hiddens": 8, "num_embeddings": 96, "embedding_dim": 16, "batch_size": 8}


def tiny_setup():
    """The config, a seeded model and the data every run uses: 16 golden
    digits to train on (two steps of 8), 16 to evaluate."""
    cfg = load_config("mnist_28")
    for k, v in TINY.items():
        setattr(cfg, k, v)
    torch.manual_seed(0)
    model = HopVAE(cfg, impl="torch", device="cpu")
    digits = tdata.golden_input("mnist_digits")
    train = tdata.ArrayDataset(digits[:16], np.zeros(16, np.int64))
    test = tdata.ArrayDataset(digits[16:32], np.zeros(16, np.int64))
    return cfg, model, train, test


class Recording(ttrain.Trainer):
    def train_step(self, x):
        out = super().train_step(x)
        self.losses.append(float(out["loss"]))
        return out


def main(rank: int, world: int, port: int, n_model: int, out: str) -> None:
    torch.set_num_threads(1)
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    mesh_lib.init_distributed("cpu")
    writes = {"grids": 0, "checkpoints": 0}
    grid, save = ttrain.save_image_grid, torch.save

    def counted(kind, fn):
        def call(*a, **k):
            writes[kind] += 1
            return fn(*a, **k)
        return call

    ttrain.save_image_grid = counted("grids", grid)
    ttrain.torch.save = counted("checkpoints", save)
    try:
        cfg, model, train, test = tiny_setup()
        tr = Recording(model, cfg, mesh_lib.make_mesh(n_model), shard_patterns=True)
        tr.losses, tr.watch_gradients = [], True
        tr.fit(train, test, epochs=1, out_dir=out, eval_every=1, save_every=1)
        patterns = {k: mesh_lib.gather_rows(tr.mesh, v) if tr.sharded else v
                    for k, v in model.state_dict().items() if k in ttrain.PATTERNS}
        test_err = tr.evaluate(test)
    finally:
        ttrain.save_image_grid, ttrain.torch.save = grid, save
        dist.destroy_process_group()
    save({"losses": tr.losses, "patterns": patterns, "test_err": test_err, "writes": writes,
          "local_rows": model.hopfield.lookup_weights.shape[0]}, os.path.join(out, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(*map(int, sys.argv[1:5]), sys.argv[5])
