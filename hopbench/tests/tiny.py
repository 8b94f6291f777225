"""A tiny size of every cell for the CPU tests: the configurations' widths
cut down, and each traffic mix's counts."""

CONFIG = dict(num_hiddens=16, num_residual_hiddens=8, embedding_dim=8, num_embeddings=32, image_size=16,
              representation_dim=5, batch_size=4, prior_num_filters=6, prior_num_res_blocks=1)
TRAFFIC = {
    "recon": dict(batch=4, pool=16, checked_calls=2, trace_calls=2),
    "sample": dict(n_sample=2, checked_calls=2, trace_calls=1),
}
SEED = 3_000_000_019  # past 32 signed bits, as the driver's seeds are


def traffic(cell) -> dict:
    return TRAFFIC[cell.traffic["kind"]]
