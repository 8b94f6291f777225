"""CIFAR10 32×32 (same geometry as ffhq_32: 32→9). Copy of ``hopvae_tpu.configs.cifar10_32_config``."""

config = {}
config["batch_size"] = 32
config["epochs"] = 100
config["no_cuda"] = False
config["seed"] = 1265
config["image_size"] = 32
config["log_interval"] = 1
config["learning_rate"] = 1e-3
config["momentum"] = 0.1
config["gamma"] = 0.98
config["weight_decay"] = 0.0
config["num_hiddens"] = 128
config["num_residual_layers"] = 2
config["num_residual_hiddens"] = 32
config["num_filters"] = 64
config["embedding_dim"] = 64
config["num_embeddings"] = 512
config["num_channels"] = 3
config["data_set"] = "CIFAR10"
config["representation_dim"] = 9
config["num_levels"] = 512
config["prior_start"] = 50
config["prior"] = "None"
config["index_dim"] = 3
