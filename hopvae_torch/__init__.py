"""hopvae_torch: the PyTorch/CUDA port of ``hopvae_tpu`` for NVIDIA Hopper.

It imports torch and numpy, never JAX or ``hopvae_tpu``: the JAX package
stays in the repository as the reference the port is tested against.
It serves reconstructions (``hopvae_torch.serving``), trains the backbone
and, in the prior phase, the Transformer prior (``hopvae_torch.train``).
The TPU kernels on those paths are hand-written CUDA: the streaming
Hopfield forward and its two backward kernels,
``csrc/hopfield_stream_{fwd,bwd_dx,bwd_dku}.cu``, and the prior's causal
flash attention, ``csrc/causal_attention_{fwd,bwd}.cu``.
"""

from hopvae_torch.config import MakeConfig, load_config
from hopvae_torch.models.hopvae import HopVAE

__version__ = "0.1.0"

__all__ = ["MakeConfig", "load_config", "HopVAE", "__version__"]
