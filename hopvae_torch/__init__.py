"""hopvae_torch: the PyTorch/CUDA port of ``hopvae_tpu`` for NVIDIA Hopper.

It imports torch and numpy, never JAX or ``hopvae_tpu``: the JAX package
stays in the repository as the reference the port is tested against.
It serves reconstructions (``hopvae_torch.serving``) and trains the
backbone (``hopvae_torch.train``). The TPU kernels on those paths, the
streaming Hopfield forward and its two backward kernels, are
``csrc/hopfield_stream_{fwd,bwd_dx,bwd_dku}.cu``.
"""

from hopvae_torch.config import MakeConfig, load_config
from hopvae_torch.models.hopvae import HopVAE

__version__ = "0.1.0"

__all__ = ["MakeConfig", "load_config", "HopVAE", "__version__"]
