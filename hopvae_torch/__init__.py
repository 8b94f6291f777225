"""hopvae_torch: the PyTorch/CUDA port of ``hopvae_tpu`` for NVIDIA Hopper.

It imports torch and numpy, never JAX or ``hopvae_tpu``: the JAX package
stays in the repository as the reference the port is tested against.
This slice covers the serving reconstruction path; the one TPU kernel on
it, the streaming Hopfield forward, is ``csrc/hopfield_stream_fwd.cu``.
"""

from hopvae_torch.config import MakeConfig, load_config
from hopvae_torch.models.hopvae import HopVAE

__version__ = "0.1.0"

__all__ = ["MakeConfig", "load_config", "HopVAE", "__version__"]
