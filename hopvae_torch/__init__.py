"""hopvae_torch: the PyTorch/CUDA port of ``hopvae_tpu`` for NVIDIA Hopper.

It imports torch and numpy, never JAX or ``hopvae_tpu``: the JAX package
stays in the repository as the reference the port is tested against.

- ``hopvae_torch.serving``: reconstruct, encode, ``interpolate`` and
  ``sample`` through the ``InferenceEngine`` and a batch CLI, under the
  PixelCNN, Transformer or Normal prior.
- ``hopvae_torch.train``: the backbone, then the prior phase, with JAX's
  ``--watch-grads``, ``--profile`` and ``--debug-nans``; it starts from
  the reference's torch checkpoint, a JAX ``.msgpack`` or its own ``.pt``
  (``utils.checkpoint.load_reference_checkpoint``).
- ``hopvae_torch.data``: the datasets, with an FFHQ folder streamed from
  its files (``LazyImageFolder``, read ahead on a thread).
- ``hopvae_torch.parallel``: data parallelism and the pattern memories
  split over ranks under ``torchrun`` (NCCL); ``deploy/torch_job.sh``
  launches the trainer that way.
- ``hopvae_torch.utils.checkpoint``: checkpoints both ways between the
  port and the JAX package (``params_to_jax``, ``save_msgpack``;
  ``tools/torch_convert_checkpoint.py`` on the command line).

``Trainer`` and ``InferenceEngine`` are exported lazily, as the JAX
package exports them; ``examples/torch_quickstart.py`` drives them.

The TPU kernels on those paths are hand-written CUDA: the streaming
Hopfield forward and its two backward kernels (K1 to K3,
``csrc/hopfield_stream_{fwd,bwd_dx,bwd_dku}.cu``), the fused bottleneck
forward (K4, ``csrc/hopfield_bottleneck_fused.cu``) and the prior's
causal flash attention (K5, ``csrc/causal_attention_{fwd,bwd}.cu``).
"""

from hopvae_torch.config import MakeConfig, load_config
from hopvae_torch.models.hopvae import HopVAE

__version__ = "0.1.0"

__all__ = ["MakeConfig", "load_config", "HopVAE", "Trainer", "InferenceEngine", "__version__"]


def __getattr__(name):  # lazy: importing the package leaves train and serving unloaded
    if name == "Trainer":
        from hopvae_torch.train import Trainer

        return Trainer
    if name == "InferenceEngine":
        from hopvae_torch.serving import InferenceEngine

        return InferenceEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
