"""vidsitu_tpu_torch: the PyTorch / CUDA port of vidsitu_tpu for NVIDIA
Hopper GPUs. It stands alone: it keeps its own copies of the host-side
layers (config, tokenization, native cores, data, metrics, converters) and
imports neither vidsitu_tpu nor jax, flax, optax or orbax.
"""

__version__ = "0.1.0"
