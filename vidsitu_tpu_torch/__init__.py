"""vidsitu_tpu_torch: the PyTorch / CUDA port of vidsitu_tpu for NVIDIA
Hopper GPUs. It shares vidsitu_tpu's JAX-free host layers (config, data,
converters) and never imports jax or flax.
"""

__version__ = "0.1.0"
