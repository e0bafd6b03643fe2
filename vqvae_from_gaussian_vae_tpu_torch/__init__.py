"""PyTorch + CUDA port of the Gaussian-VAE -> VQ-VAE image tokenizer.

A second package beside the JAX one (``vqvae_from_gaussian_vae_tpu``), which
stays the reference.  It imports ``torch`` and never ``jax``, and nothing of
the JAX package.  Ported so far: the sd3unet_gq tokenization path at
inference (encode -> Gaussian-quant search -> dequant / decode), with a
hand-written CUDA kernel for each TPU kernel on that path (``csrc/``).

Layout mirrors the JAX package:
  utils/        config registry (the shipped YAMLs load unchanged), FLOP
                counts, weight conversion from the JAX package
  models/       UNet Encoder / Decoder, AutoencodingEngine
  quantization/ GaussianQuantRegularizer (eval branch)
  ops/          codebook, GQ search, fused resample convs, flash attention;
                each kernel beside its plain PyTorch version
  csrc/         the CUDA sources, built with nvcc at first use
"""

__version__ = "0.1.0"

from vqvae_from_gaussian_vae_tpu_torch.utils.config import instantiate_from_config, load_config

__all__ = ["instantiate_from_config", "load_config"]
