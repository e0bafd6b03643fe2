"""The labs on the card: microbenchmarks of the flash kernel bodies and of
a LayerNorm fused into a matmul.

Each lab mirrors a JAX lab of ``scripts/`` (which run on a TPU) and runs on
a CUDA card only:

* ``exp_flash_variants``: softmax policies and K/V stage depth of the
  forward (``scripts/exp_flash_variants.py``);
* ``exp_flash_fwd_tilings``: the shipped forward at explicit tilings
  (``scripts/exp_flash_fwd_tilings.py``);
* ``exp_flash_bwd_variants``: the shipped backward at explicit tilings, and
  its no-softmax control (``scripts/exp_flash_bwd_variants.py``);
* ``exp_ln_matmul``: LayerNorm in a matmul's prologue against the LN
  kernel + library matmul pair (``scripts/exp_ln_matmul.py``).

Run one as ``python -m vqvae_from_gaussian_vae_tpu_torch.labs.<lab> [combo
...]``.  Importing this package imports nothing but torch and numpy.
"""
