"""The GAN loss head: LPIPS, the PatchGAN discriminator and the two-phase loss."""
