"""The training step: train state, optimizers and the two-phase GAN step."""
