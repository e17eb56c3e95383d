"""Training: train state, the diffusion step, checkpoints and the log."""
