"""Training of the learned nets: losses, the SGDR schedule, checkpoints,
metric files and the training loop."""
