"""Checkpoints and losses of the learned net (the training loop is not ported yet)."""
