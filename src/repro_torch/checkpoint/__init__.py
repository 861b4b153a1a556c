"""Checkpoints of LM training sessions, in the JAX package's on-disk
format."""
