"""Entry points of the LM path: serving, the training step and the
training loop."""
