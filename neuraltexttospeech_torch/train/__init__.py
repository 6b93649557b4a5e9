"""Training-loop support: checkpoints."""
