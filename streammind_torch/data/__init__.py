"""Sample construction for training."""
