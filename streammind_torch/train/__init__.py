"""Training: stage selection, objectives, optimizer, sampler and the train() loop."""
