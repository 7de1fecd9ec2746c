"""Training: optimizers, train/prefill/serve steps, data, checkpoints, fault
tolerance and gradient compression (counterpart of ``repro.training``)."""
