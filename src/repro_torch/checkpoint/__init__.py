"""repro_torch.checkpoint (port of repro.checkpoint)."""
