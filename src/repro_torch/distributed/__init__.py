"""repro_torch.distributed (port of repro.distributed)."""
