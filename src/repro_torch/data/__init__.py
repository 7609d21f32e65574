"""repro_torch.data (port of repro.data)."""
