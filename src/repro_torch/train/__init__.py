"""repro_torch.train (port of repro.train)."""
