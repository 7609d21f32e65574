"""repro_torch.serve (port of repro.serve)."""
