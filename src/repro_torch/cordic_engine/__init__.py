"""repro_torch.cordic_engine (port of repro.cordic_engine)."""
