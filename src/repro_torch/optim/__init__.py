"""repro_torch.optim (port of repro.optim)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    init,
)
from repro_torch.optim import schedule  # noqa: F401
