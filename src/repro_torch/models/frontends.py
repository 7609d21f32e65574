"""Stub modality frontends (port of ``repro/models/frontends.py``): the
audio and vision frontends are stubs, and their precomputed frame / patch
embeddings are the inputs of the ``input_mode="embeds"`` archs
(musicgen-large, internvl2-1b); the transformer backbone is the real model.

The draws are the JAX stubs' own (``numpy.random.default_rng(seed)``,
N(0, 0.02^2) in float64, cast to float32), returned as a tensor on
``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _stub(batch: int, seq: int, d_model: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 0.02, (batch, seq, d_model)).astype(np.float32)
    return torch.from_numpy(a).to(resolve_device(device))


def audio_frame_embeddings(batch: int, seq: int, d_model: int, *, seed: int = 0,
                           device=None) -> torch.Tensor:
    """MusicGen stub: EnCodec frame embeddings (B,S,d). In the real system
    they come from the frozen EnCodec encoder and the codebook embedding
    sum; here they are precomputed inputs."""
    return _stub(batch, seq, d_model, seed, device)


def vision_patch_embeddings(batch: int, seq: int, d_model: int, *, seed: int = 0,
                            device=None) -> torch.Tensor:
    """InternVL2 stub: InternViT patch embeddings projected to the LM width,
    concatenated with text embeddings upstream: delivered precomputed."""
    return _stub(batch, seq, d_model, seed, device)
