"""The train step: loss -> grads -> AdamW (port of ``repro/train/step.py``).

``make_train_step(cfg, opt_cfg, ...)`` builds ``train_step(state, batch) ->
(state, metrics)``. Gradients come from ``torch.autograd.grad`` through the
model's float32 master weights; ``accum > 1`` splits the batch into
microbatches and averages their float32 gradient sums, as the JAX
``lax.scan`` does. ``cfg.loss_impl`` selects the cross-entropy log-softmax
(train/losses.py). The state is updated in place (optim/adamw.py).

``checkpoint_tree`` / ``load_checkpoint_tree`` convert a state to and from
the JAX ``TrainState`` layout that ``checkpoint.manager`` writes.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine


class TrainState(NamedTuple):
    params: Any             # models.transformer.Transformer (master weights)
    opt: adamw.AdamWState   # moments keyed by the module's parameter names
    err: Any                # error-feedback buffers: None (no compression)


def _no_compress(compress: bool) -> None:
    if compress:
        raise NotImplementedError(
            "gradient compression is not ported yet (ROADMAP A.12: "
            "distributed/compression.py)")


def _check_trainable(cfg) -> None:
    if set(cfg.block_pattern) != {"dense"}:
        raise NotImplementedError(
            f"training block pattern {sorted(set(cfg.block_pattern))} is not "
            "ported yet (ROADMAP A.11: MLA/MoE training); the port trains "
            "dense GQA models and serves MLA/MoE ones")


def named_params(params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters())


def init_state(cfg, seed: int, opt_cfg: adamw.AdamWConfig, *,
               compress: bool = False, dtype=torch.float32,
               device=None) -> TrainState:
    """Fresh master weights (``dtype``) from ``seed`` and zero moments."""
    _no_compress(compress)
    _check_trainable(cfg)
    params = tf.init(cfg, seed, resolve_device(device), dtype=dtype)
    return TrainState(params=params, opt=adamw.init(named_params(params)),
                      err=None)


def checkpoint_tree(state: TrainState, like: bool = False) -> TrainState:
    """The JAX ``TrainState`` layout of ``state``: host numpy copies (or
    meta tensors with ``like=True``), seg0 leaves stacked over layers."""
    cfg = state.params.cfg
    step = state.opt.step
    return TrainState(
        params=tf.jax_tree(cfg, named_params(state.params), like),
        opt=adamw.AdamWState(
            step=(torch.empty((), dtype=step.dtype, device="meta") if like
                  else step.detach().to("cpu", copy=True).numpy()),
            mu=tf.jax_tree(cfg, state.opt.mu, like),
            nu=tf.jax_tree(cfg, state.opt.nu, like)),
        err=None)


def load_checkpoint_tree(state: TrainState, tree: TrainState) -> TrainState:
    """Copy a checkpoint tree (``manager.restore`` of ``checkpoint_tree(
    state, like=True)``) into ``state``'s tensors, in place."""
    cfg = state.params.cfg
    for named, sub in ((named_params(state.params), tree.params),
                       (state.opt.mu, tree.opt.mu), (state.opt.nu, tree.opt.nu)):
        tf.copy_into(named, tf.from_jax_flat(cfg, tf.flatten_params(sub)))
    state.opt.step.copy_(torch.as_tensor(tree.opt.step))
    return state


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *, accum: int = 1,
                    compress: bool = False, warmup_steps: int = 100,
                    total_steps: int = 10000):
    """Returns train_step(state, batch) -> (state, metrics)."""
    _no_compress(compress)
    _check_trainable(cfg)

    def grads_of(params, batch):
        named = named_params(params)
        loss, metrics = tf.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), metrics, dict(zip(named, grads))

    def compute_grads(params, batch):
        if accum == 1:
            return grads_of(params, batch)
        B = batch["labels"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} microbatches")
        mb = B // accum
        g_sum, l_sum = None, 0.0
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _, g = grads_of(params, micro)
            if g_sum is None:
                g_sum = {k: torch.zeros_like(v, dtype=torch.float32)
                         for k, v in g.items()}
            g_sum = {k: g_sum[k] + g[k] for k in g_sum}
            l_sum = l_sum + loss
        loss = l_sum / accum
        return loss, {"loss": loss, "aux": torch.zeros_like(loss)}, \
            {k: g / accum for k, g in g_sum.items()}

    def train_step(state: TrainState, batch):
        loss, metrics, grads = compute_grads(state.params, batch)
        lr_scale = warmup_cosine(state.opt.step, warmup_steps=warmup_steps,
                                 total_steps=total_steps)
        _, new_opt, opt_m = adamw.apply_updates(
            named_params(state.params), state.opt, grads, opt_cfg, lr_scale)
        out = {"loss": loss, "grad_norm": opt_m["grad_norm"],
               "lr_scale": lr_scale,
               **{k: v.detach() for k, v in metrics.items() if k != "loss"}}
        return TrainState(state.params, new_opt, state.err), out

    return train_step


def make_eval_step(cfg):
    """eval_step(params, batch) -> metrics, without gradients."""
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = tf.loss_fn(params, batch, cfg)
        return metrics
    return eval_step
