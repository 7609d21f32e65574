"""The train step: loss -> grads -> AdamW (port of ``repro/train/step.py``).

``make_train_step(cfg, opt_cfg, ...)`` builds ``train_step(state, batch) ->
(state, metrics)`` for every block kind and the shared block. Gradients come
from ``torch.autograd.grad`` through the model's float32 master weights; a
leaf the loss does not read (the ``embed`` table under
``input_mode="embeds"``) gets a zero gradient, as ``jax.grad`` gives it, so
AdamW and the checkpoint keep the JAX layout. ``accum > 1`` splits the
batch into microbatches and averages their float32 gradient sums, as the
JAX ``lax.scan`` does. ``compress=True`` passes the gradients through the
int8 error-feedback round trip (distributed/compression.py) before AdamW,
its buffers in ``TrainState.err``. ``cfg.loss_impl`` selects the
cross-entropy log-softmax (train/losses.py), ``cfg.remat`` the per-block
rematerialisation (models/transformer.py). The state is updated in place
(optim/adamw.py).

``checkpoint_tree`` / ``load_checkpoint_tree`` convert a state to and from
the JAX ``TrainState`` layout that ``checkpoint.manager`` writes, the
error-feedback buffers included.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.distributed import compression as comp
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine


class TrainState(NamedTuple):
    params: Any             # models.transformer.Transformer (master weights)
    opt: adamw.AdamWState   # moments keyed by the module's parameter names
    err: Any                # error-feedback buffers keyed as opt.mu, or None


def named_params(params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters())


def init_state(cfg, seed: int, opt_cfg: adamw.AdamWConfig, *,
               compress: bool = False, dtype=torch.float32,
               device=None) -> TrainState:
    """Fresh master weights (``dtype``) from ``seed``, zero moments and, with
    ``compress``, zero error-feedback buffers."""
    params = tf.init(cfg, seed, resolve_device(device), dtype=dtype)
    named = named_params(params)
    return TrainState(params=params, opt=adamw.init(named),
                      err=comp.init_error_state(named) if compress else None)


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
        err=None if state.err is None else tf.jax_tree(cfg, state.err, like))


def load_checkpoint_tree(state: TrainState, tree: TrainState) -> TrainState:
    """Copy a checkpoint tree (``manager.restore`` of ``checkpoint_tree(
    state, like=True)``) into ``state``'s tensors, in place."""
    cfg = state.params.cfg
    pairs = [(named_params(state.params), tree.params),
             (state.opt.mu, tree.opt.mu), (state.opt.nu, tree.opt.nu)]
    if state.err is not None:
        pairs.append((state.err, tree.err))
    for named, sub in pairs:
        tf.copy_into(named, tf.from_jax_flat(cfg, tf.flatten_params(sub)))
    state.opt.step.copy_(torch.as_tensor(tree.opt.step))
    return state


def grads_of(params, batch, cfg):
    """(loss, metrics, {name: gradient}) of ``tf.loss_fn`` under ``cfg``; a
    leaf the loss does not read gets zeros, as ``jax.grad`` gives it."""
    named = named_params(params)
    loss, metrics = tf.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), metrics, {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(named.items(), grads)}


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *, accum: int = 1,
                    compress: bool = False, warmup_steps: int = 100,
                    total_steps: int = 10000):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def compute_grads(params, batch):
        if accum == 1:
            return grads_of(params, batch, cfg)
        B = batch["labels"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} microbatches")
        mb = B // accum
        g_sum, l_sum = None, 0.0
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _, g = grads_of(params, micro, cfg)
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
        if compress:                    # in place: grads and state.err
            comp.compress_grads_(grads, state.err)
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
