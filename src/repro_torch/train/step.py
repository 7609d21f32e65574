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

On a mesh (``mesh=``, launch/mesh.py: one process per rank of a ("data",
"model") layout) the step is the JAX ``make_train_step`` jitted on
``state_shardings``, written out: each rank holds the training cut of the
weights (models/transformer.py) and, of each of the ``accum`` global
microbatches, its data rank's share of the rows (``rank_rows``). Its loss
and gradients are those of the one-device step on the global batch, up to
float32 order:

1. forward and backward through the blocks' collectives
   (distributed/sharding.py), microbatch by microbatch;
   the loss's masked mean and the MoE aux loss reduce over the data axes;
2. the ranges of the rank's gradients that are partial sums (whole leaves
   it reads in part: ``shd.partial_leaves``) summed over the model axis
   once, in one buffer;
3. every gradient summed over the data axes, leaf by leaf;
4. with ``compress``, the int8 error-feedback round trip on the reduced
   gradients, each cut leaf's scale from a MAX all-reduce of its amax over
   the model axis (the whole leaf's scale, codes and residual);
5. the global norm: the squares of the cut parts summed over the model
   axis, those of the whole parts counted once, so every rank clips by
   one scalar;
6. AdamW; under ``zero1`` each data rank holds the moments of its slice
   of each leaf (``shd.zero1_slices``, the JAX ``_zero1_extend``), updates
   that slice and gathers the parameter over the data axes. AdamW works
   element by element, so the parameters are bit for bit those without.

``gathered_tree`` puts a rank's state together into the JAX
``TrainState`` layout (tests). ``rank_train`` (launch/train.py) runs it on
spawned ranks.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine


class TrainState(NamedTuple):
    params: Any             # models.transformer.Transformer (master weights)
    opt: adamw.AdamWState   # moments keyed by the module's parameter names
    err: Any                # error-feedback buffers keyed as opt.mu, or None


def named_params(params) -> Dict[str, torch.Tensor]:
    return dict(params.named_parameters())


def _narrow(t: torch.Tensor, rng) -> torch.Tensor:
    return t if rng is None else t.narrow(rng[0], rng[1], rng[2] - rng[1])


def init_state(cfg, seed: int, opt_cfg: adamw.AdamWConfig, *,
               compress: bool = False, dtype=torch.float32,
               device=None, mesh=None, zero1: bool = False) -> TrainState:
    """Fresh master weights (``dtype``) from ``seed``, zero moments and, with
    ``compress``, zero error-feedback buffers. On a ``mesh``: the rank's
    training cut of the same weights, and under ``zero1`` the moments of
    its data slice of each leaf."""
    params = tf.init(cfg, seed, resolve_device(device), dtype=dtype, mesh=mesh,
                     train=True)
    named = named_params(params)
    slices = shd.zero1_slices(params, mesh) if zero1 else {}
    opt = adamw.init({k: _narrow(p, slices.get(k)) for k, p in named.items()})
    return TrainState(params=params, opt=opt,
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


def _sum_ranges(grads, ranges, mesh) -> None:
    """Sum the given ranges of the gradients over the model axis in one
    buffer, in place."""
    pieces = [_narrow(grads[k], r) for k, rs in ranges.items() for r in rs]
    if not pieces or mesh.tp == 1:
        return
    flat = shd.reduce_(torch.cat([p.reshape(-1) for p in pieces]), mesh, "model")
    o = 0
    for p in pieces:
        p.copy_(flat[o:o + p.numel()].view_as(p))
        o += p.numel()


def mesh_global_norm(grads, ranges, mesh) -> torch.Tensor:
    """The whole gradients' global norm from a rank's slices: the squares
    of the cut ranges summed over the model axis, the whole ones counted
    once (``ranges``: ``shd.leaf_ranges``)."""
    sq = lambda t: t.to(torch.float32).square().sum()
    zero = torch.zeros((), dtype=torch.float32,
                       device=next(iter(grads.values())).device)
    cut, whole = zero.clone(), zero.clone()
    for k, g in grads.items():
        c, w = ranges[k]
        for r in c:
            cut = cut + sq(_narrow(g, r))
        for r in w:
            whole = whole + sq(_narrow(g, r))
    return torch.sqrt(shd.reduce_(cut, mesh, "model") + whole)


def gather_zero1_(params, slices, mesh) -> None:
    """Each leaf updated in ZeRO-1 slices, gathered over the data axes in
    place."""
    for k, (dim, lo, hi) in slices.items():
        p = params[k]
        p.copy_(torch.cat(shd.all_gather(p.narrow(dim, lo, hi - lo), mesh, "data"),
                          dim=dim))


def compress_(grads, err, mesh=None) -> None:
    """The int8 error-feedback round trip, in place; on a mesh each leaf's
    scale is the whole leaf's (a MAX all-reduce of the amaxes over the
    model axis)."""
    comp.compress_grads_(grads, err, None if mesh is None else
                         lambda a: shd.reduce_(a, mesh, "model", "max"))


@torch.no_grad()
def reduce_grads(params, grads, cfg, mesh) -> None:
    """A rank's gradients reduced in place (steps 2-3 of the module
    docstring): the partial ranges summed over the model axis in one
    buffer, then every leaf over the data axes."""
    _sum_ranges(grads, shd.partial_leaves(params, cfg), mesh)
    if mesh.dp > 1:
        for g in grads.values():
            shd.reduce_(g, mesh, "data")


def rank_rows(rows: int, mesh, accum: int = 1) -> list:
    """The indices of the rows of a global batch of ``rows`` that a data
    rank takes, in its microbatch order: of each global microbatch i (rows
    [i * rows / accum, (i + 1) * rows / accum), as the JAX ``lax.scan``
    splits the batch) its data rank's 1/dp share, so that the rank's i-th
    microbatch is its share of global microbatch i."""
    if rows % (accum * mesh.dp):
        raise ValueError(f"batch {rows} does not split into {accum} microbatches "
                         f"over {mesh.dp} data ranks")
    mb = rows // accum
    share = mb // mesh.dp
    lo = mesh.data_rank * share
    return [i * mb + lo + j for i in range(accum) for j in range(share)]


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *, accum: int = 1,
                    compress: bool = False, warmup_steps: int = 100,
                    total_steps: int = 10000, mesh=None, zero1: bool = False):
    """Returns train_step(state, batch) -> (state, metrics). ``mesh``: the
    step of one rank of a ("data", "model") mesh on its rows of the global
    batch (``rank_rows``), ``zero1`` its moments cut over the data axes
    (module docstring)."""

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
        gn = slices = None
        if mesh is not None:
            reduce_grads(state.params, grads, cfg, mesh)
        if compress:                    # in place: grads and state.err
            compress_(grads, state.err, mesh)
        if mesh is not None:
            gn = mesh_global_norm(grads, shd.leaf_ranges(state.params), mesh)
            slices = shd.zero1_slices(state.params, mesh) if zero1 else None
        lr_scale = warmup_cosine(state.opt.step, warmup_steps=warmup_steps,
                                 total_steps=total_steps)
        params = named_params(state.params)
        _, new_opt, opt_m = adamw.apply_updates(
            params, state.opt, grads, opt_cfg, lr_scale, gn=gn, slices=slices)
        if slices:
            with torch.no_grad():
                gather_zero1_(params, slices, mesh)
        out = {"loss": loss, "grad_norm": opt_m["grad_norm"],
               "lr_scale": lr_scale,
               **{k: v.detach() for k, v in metrics.items() if k != "loss"}}
        return TrainState(state.params, new_opt, state.err), out

    return train_step


def gathered_tree(state: TrainState, mesh, zero1: bool = False) -> TrainState:
    """A rank's state put together into the JAX ``TrainState`` layout
    (``checkpoint_tree``'s host numpy copies): ZeRO-1 moments gathered over
    the data axes, every cut leaf over the model axis. Every rank gets the
    whole tree; a collective per leaf (tests, not the step)."""
    model, cfg = state.params, state.params.cfg
    slices = shd.zero1_slices(model, mesh) if zero1 else {}

    def whole(named, sliced=False):
        if sliced:
            named = {k: (torch.cat(shd.all_gather(v, mesh, "data"), dim=slices[k][0])
                         if k in slices else v) for k, v in named.items()}
        return tf.jax_tree(cfg, shd.full_tensors(model, named))

    step = state.opt.step
    with torch.no_grad():
        return TrainState(
            params=whole(named_params(model)),
            opt=adamw.AdamWState(step=step.detach().to("cpu", copy=True).numpy(),
                                 mu=whole(state.opt.mu, True),
                                 nu=whole(state.opt.nu, True)),
            err=None if state.err is None else whole(state.err))


def make_eval_step(cfg):
    """eval_step(params, batch) -> metrics, without gradients."""
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = tf.loss_fn(params, batch, cfg)
        return metrics
    return eval_step
