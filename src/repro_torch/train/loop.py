"""Training-step builders (port of ``repro.train.loop``, one device).

``make_train_step(model, optimizer, microbatches)`` returns
``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``:
with ``microbatches`` k > 1 the batch is cut into k slices of B/k along its
first dim, their gradients summed in float32 and divided by k, the loss
averaged, then one optimizer update.  Gradients are taken functionally
(``torch.autograd.grad``) with respect to the tree's floating-point leaves,
which must require them (``Params.trainable_()``); a leaf the loss does not
reach (every MLP ``gate`` under ``lut_activations``) gets a zero gradient,
as ``jax.grad`` gives it.

The reference's explicit data-parallel step with compressed all-reduce
(``make_dp_train_step``) is a later slice of the port and raises.
"""
from __future__ import annotations

import torch

#: ROADMAP item that ports the data-parallel trainer
DP_TODO = ("the data-parallel trainer (make_dp_train_step, gradient "
           "compression) is not ported yet: ROADMAP queue 1 item 12b")


def value_and_grad(model, params, batch: dict):
    """``(loss, grads)``: the loss of ``batch`` (detached) and its gradient
    for every floating-point leaf, a dict by ``named_parameters()`` name."""
    named = {n: p for n, p in params.named_parameters()
             if p.is_floating_point()}
    frozen = [n for n, p in named.items() if not p.requires_grad]
    if frozen:
        raise ValueError(f"{len(frozen)} leaves (first {frozen[0]!r}) do not "
                         f"require a gradient: call params.trainable_()")
    with torch.enable_grad():
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
    return loss.detach(), {
        n: g if g is not None else torch.zeros_like(p)
        for (n, p), g in zip(named.items(), grads)}


def _split(x, k: int, i: int):
    b = x.shape[0]
    if b % k:
        raise ValueError(f"batch {b} does not split into {k} microbatches")
    return x[i * (b // k):(i + 1) * (b // k)]


def make_train_step(model, optimizer, microbatches: int = 1):
    """Returns ``train_step(params, opt_state, batch)``; metrics hold the
    float32 ``loss`` and ``grad_norm`` (0-d tensors on the device)."""

    def train_step(params, opt_state, batch: dict):
        if microbatches == 1:
            loss, grads = value_and_grad(model, params, batch)
        else:
            grads, loss_sum = None, None
            for i in range(microbatches):
                mb = {k: _split(v, microbatches, i) for k, v in batch.items()}
                loss, g = value_and_grad(model, params, mb)
                if grads is None:
                    grads = {n: gg.to(torch.float32) for n, gg in g.items()}
                    loss_sum = loss.to(torch.float32)
                else:
                    for n, gg in g.items():
                        grads[n].add_(gg.to(torch.float32))
                    loss_sum = loss_sum + loss
            grads = {n: g / microbatches for n, g in grads.items()}
            loss = loss_sum / microbatches
        params, opt_state, gnorm = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.to(torch.float32),
                                   "grad_norm": gnorm}

    return train_step


def make_eval_step(model):
    def eval_step(params, batch: dict) -> torch.Tensor:
        with torch.no_grad():
            return model.loss(params, batch).to(torch.float32)
    return eval_step


def make_dp_train_step(model, optimizer, mesh=None, *, compress=False):
    raise NotImplementedError(DP_TODO)
