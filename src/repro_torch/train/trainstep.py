"""The train step of a ``BlockedCNN``, the port of the ``BlockedCNN`` branch
of ``repro/train/trainstep.py`` (``make_loss_fn``, ``make_train_step``), and
the language models' full-sequence forward (``forward``,
``make_prefill_step``, inference only: training a language model is a later
slice, ROADMAP queue A item 13).

The loss is the f32 cross-entropy of the class logits.  Gradients come from
autograd, which runs every conv's backward through the dgrad and wgrad
kernels on the card (``kernels.conv_autograd.BlockedConvFunction``) and
through their plain versions on the CPU.  ``context`` (a ``ConvContext``,
the counterpart of the reference's ``TrainSettings.context``) reaches every
layer of the forward, and through the autograd functions the backward: with
``ConvContext(stream=True)`` the streamed forward, dgrad and wgrad kernels
carry the step, and under ``ConvContext(precision="bf16")`` their bf16
builds (the dense model; the separable kernels refuse it): the layers
chain in bf16, the masters, their gradients and AdamW stay f32, and the
logits reach the loss in f32.  With ``accum_steps > 1`` the batch
is split along dim 0 into microbatches whose gradients are averaged, as the
reference's ``lax.scan`` does.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import ConvContext, as_context
from repro_torch.nn.conv import BlockedCNN
from repro_torch.nn.models import LM
from repro_torch.train.losses import cross_entropy
from repro_torch.train.optimizer import AdamW, OptState

__all__ = ["forward", "make_loss_fn", "make_train_step",
           "make_prefill_step"]

Batch = Mapping[str, torch.Tensor]


def forward(model: LM, batch: Batch, *, train: bool = False,
            chunk: int = 2048):
    """A language model's forward over ``batch["tokens"]`` -> (logits,
    aux), inference only: ``train=True`` raises until the LM-training
    slice."""
    if train:
        raise NotImplementedError(
            "training a language model is not ported yet (ROADMAP queue A "
            "item 13); forward runs with train=False")
    return model(batch["tokens"], chunk=chunk)


def make_prefill_step(model: LM, cfg: ModelConfig, chunk: int = 2048
                      ) -> Callable[[Batch], torch.Tensor]:
    """Full-sequence forward (inference prefill): ``prefill_step(batch) ->
    logits`` for every position, without autograd."""
    if model.cfg != cfg:
        raise ValueError(f"model is {model.cfg.name}, cfg is {cfg.name}")

    def prefill_step(batch: Batch) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = forward(model, batch, train=False, chunk=chunk)
        return logits
    return prefill_step


def make_loss_fn(model: BlockedCNN, context: Optional[ConvContext] = None
                 ) -> Callable[[Batch], Tuple[torch.Tensor, Dict]]:
    """-> ``loss_fn(batch) -> (loss, metrics)`` for a batch with NHWC
    ``images`` and integer ``targets``, the model run under ``context``."""
    ctx = as_context(context)

    def loss_fn(batch: Batch):
        logits = model(batch["images"], context=ctx).to(torch.float32)
        loss, metrics = cross_entropy(logits[:, None, :],
                                      batch["targets"][:, None],
                                      model.n_classes)
        return loss, metrics
    return loss_fn


def make_train_step(model: BlockedCNN, optimizer: AdamW,
                    accum_steps: int = 1,
                    context: Optional[ConvContext] = None
                    ) -> Callable[[OptState, Batch], Tuple[torch.Tensor, Dict]]:
    """-> ``train_step(opt_state, batch) -> (loss, metrics)``.

    The step updates ``model``'s parameters and ``opt_state`` (the moments
    and the step count, as made by ``optimizer.init(dict(
    model.named_parameters()))``) **in place**; it returns the loss (mean
    over microbatches) and the metrics ``nll``, ``accuracy``, ``tokens``,
    ``grad_norm`` and ``lr``.  The parameters' ``.grad`` hold the averaged
    gradients after the call."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    loss_fn = make_loss_fn(model, context)
    params = dict(model.named_parameters())

    def train_step(opt_state: OptState, batch: Batch):
        n = batch["images"].shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} does not split into {accum_steps} "
                             "microbatches")
        for p in params.values():
            p.grad = None
        m = n // accum_steps
        stats = []
        for k in range(accum_steps):
            micro = {key: v[k * m:(k + 1) * m] for key, v in batch.items()}
            loss, metrics = loss_fn(micro)
            loss.backward()
            stats.append(dict(metrics, loss=loss.detach()))
        if accum_steps > 1:
            for p in params.values():
                p.grad.div_(accum_steps)
        metrics = {key: torch.stack([s[key].detach() for s in stats]).mean()
                   for key in stats[0]}
        grads = {name: p.grad for name, p in params.items()}
        metrics.update(optimizer.update(grads, opt_state, params))
        return metrics.pop("loss"), metrics

    return train_step
