"""Training loop: the early-exit multi-ramp objective and AdamW (the JAX
package's ``training/loop.py``).

``make_train_step`` builds the step function that ``train``, the
launcher (``launch/train.py``) and the example
(``examples/train_ee.py``) run.  Parameters are f32 master tensors
that a step updates in place; gradients are taken with
``torch.autograd.grad`` against per-step leaves, so the parameters
themselves never carry autograd state.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import tree_leaves
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)

__all__ = ["make_train_step", "train"]


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken in order from ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    ramp_loss_weight: float = 0.3, remat: bool = True,
                    num_microbatches: int = 1,
                    mixed_precision: bool = True) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params,
    opt_state, metrics), updating params and opt_state in place; batch
    holds ``tokens`` and ``labels`` tensors on the parameters' device.

    ``num_microbatches`` m > 1 accumulates gradients over m
    microbatches, microbatch j being rows {i*m + j} (the JAX package's
    split); gradients and metrics are summed in f32 and divided by m.

    ``mixed_precision`` keeps the f32 master weights and moments but
    runs the forward and backward passes in bf16 on bf16 casts of the
    f32 leaves (cast once a step); the gradients come back as f32."""

    def grads_and_metrics(params, batch):
        masters = tree_leaves(params)
        if mixed_precision:
            ws = [(p.detach().to(torch.bfloat16) if p.dtype == torch.float32
                   else p.detach()).requires_grad_() for p in masters]
        else:
            ws = [p.detach().requires_grad_() for p in masters]
        p_c = _rebuild(params, iter(ws))
        m = max(num_microbatches, 1)
        g_acc = [torch.zeros_like(p, dtype=torch.float32) for p in masters]
        metrics: dict = {}
        for j in range(m):
            micro = {k: v[j::m] for k, v in batch.items()} if m > 1 \
                else batch
            loss, metr = M.forward_train(p_c, cfg, micro,
                                         ramp_loss_weight=ramp_loss_weight,
                                         remat=remat)
            grads = torch.autograd.grad(loss, ws)
            with torch.no_grad():
                for a, g in zip(g_acc, grads):
                    a.add_(g.float())
                for k, v in metr.items():
                    v = v.detach().float()
                    metrics[k] = metrics[k] + v if k in metrics else v
        if m > 1:
            g_acc = [g / m for g in g_acc]
            metrics = {k: v / m for k, v in metrics.items()}
        return _rebuild(params, iter(g_acc)), metrics

    def train_step(params, opt_state, batch):
        grads, metrics = grads_and_metrics(params, batch)
        params, opt_state, opt_metrics = adamw_update(opt_cfg, params,
                                                      grads, opt_state)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def train(cfg: ModelConfig, opt_cfg: AdamWConfig, params, data_iter, *,
          steps: int, log_every: int = 10, ckpt_dir: str | None = None,
          ckpt_every: int = 200):
    """Single-device training loop: ``steps`` steps of the default
    train step (mixed precision, remat) on numpy batches from
    ``data_iter``, moved to the parameters' device.  Logs (and keeps in
    the history) every ``log_every`` steps and the last; saves
    ``{"params"}`` to ``ckpt_dir/state_N.ckpt`` every ``ckpt_every``."""
    step_fn = make_train_step(cfg, opt_cfg)
    device = tree_leaves(params)[0].device
    opt_state = init_opt_state(params)
    history = []
    t0 = time.time()
    for step in range(steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data_iter).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall"] = time.time() - t0
            history.append(m)
            print(f"step {step:5d} loss {m['loss']:.4f} "
                  f"ce_final {m['ce_final']:.4f} "
                  f"gnorm {m['grad_norm']:.3f}", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            checkpoint.save(f"{ckpt_dir}/state_{step + 1}.ckpt",
                            {"params": params}, step + 1)
    return params, opt_state, history
