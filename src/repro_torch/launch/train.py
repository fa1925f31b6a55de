"""Training launcher of the port: the early-exit multi-ramp objective
with AdamW on the synthetic pipeline, on one device (the JAX package's
``launch/train.py`` with a one-device mesh).

  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-ee-100m \
      --steps 200 --batch 8 --seq 256 [--smoke] [--ckpt-dir DIR]

It runs on the card (``--device cuda``, the default) and refuses to go
on when CUDA is missing; ``--device cpu`` runs on the CPU.  Parameters
come from `materialize` with a ``torch.Generator`` seeded with 0; the
step runs in bf16 on f32 master weights, with per-layer recomputation.
``--mesh`` takes ``1x1`` only.  With ``--ckpt-dir`` it saves
``{"params"}`` every 100 steps as ``state_N.ckpt``, in the checkpoint
format both packages read, and also after the last step (the JAX
launcher saves at the hundreds only), so a short run leaves a
checkpoint to serve with ``launch.serve --ckpt``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.launch.serve import device_of
from repro_torch.models import model as M
from repro_torch.models.param import materialize
from repro_torch.training import checkpoint
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import AdamWConfig, init_opt_state

__all__ = ["main"]

CKPT_EVERY = 100


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="paper-ee-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="1x1",
                    help="data x model mesh; the port trains on one "
                         "device, so only 1x1")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Train; returns the logged metrics (one dict a logged step)."""
    args = parse_args(argv)
    if args.mesh != "1x1":
        raise SystemExit(f"--mesh {args.mesh}: the port trains on one "
                         "device; meshes and sharding are not ported yet "
                         "(ROADMAP A10)")
    device = device_of(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1))
    params = materialize(M.model_defs(cfg),
                         torch.Generator(device=device).manual_seed(0),
                         device)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg,
                              num_microbatches=args.microbatches)
    it = batches(DataConfig(vocab=cfg.vocab, seq_len=args.seq + 1,
                            global_batch=args.batch))
    history = []
    t0 = time.time()
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in next(it).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            mm = {k: float(v) for k, v in metrics.items()}
            history.append(dict(mm, step=step))
            print(f"step {step:5d} loss {mm['loss']:.4f} "
                  f"ce_final {mm['ce_final']:.4f} "
                  f"lr {mm['lr']:.2e} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_dir and ((step + 1) % CKPT_EVERY == 0
                              or step == args.steps - 1):
            checkpoint.save(f"{args.ckpt_dir}/state_{step + 1}.ckpt",
                            {"params": params}, step + 1)
    print("done", flush=True)
    return history


if __name__ == "__main__":
    main()
