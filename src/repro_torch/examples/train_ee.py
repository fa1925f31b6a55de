"""Train an early-exit LM end to end on the synthetic pipeline (the JAX
package's ``examples/train_ee.py``).

Trains the paper-native EE config (paper-ee-100m, a ramp every 2 layers)
or its smoke variant with the multi-ramp objective, saves checkpoints,
then exports per-node calibration traces for T-Tamer:

  # fast demo (smoke config, on the CPU):
  PYTHONPATH=src python -m repro_torch.examples.train_ee --smoke \
      --device cpu --steps 60
  # the real thing (a few hundred steps of the 100M model, on the card):
  PYTHONPATH=src python -m repro_torch.examples.train_ee --steps 300

Checkpoints go to ``--ckpt-dir`` every 200 steps and after the last
step (``state_N.ckpt``; serve one with ``launch.serve --ckpt``); the
node losses of one held-out batch's last position go to
``calibration.npz`` beside them.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.launch.serve import device_of
from repro_torch.models import model as M
from repro_torch.models.param import materialize
from repro_torch.training import checkpoint
from repro_torch.training.loop import train
from repro_torch.training.optimizer import AdamWConfig


def main(argv=None) -> dict:
    """Train and export; returns the paths written and the history."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="build/ee_ckpt")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    cfg = get_config("paper-ee-100m", smoke=args.smoke)
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"ramps={cfg.n_ramps}")
    opt_cfg = AdamWConfig(lr=6e-4, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1))
    params = materialize(M.model_defs(cfg),
                         torch.Generator(device=device).manual_seed(0),
                         device)
    data = batches(DataConfig(vocab=cfg.vocab, seq_len=args.seq + 1,
                              global_batch=args.batch))
    params, _, history = train(cfg, opt_cfg, params, data,
                               steps=args.steps, ckpt_dir=args.ckpt_dir)
    ckpt = checkpoint.save(f"{args.ckpt_dir}/state_{args.steps}.ckpt",
                           {"params": params}, args.steps)
    first, last = history[0], history[-1]
    print(f"\nloss {first['loss']:.3f} -> {last['loss']:.3f} "
          f"({args.steps} steps)")

    # calibration traces: per-node loss proxies on held-out data
    print("exporting calibration traces ...")
    cal = next(data)
    with torch.no_grad():
        _, _, node_losses, _ = M.prefill(
            params, cfg, {"tokens": torch.as_tensor(cal["tokens"],
                                                    device=device)},
            cache_len=args.seq + 8)
    path = f"{args.ckpt_dir}/calibration.npz"
    np.savez(path, node_losses=node_losses.cpu().numpy())
    print(f"saved {tuple(node_losses.shape)} node-loss traces to {path}")
    print(f"checkpoints in {args.ckpt_dir}")
    return {"ckpt": ckpt, "calibration": path, "history": history}


if __name__ == "__main__":
    main()
