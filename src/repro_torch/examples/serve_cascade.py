"""End-to-end serving example (the JAX package's
``examples/serve_cascade.py``): train a small early-exit model briefly,
calibrate a T-Tamer `Cascade`, then serve batched generation requests
with per-token early exit — comparing registry strategies (recall index,
skip table, confidence threshold) against full-depth execution through
the same `Engine`.  On the card the calibration prefill and the engine's
prefills run their attention through the flash-attention kernel and the
line solve through the Bellman-backup kernel.

  PYTHONPATH=src python -m repro_torch.examples.serve_cascade --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_cascade --no-train
  PYTHONPATH=src python -m repro_torch.examples.serve_cascade  # the card

`main` serves the smoke config, as the reference does; `run` takes any
`ModelConfig` (the full-width one included).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import strategy
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.launch.serve import device_of
from repro_torch.models import model as M
from repro_torch.models.param import materialize
from repro_torch.serving.engine import Engine
from repro_torch.training.loop import train
from repro_torch.training.optimizer import AdamWConfig

CALIB_PROMPTS, CALIB_LEN = 512, 64   # the reference calibration's draw
PROMPT_LEN, CACHE_LEN = 32, 96
CALIB_SEED, PROMPT_SEED = 0, 7       # numpy seeds
STRATEGIES = ("T-Tamer recall", "skip cascade", "threshold(0.4)",
              "full depth")


def make_strategies(casc) -> dict:
    """The four served strategies, in the reference's order."""
    return {
        "T-Tamer recall": strategy.make("recall_index", casc),
        "skip cascade": strategy.make("skip_recall", casc,
                                      mode="cumulative"),
        "threshold(0.4)": strategy.make("norecall_threshold", casc,
                                        threshold=0.4, lam=1.0),
        "full depth": strategy.make("always_last", casc),
    }


def run(cfg, *, train_steps: int | None = 80, batch: int = 8,
        tokens: int = 24, lam: float = 0.5, device="cuda",
        kernels: bool = True, params=None, calib_tokens=None,
        prompts=None) -> dict:
    """Train (``train_steps`` steps; None or 0 skips it), calibrate and
    serve ``cfg`` on ``device``; print the reference's lines and return
    every number printed, the cascade (``casc``), each strategy's
    `GenerationStats` and the weights served (``params``).

    ``params`` serves those weights (trained further only if
    ``train_steps`` asks); ``calib_tokens`` (T, seq) and ``prompts`` (B,
    32) replace the numpy draws.  ``kernels=False`` takes the plain
    attention and backups (the card's check of the kernel routes)."""
    device = device_of(str(device))
    if params is None:
        params = materialize(M.model_defs(cfg),
                             torch.Generator(device=device).manual_seed(0),
                             device)
    out = {}
    if train_steps:
        print(f"== training {cfg.name} for {train_steps} steps ==")
        opt = AdamWConfig(lr=1e-3, total_steps=train_steps, warmup_steps=5)
        data = batches(DataConfig(vocab=cfg.vocab, seq_len=129,
                                  global_batch=8))
        params, _, hist = train(cfg, opt, params, data, steps=train_steps,
                                log_every=20)
        out["loss"] = (hist[0]["loss"], hist[-1]["loss"])
        print(f"loss {out['loss'][0]:.3f} -> {out['loss'][1]:.3f}")

    print("\n== calibrating T-Tamer cascade ==")
    if calib_tokens is None:
        calib_tokens = np.random.default_rng(CALIB_SEED).integers(
            0, cfg.vocab, (CALIB_PROMPTS, CALIB_LEN))
    casc = strategy.Cascade.calibrate(params, cfg, calib_tokens, lam,
                                      use_flash=kernels, use_kernel=kernels)
    tables = casc.solve_line()
    out.update(nodes=tables.n, k=tables.k, objective=float(tables.value))
    print(f"nodes={tables.n} support K={tables.k} "
          f"optimal objective {out['objective']:.4f}")

    if prompts is None:
        prompts = np.random.default_rng(PROMPT_SEED).integers(
            0, cfg.vocab, (batch, PROMPT_LEN))
    prompts = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                         device=device)}
    batch = prompts["tokens"].shape[0]

    print(f"\n== serving {batch} requests x {tokens} tokens ==")
    stats, served = {}, {}
    for name, strat in make_strategies(casc).items():
        eng = Engine(params, cfg, strat, cache_len=CACHE_LEN,
                     use_flash=kernels)
        with torch.no_grad():
            eng.generate(prompts, 2)   # warm up (loads the kernels)
            t0 = time.perf_counter()
            st = eng.generate(prompts, tokens)
            dt = time.perf_counter() - t0
        stats[name] = st
        lane_saved = 1 - st.segments_run_policy / st.segments_full
        served[name] = {"tok_s": batch * tokens / dt,
                        "lane_segments_saved": lane_saved,
                        "served_node_mean": float(st.served_nodes.mean())}
        print(f"{name:16s}: {batch * tokens / dt:7.1f} tok/s | "
              f"lane-segments saved {100 * lane_saved:3.0f}% | "
              f"served-node mean {served[name]['served_node_mean']:.2f}")

    # agreement of EE outputs with full-depth outputs (quality proxy)
    full = stats["full depth"].tokens
    agreement = {}
    for name in STRATEGIES[:-1]:
        agreement[name] = float((stats[name].tokens == full).mean())
        print(f"{name:16s}: token agreement with full depth "
              f"{100 * agreement[name]:.1f}%")
    out.update(served=served, agreement=agreement, stats=stats, casc=casc,
               params=params)
    return out


def main(argv=None, *, kernels: bool = True) -> dict:
    """The reference's command line (plus ``--device``) on the smoke
    config; returns `run`'s dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-train", action="store_true")
    ap.add_argument("--train-steps", type=int, default=80)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--lam", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    return run(get_config("paper-ee-100m", smoke=True),
               train_steps=None if args.no_train else args.train_steps,
               batch=args.batch, tokens=args.tokens, lam=args.lam,
               device=args.device, kernels=kernels)


if __name__ == "__main__":
    main()
