"""Training launcher of the port: the early-exit multi-ramp objective
with AdamW on the synthetic pipeline (the JAX package's
``launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-ee-100m \
      --steps 200 --batch 8 --seq 256 [--smoke] [--ckpt-dir DIR]
  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 ...

It runs on the card (``--device cuda``, the default) and refuses to go
on when CUDA is missing; ``--device cpu`` runs on the CPU.  Parameters
come from `materialize` with a ``torch.Generator`` seeded with 0; the
step runs in bf16 on f32 master weights, with per-layer recomputation.

``--mesh DxM`` with D*M > 1 trains on a data x model `DeviceMesh` of
D*M ranks, one a process under ``torch.distributed.run`` (NCCL on the
card, one card a rank; gloo with ``--device cpu``); without that
launcher's environment it raises, naming the command.  Every rank
materializes the same parameters and draws the same batches, then keeps
its shards: the parameters and both AdamW moments become DTensors
placed by ``FSDP_TRAIN_RULES``, and the batch is sharded over "data"
when it divides (the activation-sharding context anchors the residual
stream there).  An op that DTensor cannot shard runs on replicated
operands (`ReplicateRefused`); each logged step prints those ops, if
any, with their counts so far on rank 0 and keeps them in its metrics
(``replicated_ops``).  ``1x1`` is the plain one-device path, as the
reference shards only a mesh of more than one device.

With ``--ckpt-dir`` it saves ``{"params"}`` every 100 steps as
``state_N.ckpt``, in the checkpoint format both packages read, and also
after the last step (the JAX launcher saves at the hundreds only), so a
short run leaves a checkpoint to serve with ``launch.serve --ckpt``.  A
mesh run gathers the full tensors first and rank 0 writes the file.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.launch.serve import device_of
from repro_torch.models import model as M
from repro_torch.models.param import materialize, tree_map
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
                    help="dataxmodel, e.g. 4x2 (needs that many ranks "
                         "under torch.distributed.run)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap.parse_args(argv)


def _init_mesh(d: int, m: int, device: torch.device):
    """The data x model mesh of a torchrun world of d*m ranks, and this
    rank's device."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    n = d * m
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise SystemExit(
            f"--mesh {d}x{m} trains on {n} ranks: run it as `python -m "
            f"torch.distributed.run --standalone --nproc-per-node {n} -m "
            f"repro_torch.launch.train --mesh {d}x{m} ...`")
    if int(os.environ["WORLD_SIZE"]) != n:
        raise SystemExit(f"--mesh {d}x{m} needs a world of {n} ranks, "
                         f"not {os.environ['WORLD_SIZE']}")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return make_local_mesh(d, m), device


def _shard(mesh, rules, defs, tree):
    """``tree`` (full tensors, the same on every rank) as DTensors placed
    by ``rules``; each rank keeps its own shards, with no collective."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.param import ParamDef
    from repro_torch.sharding.rules import placements_for, spec_for

    def one(d: ParamDef, x):
        pl = placements_for(mesh, spec_for(mesh, rules, d.shape, d.axes),
                            x.dim())
        return distribute_tensor(x, mesh, pl, src_data_rank=None)

    if isinstance(defs, dict):
        return {k: _shard(mesh, rules, defs[k], tree[k]) for k in defs}
    if isinstance(defs, (list, tuple)):
        return [_shard(mesh, rules, dd, t) for dd, t in zip(defs, tree)]
    return one(defs, tree)


def _full(tree):
    """The full tensors of a tree of DTensors (a collective)."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def main(argv=None) -> list:
    """Train; returns the logged metrics (one dict a logged step)."""
    args = parse_args(argv)
    d, m = (int(x) for x in args.mesh.split("x"))
    device = device_of(args.device)
    mesh = None
    if d * m > 1:
        mesh, device = _init_mesh(d, m, device)
    lead = mesh is None or mesh.get_rank() == 0
    cfg = get_config(args.arch, smoke=args.smoke)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1))
    defs = M.model_defs(cfg)
    params = materialize(defs, torch.Generator(device=device).manual_seed(0),
                         device)
    opt_state = init_opt_state(params)
    ctx = contextlib.ExitStack()
    guard = None
    if mesh is not None:
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        from torch.distributed.tensor.experimental import \
            implicit_replication

        from repro_torch.sharding.ctx import (ReplicateRefused,
                                              activation_sharding)
        from repro_torch.sharding.rules import FSDP_TRAIN_RULES

        params = _shard(mesh, FSDP_TRAIN_RULES, defs, params)
        opt_state = {"mu": _shard(mesh, FSDP_TRAIN_RULES, defs,
                                  opt_state["mu"]),
                     "nu": _shard(mesh, FSDP_TRAIN_RULES, defs,
                                  opt_state["nu"]),
                     "step": opt_state["step"]}
        on_data = args.batch % d == 0 and d > 1
        batch_pl = (Shard(0) if on_data else Replicate(), Replicate())
        ctx.enter_context(implicit_replication())
        ctx.enter_context(activation_sharding(("data",) if on_data
                                              else None))
        guard = ctx.enter_context(ReplicateRefused())
    step_fn = make_train_step(cfg, opt_cfg,
                              num_microbatches=args.microbatches)
    it = batches(DataConfig(vocab=cfg.vocab, seq_len=args.seq + 1,
                            global_batch=args.batch))
    history = []
    t0 = time.time()
    if mesh is not None:
        import torch.distributed as dist

        ctx.callback(dist.destroy_process_group)
    with ctx:
        for step in range(args.steps):
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in next(it).items()}
            if mesh is not None:
                batch = {k: distribute_tensor(v, mesh, batch_pl,
                                              src_data_rank=None)
                         for k, v in batch.items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % args.log_every == 0 or step == args.steps - 1:
                mm = {k: float(v) for k, v in _full(metrics).items()}
                history.append(dict(mm, step=step))
                if guard is not None:
                    history[-1]["replicated_ops"] = dict(guard.counts)
                if lead:
                    print(f"step {step:5d} loss {mm['loss']:.4f} "
                          f"ce_final {mm['ce_final']:.4f} "
                          f"lr {mm['lr']:.2e} "
                          f"({(time.time() - t0):.1f}s)", flush=True)
                    if guard is not None and guard.counts:
                        print(f"      replicated ops {guard.counts}",
                              flush=True)
            if args.ckpt_dir and ((step + 1) % CKPT_EVERY == 0
                                  or step == args.steps - 1):
                full = _full(params) if mesh is not None else params
                if lead:
                    checkpoint.save(f"{args.ckpt_dir}/state_{step + 1}.ckpt",
                                    {"params": full}, step + 1)
    if lead:
        print("done", flush=True)
    return history


if __name__ == "__main__":
    main()
