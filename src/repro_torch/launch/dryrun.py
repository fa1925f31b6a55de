"""Multi-pod dry run (the JAX package's ``launch/dryrun.py``): traces one
(architecture x input shape x mesh) step on the production mesh without
allocating a byte, and records its per-device cost and memory to JSON.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \
      --shape decode_32k [--multi-pod] [--variant gqa_mesh] [--force]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

At import the module sets up a ``fake``-backend `torch.distributed` world
of 512 ranks (this process is rank 0), unless a world is already set up:
the counterpart of the JAX package's 512 forced host devices.  Run it in
a process of its own.  Parameters, optimizer state, inputs and caches
are ``FakeTensorMode`` tensors (shapes and dtypes, no storage) wrapped as
DTensors with the placements the sharding rules give them
(`sharding.rules.placements_for`).  The step — ``prefill``,
``decode_step``, or the train step with ``FSDP_TRAIN_RULES`` and 16
microbatches when the batch divides — runs under the activation-sharding
context and `launch.op_cost.analyze`, which counts each op on one
device's local tensors.  An op that DTensor cannot shard runs on
replicated operands (`sharding.ctx.ReplicateRefused`); the JSON lists
those ops under ``replicated_ops``.  Serving shapes take bf16
parameters; training f32 master weights and f32 moments.

The JSON has the reference's keys.  ``memory.argument_bytes`` is the sum
of the local shard bytes of the parameters, the optimizer state, the
inputs and the caches; ``output_bytes`` the same sum over the outputs;
``temp_bytes`` the peak of live local op results the recorder tallied.
``lower_s`` becomes ``trace_s``, the time of the traced step.  Eager
PyTorch compiles nothing and has no HLO, so ``compile_s``, ``hlo_bytes``,
``memory.generated_code_bytes`` and ``xla_flops_per_device_noloop`` are
null.  Results go to ``--out`` (default ``results/dryrun_torch/`` at the
root of the checkout).

``--variant`` takes the reference's seven names: ``baseline`` (long
prompts: chunked attention), ``banded_attn`` (banded), ``int8_cache``
(banded, int8 KV caches), ``gqa_mesh`` / ``gqa_opt`` (the GQA-factorized
mesh and rules, chunked / banded).  The port runs decode layers in a
Python loop, so it has no scanned decode to unroll: ``decode_unroll`` is
``baseline`` and ``opt`` is ``banded_attn``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.launch import flops as flops_lib
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import (SHAPES, TensorSpec, batch_axes,
                                       cache_len_for, cache_specs_sharded,
                                       input_specs, resolve_config)
from repro_torch.models import model as M
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.sharding.ctx import ReplicateRefused, activation_sharding
from repro_torch.sharding.rules import (BASELINE_RULES, FSDP_TRAIN_RULES,
                                        GQA_RULES, RuleSet, placements_for,
                                        spec_for)
from repro_torch.training.loop import make_train_step
from repro_torch.training.optimizer import AdamWConfig

__all__ = ["abstract_params", "abstract_inputs", "build_lowerable",
           "trace_step", "trace", "run_one", "main", "local_bytes",
           "fake_mode", "VARIANTS", "WORLD_SIZE"]

WORLD_SIZE = 512
RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"
VARIANTS = ("baseline", "banded_attn", "decode_unroll", "opt", "gqa_mesh",
            "gqa_opt", "int8_cache")


def _fake_world() -> None:
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD_SIZE)


_fake_world()
_FAKE = None


def fake_mode():
    """The one FakeTensorMode every abstract tensor of the module lives
    in (host tensors DTensor makes for its bookkeeping may meet it)."""
    global _FAKE
    if _FAKE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _FAKE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE


def _abstract(shape, dtype, mesh, spec):
    """A fake DTensor of global ``shape`` with ``spec``'s placements."""
    from torch.distributed.tensor import DTensor

    placements = placements_for(mesh, spec, len(shape))
    local = list(shape)
    for md, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(md)
    with fake_mode():
        t = torch.empty(local, dtype=dtype)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def abstract_params(defs, mesh, rules: RuleSet, dtype):
    """A ParamDef tree as fake DTensors sharded by ``rules``."""
    return tree_map(lambda d: _abstract(d.shape, dtype, mesh, spec_for(
        mesh, rules, d.shape, d.axes)), defs)


def abstract_inputs(tree, mesh):
    """A tree of `TensorSpec`s as fake DTensors."""
    return tree_map(lambda s: _abstract(s.shape, s.dtype, mesh, s.spec)
                    if isinstance(s, TensorSpec) else s, tree)


def local_bytes(tree) -> int:
    """Bytes of one device's shards of every tensor leaf of ``tree``."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def build_lowerable(arch: str, shape_name: str, mesh, rules: RuleSet,
                    num_microbatches: int = 16):
    """Returns (fn, abstract_args) ready for ``op_cost.analyze(fn,
    *args)``."""
    shape = SHAPES[shape_name]
    cfg = resolve_config(get_config(arch), shape)
    defs = M.model_defs(cfg)
    batch = abstract_inputs(input_specs(cfg, shape, mesh, rules), mesh)

    if shape.kind == "train":
        # f32 master weights + moments need 2-D (fsdp x tp) sharding
        if rules is BASELINE_RULES:
            rules = FSDP_TRAIN_RULES
        params = abstract_params(defs, mesh, rules, torch.float32)
        with fake_mode():
            step_t = torch.zeros((), dtype=torch.int32)
        opt = {"mu": abstract_params(defs, mesh, rules, torch.float32),
               "nu": abstract_params(defs, mesh, rules, torch.float32),
               "step": step_t}
        mb = num_microbatches \
            if shape.global_batch % num_microbatches == 0 else 1
        return make_train_step(cfg, AdamWConfig(),
                               num_microbatches=mb), (params, opt, batch)

    params = abstract_params(defs, mesh, rules, torch.bfloat16)
    cache_len = cache_len_for(cfg, shape)
    if shape.kind == "prefill":
        def fn(p, b):
            with torch.no_grad():
                return M.prefill(p, cfg, b, cache_len)
        return fn, (params, batch)

    caches = abstract_inputs(cache_specs_sharded(cfg, shape, mesh, rules),
                             mesh)
    pos = _abstract((shape.global_batch,), torch.int32, mesh,
                    batch_axes(mesh, rules, shape.global_batch))

    def fn(p, b, c, q):
        with torch.no_grad():
            return M.decode_step(p, cfg, b, c, q)
    return fn, (params, batch, caches, pos)


def _variant_ctx(variant: str):
    """The perf variant's contexts (see the module docstring)."""
    from repro_torch.models.attention import attention_impl
    from repro_torch.models.quant import cache_int8

    stack = contextlib.ExitStack()
    if variant in ("baseline", "decode_unroll", "gqa_mesh"):
        stack.enter_context(attention_impl("chunked"))
    elif variant in ("banded_attn", "opt", "gqa_opt"):
        stack.enter_context(attention_impl("banded"))
    elif variant == "int8_cache":
        stack.enter_context(attention_impl("banded"))
        stack.enter_context(cache_int8(True))
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return stack


def trace_step(fn, args, batch_axes_):
    """Run ``fn(*args)`` on abstract DTensors under the activation
    sharding of ``batch_axes_`` and `op_cost.analyze`: (OpCost, the ops
    `ReplicateRefused` retried, seconds the traced step took)."""
    from torch.distributed.tensor.experimental import implicit_replication

    guard = ReplicateRefused()

    def step(*a):
        with guard:
            return fn(*a)

    t0 = time.time()
    with fake_mode(), implicit_replication(), \
            activation_sharding(batch_axes_):
        cost = op_cost.analyze(step, *args)
    return cost, guard.counts, time.time() - t0


def trace(arch: str, shape_name: str, mesh, rules: RuleSet):
    """Trace one step on ``mesh``: (OpCost, argument bytes, the ops
    `ReplicateRefused` retried, seconds the traced step took)."""
    # batch mesh axes for the activation-sharding anchors
    bspec = batch_axes(mesh, rules, SHAPES[shape_name].global_batch)
    entry = bspec[0] if len(bspec) else None
    axes = entry if isinstance(entry, tuple) else (
        (entry,) if entry else None)
    fn, args = build_lowerable(arch, shape_name, mesh, rules)
    cost, retried, seconds = trace_step(fn, args, axes)
    return cost, local_bytes(args), retried, seconds


def run_one(arch: str, shape_name: str, multi_pod: bool,
            rules: RuleSet = BASELINE_RULES, rules_name: str = "baseline",
            force: bool = False, save: bool = True,
            variant: str = "baseline", out_dir=None) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    out_dir = Path(out_dir) if out_dir else RESULTS_DIR
    tag = rules_name if variant == "baseline" else f"{rules_name}+{variant}"
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_name}__{tag}.json"
    if save and out_path.exists() and not force:
        return json.loads(out_path.read_text())

    if variant.startswith("gqa"):
        rules = GQA_RULES
        mesh = make_production_mesh(multi_pod=multi_pod, layout="gqa")
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
    with _variant_ctx(variant):
        cost, arg_bytes, retried, t_trace = trace(arch, shape_name, mesh,
                                                  rules)
    shape = SHAPES[shape_name]
    cfg = resolve_config(get_config(arch), shape)
    useful = flops_lib.model_flops(cfg, kind=shape.kind,
                                   global_batch=shape.global_batch,
                                   seq_len=shape.seq_len)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "rules": tag, "devices": mesh.size(),
        "trace_s": round(t_trace, 2), "compile_s": None,
        "flops_per_device": cost.flops,
        "hbm_bytes_per_device": cost.hbm_bytes,
        "xla_flops_per_device_noloop": None,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": local_bytes(cost.result),
            "temp_bytes": cost.temp_bytes,
            "generated_code_bytes": None,
        },
        "collectives": cost.collectives,
        "wire_bytes_per_device": cost.wire_bytes,
        "pod_wire_bytes_per_device": cost.pod_wire_bytes,
        "model_flops": useful,
        "hlo_bytes": None,
        "replicated_ops": retried,
    }
    if save:
        out_dir.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(result, indent=1))
    temp = result["memory"]["temp_bytes"]
    print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ({tag}): "
          f"trace {t_trace:.1f}s, flops/dev {cost.flops:.3g}, "
          f"temp {temp / 2**30:.2f} GiB, "
          f"wire {cost.wire_bytes / 2**30:.3f} GiB", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all 10 archs x 4 shapes")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--out", default=None,
                    help=f"result directory (default {RESULTS_DIR})")
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_one(arch, shape, mp, force=args.force,
                            variant=args.variant, out_dir=args.out)
                except Exception as e:  # noqa: BLE001 - listed, then exit 1
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"[dryrun] FAIL {arch} x {shape} "
                          f"multi_pod={mp}: {e}", flush=True)
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print("[dryrun] all requested combinations traced OK", flush=True)


if __name__ == "__main__":
    main()
