"""The port's mesh tooling against the JAX package's: sharding rules
(`spec_for`, `placements_for`), the sharded input and cache specs of
`launch/shapes.py`, the activation-sharding anchors, the op-cost model
and the dry run.

Tolerances, stated per test:
  * specs, shapes, dtypes, argument bytes and collective bytes: EQUAL;
  * attention on DTensors over two gloo ranks (heads, batch or ring
    slots sharded) against the plain attention: atol 1e-5 (f32 sums
    in another order);
  * op_cost's flops of a loop of 12 128x128 matmuls: EQUAL to
    12 * 2 * 128^3 (the mirror of the reference's scan-trip test);
  * the counted matmul flops of a smoke prefill against
    `launch/flops.model_flops`: 1.0 <= counted / analytic <= 1.25, and
    EQUAL once two stated differences are taken out: the port's prefill
    computes every score and value product of the S x S square and masks
    the upper half, where the analytic count takes the causal half (so
    it counts half the attention term more), and it unembeds only the
    last token of a row, where the analytic count unembeds every token
    (so it counts 2 * D * V * B * (S - 1) less).

The dry run needs the fake backend's 512-rank world, a process-wide
default group, so everything that builds a DeviceMesh runs once in a
subprocess (`_dryrun_results`) and the tests read its JSON.
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import ASSIGNED, REGISTRY
from repro.configs import get_config as jget_config
from repro.launch import shapes as jshapes
from repro.models import model as JM
from repro.models import quant as jquant
from repro.models.param import ParamDef as JParamDef
from repro.sharding import ctx as jctx
from repro.sharding import rules as jrules
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.launch import flops as tflops
from repro_torch.launch import op_cost
from repro_torch.launch import shapes as tshapes
from repro_torch.models import model as TM
from repro_torch.models import quant as tquant
from repro_torch.models.param import materialize, tree_leaves
from repro_torch.sharding import ctx as tctx
from repro_torch.sharding import rules as trules

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


class _FakeMesh:
    """spec_for only consults mesh.shape."""

    def __init__(self, **shape):
        self.shape = shape


MESHES = {
    "4x8": dict(data=4, model=8),
    "16x16": dict(data=16, model=16),
    "2x16x16": dict(pod=2, data=16, model=16),
    "16x8x2": dict(data=16, model=8, model2=2),
    "2x16x8x2": dict(pod=2, data=16, model=8, model2=2),
}
RULES = ("BASELINE_RULES", "FSDP_TRAIN_RULES", "GQA_RULES")


def _jleaves(defs):
    import jax

    return jax.tree.leaves(defs, is_leaf=lambda x: isinstance(x, JParamDef))


# ---- sharding rules ---------------------------------------------------------

def test_rule_tables_match():
    for name in RULES:
        assert getattr(trules, name).rules == getattr(jrules, name).rules


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_matches_reference_on_every_param(mesh, rules):
    """Every ParamDef of all eleven full configs, on five mesh shapes."""
    jm, tm = _FakeMesh(**MESHES[mesh]), _FakeMesh(**MESHES[mesh])
    jr, tr = getattr(jrules, rules), getattr(trules, rules)
    n = 0
    for arch in REGISTRY:
        jdefs = _jleaves(JM.model_defs(jget_config(arch)))
        tdefs = tree_leaves(TM.model_defs(get_config(arch)))
        assert len(jdefs) == len(tdefs), arch
        for jd, td in zip(jdefs, tdefs):
            assert (jd.shape, jd.axes) == (td.shape, td.axes), arch
            want = tuple(jrules.spec_for(jm, jr, jd.shape, jd.axes))
            got = trules.spec_for(tm, tr, td.shape, td.axes)
            assert got == want, (arch, td.shape, td.axes)
            n += 1
    assert n > 800


def test_spec_for_divisibility_gating():
    P = trules.P
    mesh = _FakeMesh(data=4, model=8)
    s = trules.spec_for(mesh, trules.BASELINE_RULES, (64, 128),
                        ("embed", "mlp"))
    assert s == P(None, "model")
    # 63 is not divisible by model=8 -> replicate
    assert trules.spec_for(mesh, trules.BASELINE_RULES, (63,),
                           ("mlp",)) == P()
    # batch gets both pod+data when present and divisible
    mesh2 = _FakeMesh(pod=2, data=4, model=8)
    s = trules.spec_for(mesh2, trules.BASELINE_RULES, (16, 128),
                        ("batch", None))
    assert s == P(("pod", "data"))
    # batch=4 not divisible by pod*data=8 -> replicate
    assert trules.spec_for(mesh2, trules.BASELINE_RULES, (4,),
                           ("batch",)) == P()
    # an axis is never used twice in one spec
    s = trules.spec_for(mesh, trules.BASELINE_RULES, (64, 64),
                        ("mlp", "heads"))
    assert s == P("model", None) or s == P("model")


def test_sharding_tree_is_spec_for_of_every_leaf():
    mesh = _FakeMesh(**MESHES["16x16"])
    defs = TM.model_defs(get_config("qwen3-4b"))
    tree = trules.sharding_tree(mesh, trules.FSDP_TRAIN_RULES, defs)
    specs = _flat(tree)
    for path, d in _flat(defs).items():
        assert specs[path] == trules.spec_for(
            mesh, trules.FSDP_TRAIN_RULES, d.shape, d.axes), path


# ---- sharded input and cache specs ------------------------------------------

SPEC_CASES = [("qwen3-4b", False), ("musicgen-large", False),
              ("phi-3-vision-4.2b", False), ("deepseek-v2-lite-16b", False),
              ("hymba-1.5b", False), ("qwen3-4b", True),
              ("deepseek-v2-lite-16b", True)]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/#{i}"))
        return out
    return {prefix: tree}


def _jspec(x):
    return (tuple(x.shape), str(jnp.dtype(x.dtype)), tuple(x.sharding.spec))


def _tspec(x):
    return (tuple(x.shape), str(x.dtype).removeprefix("torch."), x.spec)


@pytest.mark.parametrize("arch,int8", SPEC_CASES,
                         ids=[f"{a}{'-int8' if i else ''}"
                              for a, i in SPEC_CASES])
def test_input_and_cache_specs_match(arch, int8):
    jm = AbstractMesh((16, 16), ("data", "model"))
    tm = _FakeMesh(data=16, model=16)
    jr, tr = jrules.BASELINE_RULES, trules.BASELINE_RULES
    for name, shape in jshapes.SHAPES.items():
        tshape = tshapes.SHAPES[name]
        jc = jshapes.resolve_config(jget_config(arch), shape)
        tc = tshapes.resolve_config(get_config(arch), tshape)
        assert tuple(jshapes.batch_axes(jm, jr, shape.global_batch)) == \
            tshapes.batch_axes(tm, tr, tshape.global_batch)
        ji = _flat(jshapes.input_specs(jc, shape, jm, jr))
        ti = _flat(tshapes.input_specs(tc, tshape, tm, tr))
        assert {k: _jspec(v) for k, v in ji.items()} == \
            {k: _tspec(v) for k, v in ti.items()}, (arch, name)
        if shape.kind != "decode":
            continue
        with jquant.cache_int8(int8), tquant.cache_int8(int8):
            jcache = _flat(jshapes.cache_specs_sharded(jc, shape, jm, jr))
            tcache = _flat(tshapes.cache_specs_sharded(tc, tshape, tm, tr))
        assert {k: _jspec(v) for k, v in jcache.items()} == \
            {k: _tspec(v) for k, v in tcache.items()}, (arch, name)
        keys = {k.rsplit("/", 1)[1] for k in tcache}
        if int8:
            assert keys & {"k_s", "v_s", "c_kv_s", "k_rope_s"}, keys


# ---- activation-sharding anchors --------------------------------------------

def test_constrain_is_identity_outside_a_context_and_on_plain_tensors():
    x = torch.randn(8, 4, 16)
    assert tctx.constrain_batch(x) is x
    assert tctx.constrain_expert(x, 0, 1) is x
    assert tctx.reduce_partial(x) is x
    with tctx.activation_sharding(("pod", "data")):
        assert tctx.constrain_batch(x) is x
        assert tctx.constrain_batch(x, batch_dim=1) is x
        assert tctx.constrain_expert(x, 0, 1) is x
    with jctx.activation_sharding(("data",)):
        pass    # the two packages' contexts are independent


# ---- op_cost ---------------------------------------------------------------

def test_op_cost_counts_every_loop_trip():
    """The mirror of test_hlo_cost_counts_scan_trips: a Python loop of 12
    matmuls counts 12 times (bytes: every operand and result once)."""
    def f(x, ws):
        for w in ws:
            x = x @ w
        return x

    x = torch.randn(128, 128)
    ws = torch.randn(12, 128, 128).unbind(0)
    cost = op_cost.analyze(f, x, ws)
    assert cost.flops == 12 * 2 * 128 ** 3
    assert cost.hbm_bytes == 12 * 3 * 128 * 128 * 4
    assert cost.collectives == {} and cost.wire_bytes == 0
    (rec,) = cost.records
    assert (rec["op"], rec["count"]) == ("mm", 12)


def test_op_cost_counts_kernel_launches_as_bytes_only():
    x = torch.randn(4, 8)

    def f(t):
        out = t * 2.0
        build.report_launch("demo", (t,), (out,))
        return out

    cost = op_cost.analyze(f, x)
    assert cost.kernels == {"demo": 1}
    assert cost.flops == 32                      # the mul only
    assert cost.hbm_bytes == 2 * (2 * 32 * 4)    # the mul, then the kernel


@pytest.mark.parametrize("arch", ["qwen3-4b", "paper-ee-100m"])
def test_op_cost_prefill_matmuls_against_model_flops(arch):
    cfg = get_config(arch, smoke=True)
    params = materialize(TM.model_defs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    s = 256
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, s)), dtype=torch.int32)
    with torch.no_grad():
        cost = op_cost.analyze(
            lambda t: TM.prefill(params, cfg, {"tokens": t}, s), tok)
    counted = sum(r["flops"] for r in cost.records
                  if r["op"] in ("mm", "bmm", "addmm"))
    analytic = tflops.model_flops(cfg, kind="prefill", global_batch=2,
                                  seq_len=s)
    assert 1.0 <= counted / analytic <= 1.25, counted / analytic
    causal_half = sum(tflops._attn_flops_per_layer(g.block, 2 * s, s / 2)
                      * g.n_layers for g in cfg.segments)
    assert counted == analytic + causal_half \
        - 2 * cfg.d_model * cfg.vocab * 2 * (s - 1)


# ---- meshes and the dry run (one subprocess) --------------------------------

def test_meshes_need_a_world():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        make_local_mesh(2, 1)


DRYRUN = textwrap.dedent("""
    import json
    import torch
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.launch.shapes import SHAPES, ShapeSpec, input_specs
    from repro_torch.models import model as M
    from repro_torch.models.param import tree_leaves
    from repro_torch.sharding.rules import (BASELINE_RULES, P,
                                            FSDP_TRAIN_RULES, placements_for)
    from repro_torch.training.loop import make_train_step
    from repro_torch.training.optimizer import AdamWConfig

    out = {"meshes": {}, "arg_bytes": {}, "train_2x4": {}}
    for mp in (False, True):
        for layout in ("2d", "gqa"):
            m = make_production_mesh(multi_pod=mp, layout=layout)
            out["meshes"][f"{mp}-{layout}"] = [list(m.shape),
                                               list(m.mesh_dim_names)]
    pod = make_production_mesh(multi_pod=True)
    out["placements"] = [str(p) for p in placements_for(
        pod, P(("pod", "data"), "model"), 3)]
    mesh = make_production_mesh()
    for arch in list(ASSIGNED) + ["paper-ee-100m"]:
        for shape in SHAPES:
            if arch == "paper-ee-100m" and shape != "decode_32k":
                continue
            _, args = dryrun.build_lowerable(arch, shape, mesh,
                                             BASELINE_RULES)
            out["arg_bytes"][f"{arch}|{shape}"] = dryrun.local_bytes(args)

    # the wire of a full-width decode whose vocab shards over "model"
    cost = dryrun.trace("qwen3-4b", "decode_32k", mesh, BASELINE_RULES)[0]
    gathers = [r for r in cost.records if r["op"] == "all-gather"]
    out["decode_wire"] = [cost.wire_bytes,
                          max(r["bytes"] / r["count"] for r in gathers)]

    # an all-reduce of a known size on the model axis of a 2x4 mesh
    import torch.distributed._functional_collectives as funcol
    small = make_local_mesh(2, 4)
    with dryrun.fake_mode():
        x = torch.empty(64, 32)
    cost = op_cost.analyze(
        lambda t: funcol.all_reduce(t, "sum", small.get_group("model")), x)
    out["all_reduce"] = [cost.collectives, cost.wire_bytes]

    # the reference's xfail smoke: a smoke train step on a 2x4 mesh
    for arch in ("qwen3-4b", "phi3.5-moe-42b-a6.6b", "mamba2-130m"):
        cfg = get_config(arch, smoke=True)
        defs = M.model_defs(cfg)
        shape = ShapeSpec("t", 64, 8, "train")
        params = dryrun.abstract_params(defs, small, BASELINE_RULES,
                                        torch.float32)
        with dryrun.fake_mode():
            step = torch.zeros((), dtype=torch.int32)
        opt = {"mu": dryrun.abstract_params(defs, small, BASELINE_RULES,
                                            torch.float32),
               "nu": dryrun.abstract_params(defs, small, BASELINE_RULES,
                                            torch.float32),
               "step": step}
        batch = dryrun.abstract_inputs(
            input_specs(cfg, shape, small, BASELINE_RULES), small)
        fn = make_train_step(cfg, AdamWConfig(), num_microbatches=2)
        cost, retried, _ = dryrun.trace_step(fn, (params, opt, batch),
                                             ("data",))
        new_params = cost.result[0]
        out["train_2x4"][arch] = {
            "flops": cost.flops, "wire": cost.wire_bytes,
            "same_placements": all(
                a.placements == b.placements and a.shape == b.shape
                for a, b in zip(tree_leaves(params),
                                tree_leaves(new_params)))}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def _dryrun_results():
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("RANK", None)
    out = subprocess.run([sys.executable, "-c", DRYRUN],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_production_meshes(_dryrun_results):
    assert _dryrun_results["meshes"] == {
        "False-2d": [[16, 16], ["data", "model"]],
        "False-gqa": [[16, 8, 2], ["data", "model", "model2"]],
        "True-2d": [[2, 16, 16], ["pod", "data", "model"]],
        "True-gqa": [[2, 16, 8, 2], ["pod", "data", "model", "model2"]],
    }
    # a dim sharded over ("pod", "data") is Shard(d) on both, mesh order
    assert _dryrun_results["placements"] == ["S(0)", "S(0)", "S(1)"]


def test_op_cost_counts_an_all_reduce(_dryrun_results):
    colls, wire = _dryrun_results["all_reduce"]
    assert colls == {"all-reduce": {"count": 1, "bytes": 64 * 32 * 4}}
    assert wire == 2 * 64 * 32 * 4


def test_dryrun_decode_wire_within_the_reference(_dryrun_results):
    """qwen3-4b decode_32k on pod16x16: the embedding lookup reads each
    device's vocab shard (its 778 MB table is never all-gathered, the
    largest gather is a few MB) and the wire bytes a device stay at or
    below the reference's compiled dry run's 76,988,800 (jax 0.9.0)."""
    wire, biggest_gather = _dryrun_results["decode_wire"]
    table = 151936 * 2560 * 2
    assert biggest_gather < table / 100
    assert 0 < wire <= 76_988_800


@pytest.mark.parametrize("arch", ["qwen3-4b", "phi3.5-moe-42b-a6.6b",
                                  "mamba2-130m"])
def test_train_step_lowers_on_8_fake_devices(_dryrun_results, arch):
    """The reference's seed-failure smoke, here on a 2x4 fake mesh: the
    train step traces, counts work and keeps every parameter's
    placements."""
    res = _dryrun_results["train_2x4"][arch]
    assert res["flops"] > 0 and res["wire"] > 0
    assert res["same_placements"]


def _ref_argument_bytes(arch, shape_name):
    """The reference's per-device argument bytes: the shard bytes of its
    own abstract params (f32 params and moments plus the step counter
    for training, bf16 for serving), input specs and decode caches on an
    AbstractMesh (16, 16)."""
    mesh = AbstractMesh((16, 16), ("data", "model"))
    shape = jshapes.SHAPES[shape_name]
    cfg = jshapes.resolve_config(jget_config(arch), shape)

    def shard(shp, dt, spec):
        return math.prod(NamedSharding(mesh, spec).shard_shape(shp)) \
            * jnp.dtype(dt).itemsize

    def params(rules, dt):
        return sum(shard(d.shape, dt, jrules.spec_for(mesh, rules, d.shape,
                                                       d.axes))
                   for d in _jleaves(JM.model_defs(cfg)))

    import jax

    total = sum(shard(x.shape, x.dtype, x.sharding.spec)
                for x in jax.tree.leaves(jshapes.input_specs(
                    cfg, shape, mesh, jrules.BASELINE_RULES)))
    if shape.kind == "train":
        return total + 3 * params(jrules.FSDP_TRAIN_RULES, jnp.float32) + 4
    total += params(jrules.BASELINE_RULES, jnp.bfloat16)
    if shape.kind == "prefill":
        return total
    total += sum(shard(x.shape, x.dtype, x.sharding.spec)
                 for x in jax.tree.leaves(jshapes.cache_specs_sharded(
                     cfg, shape, mesh, jrules.BASELINE_RULES)))
    pos_spec = jshapes.batch_axes(mesh, jrules.BASELINE_RULES,
                                  shape.global_batch)
    return total + shard((shape.global_batch,), jnp.int32, pos_spec)


@pytest.mark.parametrize("shape", list(jshapes.SHAPES))
def test_dryrun_argument_bytes_match_reference(_dryrun_results, shape):
    """All ten assigned archs on pod16x16."""
    for arch in ASSIGNED:
        assert _dryrun_results["arg_bytes"][f"{arch}|{shape}"] == \
            _ref_argument_bytes(arch, shape), arch


def test_dryrun_argument_bytes_match_a_compiled_reference(_dryrun_results):
    """The reference's compiled paper-ee-100m decode_32k on the 256-way
    fake mesh reported 704,420,416 argument bytes a device."""
    assert _dryrun_results["arg_bytes"]["paper-ee-100m|decode_32k"] == \
        704_420_416 == _ref_argument_bytes("paper-ee-100m", "decode_32k")


SHARDED_ATTENTION = textwrap.dedent("""
    import torch, torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import attention as A

    dist.init_process_group("gloo")
    torch.manual_seed(0)
    worst = 0.0
    for d, m in ((1, 2), (2, 1)):
        mesh = make_local_mesh(d, m)
        # (heads, kv heads, ring slots sharded): a replicated kv head read
        # by each device's query heads, kv heads sharded with them, MHA,
        # and the context-parallel ring
        for h, hkv, on_t in ((4, 1, False), (4, 2, False), (4, 4, False),
                             (4, 2, True), (4, 1, True)):
            b, s, t, hd = 2, 3, 8, 16
            q = torch.randn(b, s, h, hd)
            k, v = torch.randn(2, b, t, hkv, hd)
            mask = (torch.arange(t)[None, None, :]
                    <= torch.arange(s)[None, :, None] + 4).expand(b, s, t)
            want = A._sdpa(q, k, v, mask, 0.25)
            kv_pl = (Shard(0), Shard(1) if on_t else Replicate())

            def dt(x, pl):
                return distribute_tensor(x.contiguous(), mesh, pl,
                                         src_data_rank=None)
            got = A._sdpa(dt(q, (Shard(0), Shard(2))), dt(k, kv_pl),
                          dt(v, kv_pl), dt(mask, (Shard(0), Replicate())),
                          0.25).full_tensor()
            worst = max(worst, (got - want).abs().max().item())
    if dist.get_rank() == 0:
        print("WORST", worst)
    dist.destroy_process_group()
""")


def test_sharded_attention_matches_plain(tmp_path):
    script = tmp_path / "sharded_attention.py"
    script.write_text(SHARDED_ATTENTION)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    worst = float(out.stdout.split("WORST")[-1])
    assert worst <= 1e-5, worst
