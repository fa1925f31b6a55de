"""Chip smoke test of the PyTorch/CUDA port (repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It

  1. prints the card (nvidia-smi name and power limit), the torch and
     CUDA versions, and builds every CUDA kernel of the serve paths from
     the sources in the checkout (one nvcc per source, in parallel):
     paged_attention, paged_prefill, flash_attention, bellman_backup,
     ssd_chunk, ramp_exit; prints what ptxas reports for each
     (registers, static shared memory, spills) and what the runtime
     reports at their timed shapes (registers, shared memory a block,
     blocks an SM, local memory; for the paged pair also the splits of
     a lane's pages, for ramp_exit its cluster size and the clusters the
     card holds at once, for the Bellman kernel its threads);
  2. holds each kernel against its plain PyTorch version on the card:
     the paged pair at the chunked serve's shapes (8 lanes, 12 heads,
     head_dim 64, 16-token pages, 8 pages a lane, 16-token chunks),
     with position -1 holes, an all-masked lane, ragged and mid-page
     chunks, a GQA case with a window and the serve's own history
     lengths, at 1024-token contexts (64-page tables, histories of
     993-1024 positions, chunks from about position 1000: the lanes'
     pages split over blocks), at qwen3-4b's GQA widths (32 heads on
     8 kv heads, head_dim 128) and at starcoder2-3b's (24 heads on 2,
     head_dim 128), each with a window shorter than the context,
     atol = rtol = 1e-4; the
     all-masked lane and the padded prefill rows exactly 0;
     flash_attention at the calibration
     prefill's shape (512, 64, 12, 12, 64), a ring admission's (1, 32,
     12, 12, 64), a GQA case with a window and a ragged length, head_dim
     32 and 96 cases, S in {1, 63, 65, 129} at each head_dim (GQA, a
     window past one tile), and qwen3-4b's and starcoder2-3b's
     calibration prefills ((512, 64, 32, 8, 128), (512, 64, 24, 2, 128)
     with its 4096-token window), atol = rtol = 1e-4 (f32 sums in another
     order); bellman_backup at K = 24 and 64 on row-stochastic
     transitions, atol = rtol = 1e-5, and the whole solve in one launch
     (n = 6 at K = 24, n = 13 at K = 64) within 1e-5 of its plain
     version and EQUAL to n chained single launches; ssd_chunk at what
     the mamba2-130m
     calibration passes ((512, 1, 256, 24, 64, 128) with 64 valid rows,
     zeros after, q_valid 64), the same shape as a random full chunk, a
     ring admission's (1, 1, 256, ...) with q_valid 32, four chunks (2,
     4, 256, ...) with a ragged last one (q_valid 37), q_valid 1, 200 and
     256, all with dt and da drawn as the model makes them (softplus,
     a = -e, so exp overflows above the diagonal) and B/C broadcast over
     the heads with stride 0, and a small (2, 3, 32, 4, 32, 16) case
     with per-head B/C, atol = rtol = 2e-4, every output finite and the
     y rows past q_valid exactly 0; ramp_exit at the
     readout's (8, 50 257, K 24) with x_idx spread over 0..K+1, a
     ragged (3, 50 257), mamba2's V of 50 280, the JAX test's (4, 1000,
     16), (8, 4096, 32) and (3, 2048, 64), (512, 50 257, 24), row
     views of a wider tensor starting at elements 1, 2 and 3 (row
     starts off 16 bytes), one row with a dominant logit (conf -> 1)
     beside one of equal logits (conf = 1/V), 64 lanes at qwen3-4b's
     vocab of 151 936, one lane, a (1, 7) row shorter than its two
     splits' 16-byte words, and bf16 logits (also as a view at element
     5): loss within atol = rtol = 1e-5 of the plain version, and
     bin, new_x and stop EQUAL to the plain decision recomputed from
     the kernel's own loss (a loss a few ulp from a support edge may
     land in the neighbouring bin of the plain loss: such flips, and the
     lanes within 2 ulp of an edge, are counted and printed);
  3. checks the full-width model on small inputs: a prefill chunk and a
     decode token through the paged kernels, through the page gather on
     the card and through the page gather on the CPU agree within
     atol = rtol = 1e-3; a whole-prompt prefill into ring caches
     through the flash kernel, through the einsum path on the card and
     on the CPU agrees within 1e-3 (logits, node losses), with equal
     ring positions and ring K/V within a bf16 ulp (1e-2); the line
     solve of the serve's own calibration (512 x 64 numpy-seeded
     prompts, k 24, lambda 0.5) through the Bellman kernel and through
     the plain backup gives equal stop tables and cont / phi / sigma /
     value within rtol 1e-5, the kernel launched once for the solve
     (then the plain solve, the one-launch route and the route before
     it, n chained single launches, timed in turns as eager calls with
     a sync, median of 20);
     full-width mamba2-130m prefills two
     300-token prompts (two chunks, the second ragged) through the
     ssd_chunk kernel, through the einsum path on the card and on the
     CPU: logits, node losses and SSM state within 1e-3, the bf16 conv
     state within one bf16 ulp beyond the 1e-3 of the rows it rounds;
     then one decode token from each path's state within 1e-3; the
     exit decision on the model (ramp_exit's path): from the same
     calibration cascade, the readout logits of full-width
     paper-ee-100m at each of its 6 nodes for 8 numpy-seeded lanes go
     through ramp_exit with ``tables.stop[node + 1]`` and through the
     port's RecallIndexStrategy.observe (plain, on the card): lam * ell
     within 1e-5 of the kernel's loss, and the strategy fed the
     kernel's loss (lam 1) keeps the kernel's bin, x index and stop
     exactly; then granite-3-2b, qwen3-4b and starcoder2-3b at full
     width, each built on the card and freed before the next (their
     10-16 GB of f32 weights get no CPU copy): the paged chunk plus
     decode token through the kernels against the page gather, and the
     flash prefill against the einsum path, within 1e-3;
  4. times each kernel and its plain version with CUDA events — device
     time from CUDA graph replay, and the time of an eager call, host
     included — on the chunked serve's shapes, at 1024-token contexts
     and at the serve's histories with qwen3-4b's and starcoder2-3b's
     widths (paged pair), the calibration prefill's, a ring admission's
     and the two dense configs' calibration shapes
     (flash_attention, each beside one call of
     ``F.scaled_dot_product_attention(is_causal=True)``, a yardstick the
     port never calls), the calibration's real call, a random full
     chunk and a ring admission (ssd_chunk, which no PyTorch call
     computes), one backup at K = 24 and the serve's solve (n = 6, K =
     24) in one launch, beside the 6 chained single launches, minimums
     and stacks it replaced (bellman_backup), the readout's (8, 50 257,
     K 24), 512 lanes of it and 64 lanes of qwen3-4b's 151 936 vocab
     (ramp_exit, which no PyTorch call computes); prints
     ``launch_floor_ms``, the graph-replay time of an in-place add on
     one element (the cheapest launch); computes each case's bound from
     its inputs (for ssd_chunk only the rows below q_valid, and its
     products at 3 x their flops at the TF32 tensor-core rate, the f32
     figure beside), and times both calibration prefills (paper-ee-100m
     with and without --flash, mamba2-130m with and without
     --ssd-kernel);
  5. replays the model-free steppers on the card and on the CPU: the
     same numpy trace bank (``ee_like_traces``, seed 0, 6 nodes),
     tables and seeded Poisson workload (16 req/s for 10 s, 8 lanes)
     through ``Server`` + ``SimStepper`` under recall_index, FIFO with
     chunked prefill and again EDF with static batching, then a
     two-rung ``CascadeSimStepper`` (6 + 6 nodes) under skip_recall
     with the recall policy, each under an ``Observability``; every
     request's served nodes, token count, virtual TTFT and finish, the
     cascade's stats, and each serve's span digest and decision digest
     must be EQUAL on the two devices (a sha256 of the records and the
     digests are printed);
     then the control plane's adaptive leg (`bench.adaptive`: the
     reference bench's diurnal workload, gear bank and controller, with
     online recalibration) — at least 2 gear switches and 1
     recalibration, every request finished, one set of bank storages
     decided with across every publish (``decide_cache_size() == 1``,
     the reserved tensors' data_ptrs kept), records, switch/publish
     logs and the leg's decision attribution (read off its tracer)
     EQUAL on the two devices; and a chaos serve of the two-rung
     cascade sim under a seeded FaultPlan (cancellations, deadlines, a
     rung-1 stall, a page squeeze) with the degrade governor and a
     rung-0 pool — requests reaped and completed, escalations denied,
     the pool drained, records and governor stats EQUAL;
  6. serves at full width through ``repro_torch.launch.serve.main``
     twenty-four times — paper-ee-100m chunked paged under recall_index and
     under always_last (the paged pair's path), the ring server with
     --flash --dp-kernel under recall_index (flash and Bellman's path),
     the one-shot batch with --flash --dp-kernel; mamba2-130m's ring
     server with --ssd-kernel --dp-kernel under recall_index (ssd_chunk's
     path) and its one-shot batch with --ssd-kernel; then paper-ee-100m
     chunked paged for 1 s under each other online policy of the
     registry: tree_index, skip_recall, norecall_threshold,
     recall_threshold, norecall_patience and always_first; a two-model
     cascade of full-width paper-ee-100m (rungs seeded 0 and 1, 12
     global nodes, 8 + 4 lanes) through the paged pair on both rungs,
     under skip_recall with the recall policy for 2 s
     (``cascade_recall``) and under recall_threshold with the commit
     policy for 1 s (``cascade_commit``), each required to escalate and
     catch up on rung 1 (and to commit), printing the per-rung token
     shares, escalations, de-escalations and re-pinned tokens; and,
     last, chunked paged under recall_index in EDF order with a 200 ms
     SLO and ``--eos`` set to the most frequent token of the first
     serve (``chunked_edf_eos``: a request is complete with all its
     tokens or when its last token is that one; at least one must end
     early); then granite-3-2b, qwen3-4b and starcoder2-3b chunked paged
     with --flash --dp-kernel under recall_index, qwen3-4b under
     always_last (36 layers a token), qwen3-4b under --adaptive (a
     diurnal workload, three gears; the controller's stats printed),
     qwen3-4b under --cancel-rate 0.25, --kv-reclaim 0.5 and a
     --deadline-ms of half the recall_index serve's median e2e latency
     (some requests reaped, the rest complete, the pool drained), and the
     two-rung cascade under a --faults plan with a rung-1 stall over its
     first second (the governor must deny an escalation into the
     stalled rung; both pools drained) — with every kernel's launch
     counter set to 0 just before
     each serve and read just after; every request must complete with
     its full token count, each path's kernels must launch (the Bellman
     kernel once a line solve on the --dp-kernel serves), and the
     kernels of other paths (ramp_exit in every serve: no serve calls
     it) must not;
     Every server serve but ``chunked_recall_index`` runs under a tracer
     (``--trace-out build/obs/<name>.json``): each serve's line gives
     the calibration's synchronized host time (``ServeRun.calib_s``),
     the serve loop's time (the metrics' start and end) and its steps
     split from the tracer's events — a step ends with its ``counter``
     event and carried a prefill chunk if a ``prefill_chunk`` event
     falls inside it; their count must equal the metrics' steps.  Right
     after ``chunked_recall_index`` the same serve runs again under
     ``--obs-dir build/obs/obs_chunked_recall_index --regret``
     (``obs_chunked_recall_index``): its streams must equal the
     untraced serve's, the paged pair must launch, the ledger must
     report no violation, every request's span must run queued ->
     admitted -> prefill_chunk... -> token... -> finish, the token
     events must count the served tokens and the chunk widths the
     computed prompt tokens, and trace, events, metrics, ledger, regret
     and pareto JSON must parse; it prints the tracer's stats, the
     regret headline, the loss map's top causes and the tracer's host
     cost a step (the serve's events re-emitted through a fresh tracer
     with the ledger, flight recorder and regret meter bound); then the
     same serve for 0.5 s under ``--profile-dir build/profile``
     (``profiled_chunked_recall_index``), whose Chrome trace gives the
     capture's device busy time, idle share, device ops, host syncs
     and top device ops.  ``phase_decode_profile`` traces, after the
     two qwen3-4b serves, three decode-only steps through the serve's
     own stepper, and after ``qwen3_chunked_recall_index`` also three
     steps that carry a prefill chunk (lane 0 decoding, lanes 1-7
     prefilling fresh 32-token prompts); each set is traced twice, the
     second time with a ``SpanTracer`` on the stepper, and the host
     syncs a step must be the same;
  7. prints a ``kernels`` JSON line (``launches`` is each kernel's
     count on its own main path — for ramp_exit the decision check;
     ``launches_by_path`` holds every path's; the times are the first
     timed case's — for bellman_backup the solve's, the case its path
     runs — ``timed_cases`` holds every case of a kernel timed at more
     than one, ``resources`` what the runtime reported; the object also
     carries ``launch_floor_ms``), the card line, and last ``{"ok":
     true, "device": {...}}``.

It exits nonzero, printing no result, when CUDA is not available, when
the repository's sources are not beside it, or when any check fails.
"""

from __future__ import annotations

import collections
import gc
import hashlib
import importlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available — this script needs an "
             "NVIDIA GPU")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config                    # noqa: E402
from repro_torch.core import traces                           # noqa: E402
from repro_torch.core.line_dp import solve_line               # noqa: E402
from repro_torch.kernels import (bellman_backup,              # noqa: E402
                                 bellman_backup_plain, bellman_solve,
                                 bellman_solve_plain, build,
                                 flash_attention, flash_attention_plain,
                                 paged_attention, paged_attention_plain,
                                 paged_prefill, paged_prefill_plain,
                                 ramp_exit, ramp_exit_plain, ssd_chunk,
                                 ssd_chunk_plain)
from repro_torch.launch import serve                          # noqa: E402
from repro_torch.models import attention as A                 # noqa: E402
from repro_torch.models import blocks                         # noqa: E402
from repro_torch.models import model as M                     # noqa: E402
from repro_torch.models.param import materialize, tree_map    # noqa: E402
from repro_torch.serving import runtime as rt                 # noqa: E402
from repro_torch.serving.cascade import (CascadeSimStepper,   # noqa: E402
                                         ModelBank, ModelSpec)
from repro_torch.bench import adaptive as legs                 # noqa: E402
from repro_torch.serving.faults import (DegradeGovernor,      # noqa: E402
                                        FaultPlan)
from repro_torch.serving.kvpool import KVPool                 # noqa: E402
from repro_torch.serving.obs import (FlightRecorder,          # noqa: E402
                                     InvariantLedger, Observability,
                                     RegretMeter, SpanTracer)
from repro_torch.serving.obs.export import PROFILE_TRACE      # noqa: E402
from repro_torch.serving.obs.lossmap import goodput_lossmap   # noqa: E402
from repro_torch.strategy.base import array_leaves            # noqa: E402
from repro_torch.serving.runtime.request import Request       # noqa: E402
from repro_torch.serving.runtime.server import arrays_to      # noqa: E402
from repro_torch.serving.runtime.workload import WorkloadSpec  # noqa: E402
from repro_torch.strategy import Cascade, RecallIndexStrategy  # noqa: E402
from repro_torch.strategy import make as make_strategy         # noqa: E402

DEV = torch.device("cuda")
TOL_KERNEL = 1e-4
TOL_DP = 1e-5
TOL_MODEL = 1e-3
TOL_BF16 = 1e-2
TOL_SSD = 2e-4
TOL_EXIT = 1e-5              # the JAX package's own ramp_exit tolerance
HBM_BYTES_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_S = 67e12           # H100 SXM f32 outside the tensor cores
TF32_FLOP_S = 494.7e12       # H100 SXM TF32 tensor cores, dense
# the serve path's shapes (full-width paper-ee-100m)
B, H, HKV, HD, PS, MAXP, C = 8, 12, 12, 64, 16, 8, 16
LOAD = ["--lanes", str(B), "--rate", "8", "--duration", "2", "--tokens",
        "16", "--prompt-len", "32", "--lam", "0.5", "--device", "cuda"]
TRAFFIC = ["--arch", "paper-ee-100m"] + LOAD
SERVE_ARGS = TRAFFIC + ["--server", "--kv", "paged", "--page-size", str(PS),
                        "--prefill-chunk", str(C), "--paged-kernel"]
ONE_SHOT = ["--batch", "8", "--tokens", "16", "--prompt-len", "32",
            "--cache-len", "128", "--lam", "0.5", "--device", "cuda"]
# every serve the script drives: (name, argv, kernels that must launch,
# kernels that must not)
PAGED, NEW = ("paged_attention", "paged_prefill"), ("flash_attention",
                                                     "bellman_backup")
ATTN = PAGED + ("flash_attention",)
EXIT = ("ramp_exit",)          # no serve calls it: its path is the check
# the other online policies of the registry, each served chunked paged
POLICIES = ("tree_index", "skip_recall", "norecall_threshold",
            "recall_threshold", "norecall_patience", "always_first")
SERVES = [
    ("chunked_recall_index", SERVE_ARGS + ["--policy", "recall_index"],
     PAGED, ("ssd_chunk",) + EXIT),
    ("chunked_always_last", SERVE_ARGS + ["--policy", "always_last"],
     PAGED, ("ssd_chunk",) + EXIT),
    ("ring_recall_index", TRAFFIC + ["--server", "--kv", "ring", "--flash",
                                     "--dp-kernel", "--policy",
                                     "recall_index"], NEW,
     PAGED + ("ssd_chunk",) + EXIT),
    ("one_shot", ["--arch", "paper-ee-100m", "--flash", "--dp-kernel"]
     + ONE_SHOT, NEW, PAGED + ("ssd_chunk",) + EXIT),
    ("mamba_ring_recall_index",
     ["--arch", "mamba2-130m"] + LOAD + ["--server", "--kv", "ring",
                                         "--ssd-kernel", "--dp-kernel",
                                         "--policy", "recall_index"],
     ("ssd_chunk", "bellman_backup"), ATTN + EXIT),
    ("mamba_one_shot", ["--arch", "mamba2-130m", "--ssd-kernel"] + ONE_SHOT,
     ("ssd_chunk",), ATTN + EXIT),
] + [(f"chunked_{p}", SERVE_ARGS + ["--policy", p, "--duration", "1"],
      PAGED, NEW + ("ssd_chunk",) + EXIT) for p in POLICIES]
# the two-model cascade of full-width paper-ee-100m (rungs seeded 0 and
# 1, 12 global nodes), through the paged pair on both rungs
CASCADE_ARGS = (["--cascade", "paper-ee-100m:paper-ee-100m"] + LOAD
                + ["--server", "--paged-kernel", "--prefill-chunk", str(C),
                   "--page-size", str(PS), "--escalate-patience", "4",
                   "--cascade-lanes", "4"])
CASCADE_SERVES = [
    ("cascade_recall", CASCADE_ARGS + ["--policy", "skip_recall",
                                       "--escalate-policy", "recall"],
     PAGED, NEW + ("ssd_chunk",) + EXIT),
    ("cascade_commit", CASCADE_ARGS + ["--policy", "recall_threshold",
                                       "--escalate-policy", "commit",
                                       "--duration", "1"],
     PAGED, NEW + ("ssd_chunk",) + EXIT),
]
# EDF order, a 200 ms SLO and an eos token: the workload of
# chunked_recall_index (2 s, so the same requests) and the token that
# serve emits most often before a stream's last token (appended when
# that serve has run)
EDF_EOS = ("chunked_edf_eos", SERVE_ARGS + ["--policy", "recall_index",
                                            "--order", "edf", "--slo-ms",
                                            "200"],
           PAGED, NEW + ("ssd_chunk",) + EXIT)
# the dense tied-embedding configs at full width: the launcher's normal
# calibration (512 x 64 numpy prompts, k 24) under the same load, the
# paged pair at head_dim 128 and GQA groups of 4 and 12
DENSE = ("granite-3-2b", "qwen3-4b", "starcoder2-3b")
DENSE_PAGED = LOAD + ["--server", "--kv", "paged", "--page-size", str(PS),
                      "--prefill-chunk", str(C), "--paged-kernel"]
DENSE_RECALL = {a: ["--arch", a] + DENSE_PAGED + [
    "--flash", "--dp-kernel", "--policy", "recall_index"] for a in DENSE}
DENSE_SERVES = [
    (f"{a.split('-')[0]}_chunked_recall_index", DENSE_RECALL[a],
     PAGED + NEW, ("ssd_chunk",) + EXIT) for a in DENSE] + [
    ("qwen3_chunked_always_last",
     ["--arch", "qwen3-4b"] + DENSE_PAGED + ["--policy", "always_last"],
     PAGED, NEW + ("ssd_chunk",) + EXIT),
    # the gear bank's calibration is its own (128 x 32 prompts); the
    # policy's tables are not used under --adaptive, so none are solved
    ("qwen3_adaptive",
     ["--arch", "qwen3-4b"] + DENSE_PAGED + [
         "--policy", "always_last", "--adaptive", "--gears",
         "quality:0.95,balanced:0.92,turbo:0.75", "--workload", "diurnal"],
     PAGED, NEW + ("ssd_chunk",) + EXIT)]
# qwen3-4b under reaping: --deadline-ms is appended from the e2e
# latencies of qwen3_chunked_recall_index (the same requests)
QWEN3_FAULTS = ("qwen3_faults",
                DENSE_RECALL["qwen3-4b"] + ["--cancel-rate", "0.25",
                                            "--kv-reclaim", "0.5"],
                PAGED + NEW, ("ssd_chunk",) + EXIT)
# the two-rung cascade under a fault plan the script writes: rung 1
# stalled over the first escalations, deadlines on every request
CASCADE_FAULTS = ("cascade_faults",
                  CASCADE_ARGS + ["--policy", "skip_recall",
                                  "--escalate-policy", "recall"],
                  PAGED, NEW + ("ssd_chunk",) + EXIT)
# the main path again under the whole observability plane (--obs-dir:
# Perfetto trace, event log, metrics, ledger; --regret: regret and
# Pareto), held to the untraced chunked_recall_index serve's streams;
# then once more for 0.5 s under torch.profiler (--profile-dir)
OBS_ROOT = ROOT / "build" / "obs"
UNTRACED = "chunked_recall_index"
OBS_SERVE = ("obs_chunked_recall_index",
             SERVE_ARGS + ["--policy", "recall_index", "--regret",
                           "--obs-dir",
                           str(OBS_ROOT / "obs_chunked_recall_index")],
             PAGED, NEW + ("ssd_chunk",) + EXIT)
PROFILE_SERVE = ("profiled_chunked_recall_index",
                 SERVE_ARGS + ["--policy", "recall_index", "--duration",
                               "0.5", "--profile-dir",
                               str(ROOT / "build" / "profile")],
                 PAGED, NEW + ("ssd_chunk",) + EXIT)
OBS_FILES = ("trace.json", "events.json", "metrics.json", "ledger.json",
             "regret.json", "pareto.json")
SYNC_OPS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize")
# the serves whose decode-only steps are traced after they end, and the
# one whose chunk steps are traced too
PROFILED = ("qwen3_chunked_recall_index", "qwen3_chunked_always_last")
CHUNK_PROFILED = "qwen3_chunked_recall_index"
DECISION = "decision_check"
SIM_DEVICES = ("cuda", "cpu")   # the sim digest's two devices
MAIN_PATH = {"paged_attention": "chunked_recall_index",
             "paged_prefill": "chunked_recall_index",
             "flash_attention": "ring_recall_index",
             "bellman_backup": "ring_recall_index",
             "ssd_chunk": "mamba_ring_recall_index",
             "ramp_exit": DECISION}
# the timed case whose numbers the ``kernels`` line gives (else the
# kernel's first): the one its main path runs
MAIN_CASE = {"bellman_backup": "solve n=6 K=24"}
KERNELS = {"paged_attention": paged_attention, "paged_prefill": paged_prefill,
           "flash_attention": flash_attention,
           "bellman_backup": bellman_backup, "ssd_chunk": ssd_chunk,
           "ramp_exit": ramp_exit}
PLAINS = {"paged_attention": paged_attention_plain,
          "paged_prefill": paged_prefill_plain,
          "flash_attention": flash_attention_plain,
          "bellman_backup": bellman_backup_plain,
          "ssd_chunk": ssd_chunk_plain, "ramp_exit": ramp_exit_plain}
# the wrappers' modules (the package attributes of these names are the
# wrapper functions)
PA_MOD = importlib.import_module("repro_torch.kernels.paged_attention")
PP_MOD = importlib.import_module("repro_torch.kernels.paged_prefill")
FLASH_MOD = importlib.import_module("repro_torch.kernels.flash_attention")
SSD_MOD = importlib.import_module("repro_torch.kernels.ssd_chunk")
EXIT_MOD = importlib.import_module("repro_torch.kernels.ramp_exit")
BELLMAN_MOD = importlib.import_module("repro_torch.kernels.bellman_backup")
LINE_DP = importlib.import_module("repro_torch.core.line_dp")
SOURCES = {
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:87"),
    "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                      "src/repro/kernels/paged_prefill.py:120"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:87"),
    "bellman_backup": ("src/repro_torch/csrc/bellman_backup.cu",
                       "src/repro/kernels/bellman_backup.py:38"),
    "ssd_chunk": ("src/repro_torch/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_chunk.py:60"),
    "ramp_exit": ("src/repro_torch/csrc/ramp_exit.cu",
                  "src/repro/kernels/ramp_exit.py:70")}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# ---------------------------------------------------------------------------
# inputs at the serve path's shapes (numpy-seeded)
# ---------------------------------------------------------------------------

def pool_inputs(rng, lens, *, hkv, hd, holes=True, maxp=MAXP):
    """A page pool holding each lane's history of ``lens[i]`` positions
    (page 0 = garbage sink, position -1) in a ``maxp``-wide table, stale
    positions in the tails of partly filled pages, and -1 holes in lane
    0's first page."""
    n_pages = 1 + sum(-(-n // PS) for n in lens)
    k = (rng.normal(size=(n_pages, PS, hkv, hd)) * 0.5).astype(np.float32)
    v = (rng.normal(size=(n_pages, PS, hkv, hd)) * 0.5).astype(np.float32)
    pos = np.full((n_pages, PS), -1, np.int32)
    table = np.zeros((len(lens), maxp), np.int32)
    nxt = 1
    for lane, n in enumerate(lens):
        for j in range(-(-n // PS)):
            lo = j * PS
            w = min(PS, n - lo)
            pos[nxt, :w] = np.arange(lo, lo + w)
            pos[nxt, w:] = np.arange(n, n + PS - w)
            table[lane, j] = nxt
            nxt += 1
    if holes and lens[0] > 0:
        pos[table[0, 0], 1::3] = -1
    return (torch.from_numpy(k).to(DEV, torch.bfloat16),
            torch.from_numpy(v).to(DEV, torch.bfloat16),
            torch.from_numpy(pos).to(DEV), torch.from_numpy(table).to(DEV))


# histories of the timed cases: what the serve below gives the kernels
# (32-token prompts in 16-token chunks, then up to 16 decoded tokens)
SERVE_LENS = [33, 48, 40, 35, 47, 38, 44, 36]
SERVE_STARTS, SERVE_WIDTHS = [0, 16, 0, 16, 16, 0, 16, 0], [C] * B
# the long-context cases: GPT-2-small's 1024-token context (the scale
# paper-ee-100m copies), 64 pages a lane
LONG_MAXP = 64
LONG_LENS = [1024, 993, 1010, 1001, 1017, 996, 1023, 1005]
LONG_STARTS = [1008, 1000, 1004, 993, 1008, 1001, 996, 1006]
# the GQA cases at the dense configs' widths: qwen3-4b's (32 heads on 8
# kv heads, head_dim 128) and starcoder2-3b's (24 heads on 2 kv heads,
# head_dim 128)
G4 = dict(h=32, hkv=8, hd=128)
G12 = dict(h=24, hkv=2, hd=128)


def decode_case(seed, *, h=H, hkv=HKV, hd=HD, window=None, maxp=MAXP,
                lens=(48, 33, 17, 128, 1, 64, 0, 90)):   # lane 6: masked
    rng = np.random.default_rng(seed)
    k, v, pos, table = pool_inputs(rng, lens, hkv=hkv, hd=hd, maxp=maxp)
    q_pos = torch.tensor([max(n, 1) - 1 if n else -1 for n in lens],
                         dtype=torch.int32, device=DEV)
    q = torch.from_numpy((rng.normal(size=(B, h, hd)) * 0.5)
                         .astype(np.float32)).to(DEV)
    return (q, k, v, pos, table, q_pos), dict(scale=hd ** -0.5,
                                              window=window)


def prefill_case(seed, *, h=H, hkv=HKV, hd=HD, window=None, maxp=MAXP,
                 starts=(16, 0, 21, 48, 5, 0, 32, 100),   # mid-page 21, 5
                 widths=(16, 16, 11, 16, 3, 0, 16, 7)):   # lane 5 idle
    rng = np.random.default_rng(seed)
    k, v, pos, table = pool_inputs(rng, starts, hkv=hkv, hd=hd, maxp=maxp)
    q_pos = np.full((B, C), -1, np.int32)
    for lane, (s, w) in enumerate(zip(starts, widths)):
        q_pos[lane, :w] = np.arange(s, s + w)
    q_pos = torch.from_numpy(q_pos).to(DEV)
    start = torch.tensor(starts, dtype=torch.int32, device=DEV)

    def rnd(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.5)
                                .astype(np.float32)).to(DEV)

    q, ck, cv = rnd(B, C, h, hd), rnd(B, C, hkv, hd), rnd(B, C, hkv, hd)
    return (q, k, v, pos, table, q_pos, start, ck, cv, q_pos), \
        dict(scale=hd ** -0.5, window=window)


# ---------------------------------------------------------------------------
# bounds: the bytes each call must move and the flops its inputs need
# ---------------------------------------------------------------------------

def _visible(kpos, qp, window):
    ok = (kpos >= 0) & (kpos <= qp)
    if window is not None:
        ok &= kpos > qp - window
    return ok


def decode_bound(args, kw):
    """Bytes and flops one decode call needs on these inputs: q of the
    live lanes in and all of out written once; the positions and table
    entries of the visited pages; the K and V rows of the visible keys
    only (the kernel skips a masked slot before it reads K or V)."""
    q, k, v, pos, table, q_pos = args
    b, h, hd = q.shape
    hkv = k.shape[2]
    qp = q_pos.long().cpu()
    n_used = torch.clamp(torch.div(qp, PS, rounding_mode="floor") + 1,
                         min=0, max=table.shape[1])
    pages = int(n_used.sum())
    tab, posc = table.cpu().long(), pos.cpu()
    keys = 0
    for lane in range(b):
        kp = posc[tab[lane, :int(n_used[lane])]].reshape(-1)
        keys += int(_visible(kp, int(qp[lane]), kw["window"]).sum())
    live = int((qp >= 0).sum())
    nbytes = (live * h * hd * 4 + q.numel() * 4       # q in, out
              + keys * hkv * hd * 2 * 2                # visible K and V
              + pages * PS * 4 + pages * 4 + b * 4)    # pos, table, q_pos
    flops = keys * h * 4 * hd
    return nbytes, flops


def prefill_bound(args, kw):
    """Bytes and flops one prefill-chunk call needs on these inputs: q
    of the rows at a position >= 0 in and all of out written once; the
    in-flight k/v of those rows; the positions and table entries of the
    visited history pages; the K and V rows of the history keys that
    some row of the lane sees.  c_pos is q_pos, so it is read once."""
    q, k, v, pos, table, q_pos, start, ck, cv, c_pos = args
    b, c, h, hd = q.shape
    hkv = k.shape[2]
    st = start.long().cpu()
    n_hist = torch.clamp(-torch.div(-st, PS, rounding_mode="floor"), 0,
                         table.shape[1])
    pages = int(n_hist.sum())
    tab, posc, qpc = table.cpu().long(), pos.cpu(), q_pos.cpu()
    pairs = hist_rows = 0
    for lane in range(b):
        kp = posc[tab[lane, :int(n_hist[lane])]].reshape(-1)
        kp = kp[kp < int(st[lane])]
        seen = torch.zeros(kp.shape, dtype=torch.bool)
        for row in range(c):
            qp = int(qpc[lane, row])
            if qp < 0:
                continue
            vis = _visible(kp, qp, kw["window"])
            seen |= vis
            pairs += int(vis.sum())
            pairs += int(_visible(qpc[lane], qp, kw["window"]).sum())
        hist_rows += int(seen.sum())
    rows = int((qpc >= 0).sum())
    nbytes = (rows * h * hd * 4 + q.numel() * 4        # q in, out
              + rows * hkv * hd * 4 * 2                 # in-flight k, v
              + hist_rows * hkv * hd * 2 * 2            # history K and V
              + pages * PS * 4 + pages * 4              # pos, table
              + q_pos.numel() * 4 + b * 4)              # q_pos, start
    flops = pairs * h * 4 * hd
    return nbytes, flops


# flash attention: (b, s, h, hkv, hd, window) — the calibration
# prefill's shape first and a ring admission's (timed), then a GQA case
# with a window and lengths at the 64-row tile's edges at every head
# dim, then the dense configs' calibration prefills (timed)
FLASH_CASES = [("calibration", (512, 64, 12, 12, 64, None)),
               ("ring-admission", (1, 32, 12, 12, 64, None)),
               ("gqa-window-ragged", (2, 200, 8, 2, 128, 48)),
               ("hd32", (4, 100, 4, 2, 32, None)),
               ("hd96", (2, 130, 6, 3, 96, 40))] + [
    (f"s{s}-hd{hd}", (2, s, 4, 2, hd, 24 if s > 64 else None))
    for s in (1, 63, 65, 129) for hd in (32, 64, 96, 128)] + [
    # the dense configs' calibration prefills (starcoder2-3b's window of
    # 4096 is longer than the 64-token prompts)
    ("qwen3-4b-calibration", (512, 64, 32, 8, 128, None)),
    ("starcoder2-3b-calibration", (512, 64, 24, 2, 128, 4096))]
FLASH_TIMED = ("calibration", "ring-admission", "qwen3-4b-calibration",
               "starcoder2-3b-calibration")


def flash_case(seed, b, s, h, hkv, hd, window):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(DEV)

    return (rnd(b, s, h, hd), rnd(b, s, hkv, hd), rnd(b, s, hkv, hd)), \
        dict(scale=hd ** -0.5, window=window)


def bellman_case(seed, k):
    """One backup as the line solve gives it: phi rows sorted along X, a
    row-stochastic transition, the min-index table of a sorted grid."""
    rng = np.random.default_rng(seed)
    x = k + 2
    grid = np.sort(rng.uniform(0.01, 1.0, k)).astype(np.float32)
    xv = np.concatenate([[0.0], grid, [grid[-1] * 1e4 + 1e4]])
    mi = np.where(xv[:, None] <= grid[None, :], np.arange(x)[:, None],
                  np.arange(1, k + 1)[None, :])
    phi = np.sort(rng.uniform(0, 1, (k, x)), axis=1).astype(np.float32)
    trans = rng.dirichlet(np.ones(k), size=k).astype(np.float32)
    return (torch.from_numpy(phi).to(DEV), torch.from_numpy(trans).to(DEV),
            torch.tensor(0.17, dtype=torch.float32, device=DEV),
            torch.from_numpy(mi.T.astype(np.int32).copy()).to(DEV)), {}


def solve_case(seed, n, k):
    """A whole backward solve as `solve_line` gives it: the base phi
    (xvals on every row), n row-stochastic transitions, positive costs
    on the card, the X axis and the min-index table of a sorted grid."""
    rng = np.random.default_rng(seed)
    grid = np.sort(rng.uniform(0.01, 1.0, k)).astype(np.float32)
    xv = np.concatenate([[0.0], grid, [grid[-1] * 1e4 + 1e4]]).astype(
        np.float32)
    mi = np.where(xv[:, None] <= grid[None, :], np.arange(k + 2)[:, None],
                  np.arange(1, k + 1)[None, :])
    trans = rng.dirichlet(np.ones(k), size=(n, k)).astype(np.float32)
    costs = rng.uniform(0.01, 0.2, n).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)

    return (dev(np.tile(xv, (k, 1))), dev(trans), dev(costs), dev(xv),
            dev(mi.T.astype(np.int32))), {}


def bellman_chain(base, trans_full, costs, xvals, mi_t):
    """The solve as n single-backup launches, each followed by its
    minimum, then the two stacks: the route `solve_line(use_kernel=True)`
    took before the one-launch solve."""
    conts, phis = [], [base]
    for i in reversed(range(trans_full.shape[0])):
        conts.append(bellman_backup(phis[-1], trans_full[i], costs[i:i + 1],
                                    mi_t))
        phis.append(torch.minimum(xvals[None, :], conts[-1]))
    return torch.stack(conts[::-1]), torch.stack(phis[::-1])


def flash_bound(args, kw):
    """Bytes and flops one flash call needs: q in and out written once;
    every key row is visible to its own query row, so all of k and v is
    read once; 4 * hd flops per visible (row, key) pair and query
    head."""
    q, k, v = args
    b, s, h, hd = q.shape
    seen = torch.arange(1, s + 1)
    if kw["window"] is not None:
        seen = torch.clamp(seen, max=kw["window"])
    pairs = int(seen.sum()) * b * h
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    return nbytes, 4 * hd * pairs


def bellman_bound(args, kw):
    """Bytes and flops of one backup: phi, trans, mi_t and cost read
    once, cont written once; 2 * K flops per output."""
    phi, trans, cost, mi_t = args
    k, x = phi.shape
    nbytes = 4 * (2 * phi.numel() + trans.numel() + mi_t.numel() + 1)
    return nbytes, 2 * k * k * x


def solve_bound(args, kw):
    """Bytes and flops of a whole solve: base, transitions, costs, xvals
    and mi_t read once, cont (n, K, X) and phi (n + 1, K, X) written
    once; 2 * K flops per output of each of the n backups."""
    base, trans_full, costs, xvals, mi_t = args
    n, k, _ = trans_full.shape
    x = base.shape[1]
    nbytes = 4 * (sum(t.numel() for t in args) + (2 * n + 1) * k * x)
    return nbytes, 2 * n * k * k * x


# ssd chunk: (b, c, q, h, p, n, stride-0 B/C, q_valid) — first what the
# mamba2-130m calibration passes (64-token prompts: 64 valid rows of a
# 256-row chunk, zeros after) and a random full chunk (the timed
# cases), then a ring admission (32-token prompts), four chunks with a
# ragged last one, the q_valid edges and a small per-head case
SSD_CASES = [("calibration", (512, 1, 256, 24, 64, 128, True, 64)),
             ("full-chunk", (512, 1, 256, 24, 64, 128, True, None)),
             ("ring-admission", (1, 1, 256, 24, 64, 128, True, 32)),
             ("four-chunks", (2, 4, 256, 24, 64, 128, True, 37)),
             ("q_valid-1", (2, 1, 256, 24, 64, 128, True, 1)),
             ("q_valid-200", (2, 1, 256, 24, 64, 128, True, 200)),
             ("q_valid-256", (2, 1, 256, 24, 64, 128, True, 256)),
             ("small-per-head-bc", (2, 3, 32, 4, 32, 16, False, None))]
SSD_TIMED = ("calibration", "full-chunk", "ring-admission")


def ssd_case(seed, b, c, q, h, p, n, broadcast, q_valid):
    """Inputs drawn as the model makes them: dt = softplus(.), da = -e *
    dt (a_log = 1: exp(seg_i - seg_j) overflows above the diagonal);
    with ``broadcast`` B and C are one group expanded over the heads
    with stride 0, as `models.ssm` passes them; with ``q_valid`` the
    rows of the last chunk from it on are zero in every input, as
    `models.ssm` pads a prompt, and the call passes q_valid."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).to(DEV)

    dt = F.softplus(rnd(b, c, q, h))
    hb = 1 if broadcast else h
    x, bb, cc = rnd(b, c, q, h, p), rnd(b, c, q, hb, n), rnd(b, c, q, hb, n)
    if q_valid is not None:
        for t in (dt, x, bb, cc):
            t[:, -1, q_valid:] = 0.0
    if broadcast:
        bb, cc = bb.expand(b, c, q, h, n), cc.expand(b, c, q, h, n)
    return (x, dt, -np.e * dt, bb, cc), dict(q_valid=q_valid)


def _stored(t):
    """Elements a tensor holds in memory (a stride-0 axis counts once)."""
    return int(np.prod([s for s, st in zip(t.shape, t.stride()) if st]))


def ssd_bound(args, kw):
    """Bytes and flops one SSD-chunk call needs, counting only the rows
    below q_valid in the last chunk (the rest are the caller's zeros,
    which the function does not need): each of their stored input
    elements read once (B/C broadcast over the heads count once), all
    of y and the states written once; per (b, c, h) 2N + 2P flops for
    each visible (i >= j) pair of those rows and 2PN for each of them
    in the state (the count `flash_bound` uses: visible pairs only)."""
    xh, dt, da, bb, cc = args
    b, c, q, h, p = xh.shape
    n = bb.shape[-1]
    qv = kw.get("q_valid") or q
    rows = (c - 1) * q + qv                      # of the c * q stored
    nbytes = 4 * (sum(_stored(t) for t in args) * rows // (c * q)
                  + xh.numel() + b * c * h * p * n)
    pairs = (c - 1) * q * (q + 1) // 2 + qv * (qv + 1) // 2
    return nbytes, b * h * (pairs * (2 * n + 2 * p) + 2 * rows * p * n)


# exit decision: (b, v, k, bool table, variant) — the readout's shape
# first (the timed case)
EXIT_CASES = [("readout", (8, 50257, 24, True, "spread")),
              ("ragged-b3", (3, 50257, 24, True, None)),
              ("mamba2-v", (8, 50280, 24, True, None)),
              ("jax-4x1000", (4, 1000, 16, False, None)),
              ("jax-8x4096", (8, 4096, 32, False, None)),
              ("jax-3x2048", (3, 2048, 64, False, None)),
              ("b512", (512, 50257, 24, True, None)),
              ("row-view", (8, 50257, 24, True, "view3")),
              ("extremes", (2, 50257, 24, True, "extremes")),
              ("b64-v151936", (64, 151936, 24, True, None)),
              ("b1", (1, 50257, 24, True, None)),
              ("b1-v7", (1, 7, 24, True, None)),
              ("row-view-1", (8, 50257, 24, True, "view1")),
              ("row-view-2", (8, 50257, 24, True, "view2")),
              ("bf16", (8, 50257, 24, True, "bf16")),
              ("bf16-row-view-5", (8, 50257, 24, True, "bf16-view5"))]
EXIT_TIMED = ("readout", "b512", "b64-v151936")


def exit_case(seed, b, v, k, as_bool, variant):
    """Logits ~ N(0, 2) as the JAX test draws them, sorted edges in
    (0, 1), a random stop table (bool as the line DP's, or int32 as the
    JAX test's), lane state drawn at random; ``spread`` puts x_idx
    evenly over 0..K+1, ``view<o>`` passes the logits as a row view of a
    wider tensor starting at element o, ``bf16`` rounds them to bf16,
    ``extremes`` makes row 0 one dominant logit (conf 1) and row 1 equal
    logits (conf 1/V)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (b, v)).astype(np.float32)
    if variant == "extremes":
        logits[0] = 0.0
        logits[0, 123] = 60.0
        logits[1] = 0.5
    edges = np.sort(rng.uniform(0, 1, k - 1)).astype(np.float32)
    table = rng.integers(0, 2, (k, k + 2))
    s_bin = rng.integers(0, k, b).astype(np.int32)
    x_idx = (np.linspace(0, k + 1, b).round() if variant == "spread"
             else rng.integers(0, k + 2, b)).astype(np.int32)
    t = torch.from_numpy(logits).to(DEV)
    if variant and variant.startswith("bf16"):
        t = t.to(torch.bfloat16)
    if variant and "view" in variant:
        off = int(variant.split("view")[1])
        wide = torch.zeros((b, v + 7), dtype=t.dtype, device=DEV)
        wide[:, off:off + v] = t
        t = wide[:, off:off + v]
    table = table.astype(bool) if as_bool else table.astype(np.int32)
    return (t, torch.from_numpy(edges).to(DEV),
            torch.from_numpy(table).to(DEV), torch.from_numpy(s_bin).to(DEV),
            torch.from_numpy(x_idx).to(DEV)), dict(lam=0.6)


def exit_bound(args, kw):
    """Bytes and operations one exit decision needs: the logits, edges,
    table and x_idx read once (the function does not need s_bin), loss,
    bin, new_x and stop written once; 4 operations a logit (max,
    subtract, exp, add) and one compare an edge and lane."""
    logits, edges, table, s_bin, x_idx = args
    b, v = logits.shape
    nbytes = (b * v * logits.element_size() + 4 * edges.numel()
              + table.numel() * table.element_size() + 4 * b
              + (4 + 4 + 4 + 1) * b)
    return nbytes, 4 * b * v + b * edges.numel()


def bound_ms(nbytes, flops, rate=F32_FLOP_S):
    """The larger of the bytes over the memory rate and the operations
    over ``rate`` (f32 outside the tensor cores unless given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, iters=200, warm=20):
    """Mean time per eager call over ``iters`` back-to-back calls: the
    larger of the device time and the host's cost to issue the call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def launch_floor_ms():
    """Device time of the cheapest launch: an in-place add on a
    one-element tensor, by graph replay."""
    one = torch.zeros(1, device=DEV)
    return min(graph_ms(lambda: one.add_(1.0)) for _ in range(2))


def graph_ms(fn, calls=20, replays=10):
    """Device time per call: ``calls`` calls captured in one CUDA graph
    and replayed ``replays`` times, so the host's cost to issue each
    call is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (calls * replays)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    """Build every kernel; print what ptxas reports for each (registers,
    static shared memory, spills) and what the runtime reports at their
    timed shapes (for the paged pair also the splits of a lane's pages,
    for ramp_exit its cluster size and the clusters the card holds, for
    the Bellman kernel its threads).  Returns the latter."""
    t0 = time.perf_counter()
    built = build.build_all()
    wall = time.perf_counter() - t0
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"build {name}: {info['seconds']:.1f} s "
            f"({'; '.join(regs) or 'cached'})")
    log(f"kernel build wall time: {wall:.1f} s (all sources in parallel)")
    res = {}
    for name, info in (
            ("paged_attention", {
                case: PA_MOD.kernel_info(B, h, hkv, hd, PS, maxp)
                for case, (h, hkv, hd, maxp) in PAGED_TIMED.items()}),
            ("paged_prefill", {
                case: PP_MOD.kernel_info(B, C, h, hkv, hd, PS, maxp)
                for case, (h, hkv, hd, maxp) in PAGED_TIMED.items()}),
            ("flash_attention", {
                case: FLASH_MOD.kernel_info(shape[4], shape[1])
                for case, shape in FLASH_CASES if case in FLASH_TIMED}),
            ("ssd_chunk", {
                case: SSD_MOD.kernel_info(shape[2], shape[4], shape[5])
                for case, shape in SSD_CASES if case in SSD_TIMED}),
            ("bellman_backup", {
                "K=24": BELLMAN_MOD.kernel_info(1, 24, 26),
                "solve n=6 K=24": BELLMAN_MOD.kernel_info(6, 24, 26)}),
            ("ramp_exit", {
                case: EXIT_MOD.kernel_info(shape[0], shape[1])
                for case, shape in EXIT_CASES if case in EXIT_TIMED})):
        res[name] = info
        for case, r in info.items():
            log(f"resources {name} [{case}]: "
                + ", ".join(f"{k} {v}" for k, v in r.items()))
    return res


def phase_kernel_checks():
    """Each kernel against its plain version on the card."""
    errs = {name: 0.0 for name in KERNELS}
    cases = [("paged_attention", "mha", decode_case(0), TOL_KERNEL),
             ("paged_attention", "gqa-window",
              decode_case(1, hkv=6, window=24), TOL_KERNEL),
             ("paged_prefill", "mha", prefill_case(2), TOL_KERNEL),
             ("paged_prefill", "gqa-window",
              prefill_case(3, hkv=6, window=20), TOL_KERNEL),
             ("paged_attention", "serve", decode_case(4, lens=SERVE_LENS),
              TOL_KERNEL),
             ("paged_prefill", "serve",
              prefill_case(5, starts=SERVE_STARTS, widths=SERVE_WIDTHS),
              TOL_KERNEL),
             ("paged_attention", "long-context", long_decode_case(),
              TOL_KERNEL),
             ("paged_prefill", "long-context", long_prefill_case(),
              TOL_KERNEL),
             ("paged_attention", "g4-hd128-window",
              decode_case(8, window=40, **G4), TOL_KERNEL),
             ("paged_prefill", "g4-hd128-window",
              prefill_case(9, window=20, **G4), TOL_KERNEL),
             ("paged_attention", "g12-hd128-window",
              decode_case(50, window=40, **G12), TOL_KERNEL),
             ("paged_prefill", "g12-hd128-window",
              prefill_case(51, window=20, **G12), TOL_KERNEL)]
    cases += [("flash_attention", case, flash_case(10 + i, *shape),
               TOL_KERNEL) for i, (case, shape) in enumerate(FLASH_CASES)]
    cases += [("bellman_backup", f"K={k}", bellman_case(k, k), TOL_DP)
              for k in (24, 64)]
    cases += [("ssd_chunk", case, (lambda i=i, shape=shape:
                                   ssd_case(30 + i, *shape)), TOL_SSD)
              for i, (case, shape) in enumerate(SSD_CASES)]
    for name, case, inputs, tol in cases:
        args, kw = inputs() if callable(inputs) else inputs
        got = KERNELS[name](*args, **kw)
        torch.cuda.synchronize()
        want = PLAINS[name](*args, **kw)
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        # the largest |g - w| / (atol + rtol |w|): allclose holds below 1
        share = max(float(((g - w).abs() / (tol + tol * w.abs())).max())
                    for g, w in zip(got, want))
        ok = all(bool(torch.isfinite(g).all())
                 and torch.allclose(g, w, atol=tol, rtol=tol)
                 for g, w in zip(got, want))
        qv = kw.get("q_valid") if name == "ssd_chunk" else None
        if qv is not None:          # the skipped y rows: exact zeros
            ok &= bool((got[0][:, -1, qv:] == 0).all())
        log(f"check {name} [{case}] vs plain: max_abs_err {err:.3e}, "
            f"{share:.3f} of the tolerance at worst "
            f"(atol=rtol={tol}, outputs finite"
            + ("" if qv is None else f", y rows {qv}.. of the last chunk "
               "exactly 0") + f") {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name} [{case}] disagrees with its plain "
                             f"version: max_abs_err {err}")
        errs[name] = max(errs[name], err)
        del got, want, args
        torch.cuda.empty_cache()
    # the line solve in one launch: equal to n chained single launches
    for n, k in ((6, serve.CALIB_K), (13, 64)):
        args, _ = solve_case(n, n, k)
        got = bellman_solve(*args)
        chained = bellman_chain(*args)
        torch.cuda.synchronize()
        want = bellman_solve_plain(*args)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        same = all(torch.equal(g, c) for g, c in zip(got, chained))
        ok = same and all(torch.allclose(g, w, atol=TOL_DP, rtol=TOL_DP)
                          for g, w in zip(got, want))
        log(f"check bellman_solve [n={n} K={k}] vs plain: max_abs_err "
            f"{err:.3e} (atol=rtol={TOL_DP}); cont and phi "
            f"{'equal' if same else 'NOT equal'} to {n} chained single "
            f"launches {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"bellman_solve [n={n} K={k}] disagrees")
        errs["bellman_backup"] = max(errs["bellman_backup"], err)
    # masked rows/lanes come back exactly zero
    args, kw = decode_case(0)
    if paged_attention(*args, **kw)[6].abs().max() != 0:
        raise SystemExit("paged_attention: all-masked lane is not zero")
    args, kw = prefill_case(2)
    out = paged_prefill(*args, **kw)
    if out[args[5] < 0].abs().max() != 0:
        raise SystemExit("paged_prefill: padded rows are not zero")
    return errs


def exit_decision(loss, edges, table, x_idx):
    """The plain decision (bin, new_x, stop) from a given loss."""
    b = torch.searchsorted(edges, loss).to(torch.int32)
    nx = torch.minimum(x_idx, b + 1)
    return b, nx, table[b.long(), nx.long()] > 0


def near_edges(loss, edges, ulps=2):
    """Lanes whose loss lies within ``ulps`` f32 ulp of a support edge."""
    ulp = torch.nextafter(edges, torch.full_like(edges, float("inf"))) \
        - edges
    return ((loss[:, None] - edges[None, :]).abs()
            <= ulps * ulp[None, :]).any(dim=1)


def phase_exit_checks():
    """ramp_exit against its plain version at every case of
    `EXIT_CASES`: the loss within TOL_EXIT, the integers equal to the
    plain decision recomputed from the kernel's own loss."""
    worst = 0.0
    for i, (case, shape) in enumerate(EXIT_CASES):
        args, kw = exit_case(40 + i, *shape)
        logits, edges, table, s_bin, x_idx = args
        got = ramp_exit(*args, **kw)
        torch.cuda.synchronize()
        want = ramp_exit_plain(*args, **kw)
        err = float((got[0] - want[0]).abs().max())
        again = exit_decision(got[0], edges, table, x_idx)
        ok = (bool(torch.isfinite(got[0]).all())
              and torch.allclose(got[0], want[0], atol=TOL_EXIT,
                                 rtol=TOL_EXIT)
              and all(torch.equal(g, a) for g, a in zip(got[1:], again)))
        flips = int((got[1] != want[1]).sum())
        near = int((near_edges(got[0], edges)
                    | near_edges(want[0], edges)).sum())
        log(f"check ramp_exit [{case}] vs plain: loss max_abs_err "
            f"{err:.3e} (atol=rtol={TOL_EXIT}); bin/new_x/stop equal to "
            f"the plain decision from the kernel's loss; bins unlike the "
            f"plain loss's {flips}/{len(want[1])}, lanes within 2 ulp of "
            f"an edge {near} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"ramp_exit [{case}] disagrees with its plain "
                             f"version: loss max_abs_err {err}")
        if case == "extremes" and not (float(got[0][0]) == 0.0 and abs(
                float(got[0][1]) - 0.6 * (1 - 1 / shape[1])) < TOL_EXIT):
            raise SystemExit(f"ramp_exit [extremes]: losses "
                             f"{got[0].tolist()}")
        worst = max(worst, err)
        del got, want, args
    torch.cuda.empty_cache()
    return worst


def phase_model_check(params, params_cpu, cfg):
    """Full-width model on a small input: one 16-token prefill chunk for
    two lanes, then one decode token, through the kernels and through
    the page gather on the card, and through the gather on the CPU —
    or, with ``params_cpu`` None (the dense configs, whose 10-16 GB of
    weights stay on the card), the kernels against the gather."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, C)).astype(np.int32)
    widths = (C, 11)
    n_pages = 5
    table = np.asarray([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    pos = np.full((2, C), -1, np.int32)
    dp = np.zeros((2, C), np.int32)
    ds = np.zeros((2, C), np.int32)
    for lane, w in enumerate(widths):
        pos[lane, :w] = np.arange(w)
        dp[lane, :w] = table[lane, np.arange(w) // PS]
        ds[lane, :w] = np.arange(w) % PS
    dec_pos = np.asarray(widths, np.int32)
    outs = {}
    paths = [("kernel", params, DEV, True), ("gather", params, DEV, False)]
    if params_cpu is not None:
        paths.append(("cpu", params_cpu, torch.device("cpu"), False))
    for name, prm, dev, kern in paths:
        def t(a, dtype=torch.int32, dev=dev):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        caches = []
        for spec in M.paged_cache_specs(cfg, 2, n_pages, PS):
            caches.append({"attn": {
                k: (torch.full(s, -1, dtype=d, device=dev) if k == "pos"
                    else torch.zeros(s, dtype=d, device=dev))
                for k, (s, d) in spec["attn"].items()}})
        chunk = A.PrefillChunk(
            tok=t(toks), pos=t(pos), dest_page=t(dp), dest_slot=t(ds),
            start=t([0, 0]), last_idx=t([w - 1 for w in widths]),
            emit=t([True, True], torch.bool),
            active=t([True, True], torch.bool))
        kv = A.PagedKV(page_table=t(table),
                       write_page=t(table[np.arange(2), dec_pos // PS]),
                       write_slot=t(dec_pos % PS))
        with torch.no_grad(), A.paged_kernel(kern):
            x = prm["embed"]["table"][chunk.tok.long()]
            for si in range(len(cfg.segments)):
                x, _ = M.prefill_chunk_segment(prm, cfg, si, x, caches[si],
                                               kv.page_table, chunk)
            h = x[torch.arange(2, device=dev), chunk.last_idx.long()]
            first, _ = M.ramp_readout(prm, cfg, h)
            # a fixed decode token (not the argmax) keeps a near-tie in
            # the first-token logits from changing the decode input
            x = prm["embed"]["table"][t([7, 11]).long()][:, None, :]
            ells = []
            for si in range(len(cfg.segments)):
                x, _, ro = M.decode_segment(prm, cfg, si, x, caches[si],
                                            t(dec_pos), paged=kv,
                                            write_mask=t([True, True],
                                                         torch.bool))
                if ro is not None:
                    ells.append(ro[1])
            logits, ell = M.ramp_readout(prm, cfg, x[:, 0, :])
            ells.append(ell)
        outs[name] = [first.float().cpu(), logits.float().cpu(),
                      torch.stack(ells, 1).cpu()]
    pairs = ([("kernel", "cpu"), ("gather", "cpu")] if "cpu" in outs
             else [("kernel", "gather")])
    where = {"kernel": "kernels on the card", "gather": "gather on the card",
             "cpu": "gather on the CPU"}
    for name, ref in pairs:
        errs = [float((a - b).abs().max())
                for a, b in zip(outs[name], outs[ref])]
        ok = all(torch.allclose(a, b, atol=TOL_MODEL, rtol=TOL_MODEL)
                 and bool(torch.isfinite(a).all())
                 for a, b in zip(outs[name], outs[ref]))
        log(f"model check {cfg.name} [{where[name]} vs {where[ref]}]: "
            f"first-token logits {errs[0]:.3e}, decode logits "
            f"{errs[1]:.3e}, node losses {errs[2]:.3e} "
            f"(atol=rtol={TOL_MODEL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"model check failed for {cfg.name}'s "
                             f"{name} path")
    shapes = [tuple(o.shape) for o in outs["kernel"]]
    want = [(2, cfg.vocab), (2, cfg.vocab), (2, cfg.n_ramps + 1)]
    if shapes != want:
        raise SystemExit(f"model check shapes {shapes} != {want}")


def phase_flash_model_check(params, params_cpu, cfg):
    """Full-width whole-prompt prefill into ring caches: through the
    flash kernel, through the einsum path on the card and on the CPU
    (without ``params_cpu``: flash against einsum on the card).  The
    prompt (40 tokens) outruns the 32-slot ring, so the caches keep its
    tail."""
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 40))
    cache_len = 32
    outs = {}
    n0 = flash_attention.launches
    paths = [("flash", params, DEV, True), ("einsum", params, DEV, False)]
    if params_cpu is not None:
        paths.append(("cpu", params_cpu, torch.device("cpu"), False))
    for name, prm, dev, flash in paths:
        with torch.no_grad():
            logits, caches, losses, _ = M.prefill(
                prm, cfg, {"tokens": torch.as_tensor(toks, device=dev)},
                cache_len, use_flash=flash)
        outs[name] = (logits.float().cpu(), losses.cpu(),
                      [{k: t.cpu() for k, t in c["attn"].items()}
                       for c in caches])
    n_layers = sum(seg.n_layers for seg in cfg.segments)
    if flash_attention.launches - n0 != n_layers:
        raise SystemExit(f"flash prefill launched the kernel "
                         f"{flash_attention.launches - n0} times, not "
                         f"{n_layers}")
    pairs = ((("flash", "einsum"), ("flash", "cpu"), ("einsum", "cpu"))
             if "cpu" in outs else (("flash", "einsum"),))
    for a, b in pairs:
        (la, na, ca), (lb, nb, cb) = outs[a], outs[b]
        ok = all(torch.allclose(x, y, atol=TOL_MODEL, rtol=TOL_MODEL)
                 and bool(torch.isfinite(x).all())
                 for x, y in ((la, lb), (na, nb)))
        ok &= all(torch.equal(x["pos"], y["pos"]) for x, y in zip(ca, cb))
        kv_err = max(float((x[n].float() - y[n].float()).abs().max())
                     for x, y in zip(ca, cb) for n in ("k", "v"))
        ok &= all(torch.allclose(x[n].float(), y[n].float(),
                                 atol=TOL_BF16, rtol=TOL_BF16)
                  for x, y in zip(ca, cb) for n in ("k", "v"))
        log(f"model check {cfg.name} [prefill, {a} vs {b}]: logits "
            f"{float((la - lb).abs().max()):.3e}, node losses "
            f"{float((na - nb).abs().max()):.3e} (atol=rtol={TOL_MODEL}); "
            f"ring pos equal; ring k/v {kv_err:.3e} (atol=rtol={TOL_BF16})"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"flash model check failed: {a} vs {b}")
    shapes = (tuple(outs["flash"][0].shape), tuple(outs["flash"][1].shape))
    if shapes != ((2, cfg.vocab), (2, cfg.n_ramps + 1)):
        raise SystemExit(f"flash model check shapes {shapes}")


def _within_bf16(a, b):
    """bf16 tensors ``a`` within one bf16 ulp of ``b`` beyond the
    atol = rtol = TOL_MODEL of the f32 values they round (a bf16 value
    in [2**e, 2**(e+1)) has an ulp of 2**(e-7))."""
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        b.abs().clamp_min(2.0 ** -126))) - 7)
    return bool(((a - b).abs()
                 <= TOL_MODEL + TOL_MODEL * b.abs() + ulp).all())


def phase_ssm_model_check(params, params_cpu, cfg):
    """Full-width mamba2-130m: two 300-token prompts (two 256-row chunks,
    the second ragged) prefilled through the ssd_chunk kernel, through
    the einsum path on the card and on the CPU; then one decode token
    (a fixed token, not the argmax) from each path's state."""
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 300))
    n_layers = sum(seg.n_layers for seg in cfg.segments)
    outs = {}
    for name, prm, dev, kern in (("kernel", params, DEV, True),
                                 ("einsum", params, DEV, False),
                                 ("cpu", params_cpu, torch.device("cpu"),
                                  False)):
        n0 = ssd_chunk.launches
        with torch.no_grad():
            logits, caches, losses, pos = M.prefill(
                prm, cfg, {"tokens": torch.as_tensor(toks, device=dev)},
                300, use_ssd_kernel=kern)
            # copies: the decode below writes the state in place
            state = [{k: t.to("cpu", copy=True) for k, t in c["ssm"].items()}
                     for c in caches]
            dl, _, dn = M.decode_step(
                prm, cfg, {"tokens": torch.tensor([7, 11], device=dev)},
                caches, pos)
        if ssd_chunk.launches - n0 != (n_layers if kern else 0):
            raise SystemExit(f"the {name} prefill launched ssd_chunk "
                             f"{ssd_chunk.launches - n0} times")
        outs[name] = ([logits.float().cpu(), losses.cpu(), dl.float().cpu(),
                       dn.cpu()], state)
    for a, b in (("kernel", "einsum"), ("kernel", "cpu"), ("einsum", "cpu")):
        (ta, sa), (tb, sb) = outs[a], outs[b]
        errs = [float((x - y).abs().max()) for x, y in zip(ta, tb)]
        ok = all(torch.allclose(x, y, atol=TOL_MODEL, rtol=TOL_MODEL)
                 and bool(torch.isfinite(x).all()) for x, y in zip(ta, tb))
        ssm_err = max(float((x["ssm"] - y["ssm"]).abs().max())
                      for x, y in zip(sa, sb))
        conv_err = max(float((x["conv"].float() - y["conv"].float())
                             .abs().max()) for x, y in zip(sa, sb))
        ok &= all(torch.allclose(x["ssm"], y["ssm"], atol=TOL_MODEL,
                                 rtol=TOL_MODEL)
                  and bool(torch.isfinite(x["ssm"]).all())
                  and _within_bf16(x["conv"], y["conv"])
                  for x, y in zip(sa, sb))
        log(f"model check [mamba2 prefill + decode, {a} vs {b}]: logits "
            f"{errs[0]:.3e}, node losses {errs[1]:.3e}, ssm state "
            f"{ssm_err:.3e} (atol=rtol={TOL_MODEL}); conv state "
            f"{conv_err:.3e} (one bf16 ulp + {TOL_MODEL}); decode logits "
            f"{errs[2]:.3e}, node losses {errs[3]:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"mamba2 model check failed: {a} vs {b}")
    shapes = [tuple(t.shape) for t in outs["kernel"][0]]
    n = cfg.n_ramps + 1
    if shapes != [(2, cfg.vocab), (2, n), (2, cfg.vocab), (2, n)]:
        raise SystemExit(f"mamba2 model check shapes {shapes}")


def phase_dp_check(params, cfg):
    """The serve's own calibration (the launcher's numpy prompts from
    seed 0, k 24, lambda 0.5), its chain solved through the Bellman
    kernel and through the plain backup."""
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab, (serve.CALIB_PROMPTS, serve.CALIB_LEN))
    casc = Cascade.calibrate(params, cfg, tokens, 0.5, k=serve.CALIB_K)
    plain = solve_line(casc.chain, casc.costs, casc.support)
    n0 = bellman_backup.launches
    kern = solve_line(casc.chain, casc.costs, casc.support, use_kernel=True)
    torch.cuda.synchronize()
    if bellman_backup.launches - n0 != 1:
        raise SystemExit("the kernel solve did not launch once a solve")
    ok = torch.equal(kern.stop, plain.stop)
    errs = {}
    for f in ("cont", "phi", "sigma", "value"):
        a, b = getattr(kern, f), getattr(plain, f)
        errs[f] = float((a - b).abs().max())
        ok &= bool(torch.isfinite(a).all()) and torch.allclose(
            a, b, rtol=TOL_DP, atol=0.0)
    log(f"dp check [solve_line kernel vs plain, n={kern.n} K={kern.k}]: "
        f"stop tables {'equal' if torch.equal(kern.stop, plain.stop) else 'DIFFER'}, "
        + ", ".join(f"{f} {e:.3e}" for f, e in errs.items())
        + f" (rtol={TOL_DP}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the line solve through the Bellman kernel "
                         "disagrees with the plain solve")

    def eager(route):
        """Median of 20 synchronized eager solves, host clock: the plain
        solve, the one-launch kernel route, or the route before it (n
        chained single launches, a minimum each, 2 stacks)."""
        times = []
        with_kernel = route != "plain"
        if route == "chained":
            LINE_DP.bellman_solve = bellman_chain
        try:
            for _ in range(21):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solve_line(casc.chain, casc.costs, casc.support,
                           use_kernel=with_kernel)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
        finally:
            LINE_DP.bellman_solve = bellman_solve
        return float(np.median(times[1:]))

    routes = ("plain", "kernel", "chained")
    first = {r: eager(r) for r in routes}
    second = {r: eager(r) for r in reversed(routes)}
    log(f"time solve_line [n={kern.n} K={kern.k}, eager, host clock, "
        f"median of 20, in turns]: use_kernel=True (one launch) "
        f"{first['kernel']:.4f} / {second['kernel']:.4f} ms; the route "
        f"before it ({kern.n} chained single launches) "
        f"{first['chained']:.4f} / {second['chained']:.4f} ms; plain "
        f"{first['plain']:.4f} / {second['plain']:.4f} ms")
    return casc


def node_readouts(params, cfg, tokens):
    """(logits, ell) of every node, the ramps' and the head's, at the
    prompts' last position: what `M.prefill` reduces to node losses."""
    x, positions = M._embed_inputs(params, cfg, {"tokens": tokens})
    out = []
    for si, seg in enumerate(cfg.segments):
        p_seg = params["segments"][si]["blocks"]
        for li in range(seg.n_layers):
            x, _ = blocks.block_forward(M.layer(p_seg, li), x, positions,
                                        seg.block, cfg.norm_eps, False,
                                        False)
        if seg.ramp:
            out.append(M.ramp_readout(params, cfg, x[:, -1, :], segment=si))
    out.append(M.ramp_readout(params, cfg, x[:, -1, :]))
    return out


def phase_decision_check(params, cfg, casc):
    """ramp_exit's path: the exit decision of 8 numpy-seeded lanes at
    each node of full-width paper-ee-100m, through the kernel with
    ``tables.stop[node + 1]`` (the strategy's clamped row at the last
    node) and through RecallIndexStrategy.observe (plain, on the card).
    The kernel's loss is held to lam * ell within TOL_EXIT; a strategy
    at lam 1 fed the kernel's loss must reach the kernel's bin, x index
    and stop exactly.  Launch counters are zeroed just before and read
    just after."""
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab, (B, 32)), device=DEV)
    with torch.no_grad():
        readouts = node_readouts(params, cfg, toks)
        _, _, node_losses, _ = M.prefill(params, cfg, {"tokens": toks}, 40)
    ells = torch.stack([ell for _, ell in readouts], dim=1)
    if not torch.allclose(ells, node_losses, atol=TOL_EXIT, rtol=TOL_EXIT):
        raise SystemExit("decision check: the readouts' ell differ from "
                         "the prefill's node losses")
    tables, support, n = casc.line_tables, casc.support, casc.n_nodes
    strat = RecallIndexStrategy(tables, support, costs=casc.costs,
                                lam=casc.lam)
    fed = RecallIndexStrategy(tables, support, costs=casc.costs, lam=1.0)
    st, st_fed = strat.init(B), fed.init(B)
    s_bin, x_idx = st.s_bin.clone(), st.x_idx.clone()
    active = torch.ones((B,), dtype=torch.bool, device=DEV)
    for kern in KERNELS.values():
        kern.launches = 0
    worst, agree, near, ok = 0.0, 0, 0, True
    for node, (logits, ell) in enumerate(readouts):
        row = tables.stop[min(node + 1, n - 1)]
        loss, bins, nx, stop = ramp_exit(logits, support.edges, row, s_bin,
                                         x_idx, lam=casc.lam)
        st, _ = strat.observe(st, node, ell, active)
        st_fed, cont = fed.observe(st_fed, node, loss, active)
        stop_fed = row[st_fed.s_bin.long(), st_fed.x_idx.long()]
        want = casc.lam * ell.float()
        worst = max(worst, float((loss - want).abs().max()))
        ok &= torch.allclose(loss, want, atol=TOL_EXIT, rtol=TOL_EXIT)
        ok &= (torch.equal(st_fed.s_bin, bins)
               and torch.equal(st_fed.x_idx, nx)
               and torch.equal(stop_fed, stop)
               and (node + 1 == n or torch.equal(cont, ~stop)))
        agree += int(((st.s_bin == bins) & (st.x_idx == nx)).sum())
        near += int((near_edges(loss, support.edges)
                     | near_edges(want, support.edges)).sum())
        s_bin, x_idx = bins, nx
    torch.cuda.synchronize()
    launches = {k: kern.launches for k, kern in KERNELS.items()}
    log(f"decision check [ramp_exit vs RecallIndexStrategy, n={n} "
        f"K={tables.k}, {B} lanes]: loss vs lam * ell max_abs_err "
        f"{worst:.3e} (atol=rtol={TOL_EXIT}); bin, x index, stop equal to "
        f"the strategy fed the kernel's loss at every node; the strategy "
        f"on the model's ell kept the kernel's bin and x index in "
        f"{agree}/{n * B} (lane, node), {near} within 2 ulp of an edge; "
        f"launches {launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("ramp_exit disagrees with RecallIndexStrategy")
    if launches["ramp_exit"] != n or sum(launches.values()) != n:
        raise SystemExit(f"decision check launched {launches}")
    return launches


def phase_calibration_timing(params, cfg, flag):
    """The calibration prefill (the serve's 512 x 64 prompts, at the
    calibration's ring length) with and without the kernel route
    ``flag`` (``use_flash`` or ``use_ssd_kernel``), in turns (plain,
    kernel, kernel, plain), host clock around a synchronized call."""
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (serve.CALIB_PROMPTS, serve.CALIB_LEN)), device=DEV)

    def run(on):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            M.prefill(params, cfg, {"tokens": tokens}, serve.CALIB_LEN + 8,
                      **{flag: on})
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    run(False), run(True)                        # warm up both paths
    times = {False: [run(False)], True: [run(True), run(True)]}
    times[False].append(run(False))
    log(f"time calibration prefill {cfg.name} ({serve.CALIB_PROMPTS} x "
        f"{serve.CALIB_LEN}, full depth, decode caches built): without "
        f"{flag} {times[False][0]:.2f} / {times[False][1]:.2f} ms, with "
        f"{flag} {times[True][0]:.2f} / {times[True][1]:.2f} ms")
    torch.cuda.empty_cache()


# the paged pair's timed cases: (h, hkv, hd, maxp) — the serve's shapes,
# 1024-token contexts, and the serve's histories at qwen3-4b's and
# starcoder2-3b's widths
PAGED_TIMED = {"serve": (H, HKV, HD, MAXP),
               "long-context": (H, HKV, HD, LONG_MAXP),
               "serve-g4-hd128": (G4["h"], G4["hkv"], G4["hd"], MAXP),
               "serve-g12-hd128": (G12["h"], G12["hkv"], G12["hd"], MAXP)}


def long_decode_case():
    return decode_case(6, lens=LONG_LENS, maxp=LONG_MAXP)


def long_prefill_case():
    return prefill_case(7, starts=LONG_STARTS, widths=[C] * B,
                        maxp=LONG_MAXP)


# the timed cases: (kernel, case, inputs, bound); a kernel's first case
# is its main one (the ``kernels`` line's numbers), the others are in
# its ``timed_cases``
TIMED = [("paged_attention", "serve", lambda: decode_case(4, lens=SERVE_LENS),
          decode_bound),
         ("paged_attention", "long-context", long_decode_case, decode_bound),
         ("paged_prefill", "serve",
          lambda: prefill_case(5, starts=SERVE_STARTS, widths=SERVE_WIDTHS),
          prefill_bound),
         ("paged_prefill", "long-context", long_prefill_case, prefill_bound)]
TIMED += [(kern, f"serve-{tag}", lambda mk=mk, seed=seed, g=g, kw=kw:
           mk(seed, **g, **kw), bound)
          for tag, g in (("g4-hd128", G4), ("g12-hd128", G12))
          for kern, mk, seed, kw, bound in (
              ("paged_attention", decode_case, 4, dict(lens=SERVE_LENS),
               decode_bound),
              ("paged_prefill", prefill_case, 5,
               dict(starts=SERVE_STARTS, widths=SERVE_WIDTHS),
               prefill_bound))]
TIMED += [("flash_attention", case, lambda i=i, shape=shape:
           flash_case(10 + i, *shape), flash_bound)
          for i, (case, shape) in enumerate(FLASH_CASES) if case in FLASH_TIMED]
TIMED += [("bellman_backup", "K=24", lambda: bellman_case(24, 24),
           bellman_bound),
          # the serve's own solve: paper-ee-100m's 6 nodes at CALIB_K 24
          ("bellman_backup", "solve n=6 K=24",
           lambda: solve_case(6, 6, serve.CALIB_K), solve_bound,
           (bellman_solve, bellman_solve_plain))]
TIMED += [("ssd_chunk", case, lambda i=i, shape=shape:
           ssd_case(30 + i, *shape), ssd_bound)
          for i, (case, shape) in enumerate(SSD_CASES) if case in SSD_TIMED]
TIMED += [("ramp_exit", case, lambda i=i, shape=shape:
           exit_case(40 + i, *shape), exit_bound)
          for i, (case, shape) in enumerate(EXIT_CASES) if case in EXIT_TIMED]


def phase_timing():
    """Each timed case: the kernel and its plain version by CUDA graph
    replay in turns (plain, kernel, kernel, plain) and as eager calls,
    the bound from the case's inputs and, for flash, the library call.
    Returns {kernel: {case: numbers}}."""
    rows = {}
    for name, case, inputs, bound, *fns in TIMED:
        args, kw = inputs()
        kern, plain = fns[0] if fns else (KERNELS[name], PLAINS[name])

        def run_kern():
            return kern(*args, **kw)

        def run_plain():
            return plain(*args, **kw)

        # the SSD chunk at the calibration shape takes milliseconds (its
        # plain version tens), so fewer calls a graph
        g = dict(calls=4, replays=3) if name == "ssd_chunk" and \
            args[0].shape[0] > 1 else {}
        plain_g = [graph_ms(run_plain, **g)]
        kern_g = [graph_ms(run_kern, **g), graph_ms(run_kern, **g)]
        plain_g.append(graph_ms(run_plain, **g))
        torch.cuda.empty_cache()
        kern_e = time_ms(run_kern, iters=20 if g else 200)
        plain_e = time_ms(run_plain, iters=10 if g else 50, warm=2)
        nbytes, flops = bound(args, kw)
        ops = f"{flops} flops"
        if name == "ssd_chunk":
            # its three products run in 3xTF32 on the tensor cores: three
            # TF32 products a product
            b_ms, b_by = bound_ms(nbytes, 3 * flops, TF32_FLOP_S)
            ops = (f"3 x {flops} flops at {TF32_FLOP_S / 1e12} TFLOP/s; the "
                   f"f32 figure at {F32_FLOP_S / 1e12:.0f} TFLOP/s: "
                   f"{bound_ms(nbytes, flops)[0]:.6f} ms")
        else:
            b_ms, b_by = bound_ms(nbytes, flops)
        lib = None
        if name == "flash_attention":
            # the yardstick: one PyTorch call computing the same function
            # (never called by the port), on (B, H, S, hd) copies made
            # outside the timing, K and V repeated to every query head
            g = args[0].shape[2] // args[1].shape[2]
            qt, kt, vt = (t.repeat_interleave(g if i else 1, dim=2)
                          .transpose(1, 2).contiguous()
                          for i, t in enumerate(args))

            def run_lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=kw["scale"])

            lib = min(graph_ms(run_lib), graph_ms(run_lib))
            lib_err = float((run_lib().transpose(1, 2) - run_plain())
                            .abs().max())
            log(f"time {name} [{case}]: library call "
                f"F.scaled_dot_product_attention(is_causal=True) {lib:.5f} "
                f"ms (device, graph replay; max_abs_err vs plain "
                f"{lib_err:.3e})")
            del qt, kt, vt
        extra = {}
        if kern is bellman_solve:
            # the route it replaces: a launch, a minimum a node, 2 stacks
            def run_chain():
                return bellman_chain(*args)

            extra = dict(chained_ms=min(graph_ms(run_chain),
                                        graph_ms(run_chain)),
                         chained_eager_ms=time_ms(run_chain, iters=50))
            single = rows[name]["K=24"]["ms"]
            log(f"time {name} [{case}]: {args[1].shape[0]} chained single "
                f"launches with their minimums and 2 stacks (the route "
                f"before the one-launch solve) {extra['chained_ms']:.5f} ms "
                f"device, {extra['chained_eager_ms']:.5f} ms eager; "
                f"{args[1].shape[0]} x the single backup's "
                f"{args[1].shape[0] * single:.5f} ms")
        del args
        torch.cuda.empty_cache()
        rows.setdefault(name, {})[case] = dict(
            ms=min(kern_g), plain_ms=min(plain_g), bound_ms=b_ms,
            bound_by=b_by, library_ms=lib, eager_ms=kern_e,
            plain_eager_ms=plain_e, **extra)
        log(f"time {name} [{case}] (device, CUDA graph replay): kernel "
            f"{kern_g[0]:.5f} / {kern_g[1]:.5f} ms, plain {plain_g[0]:.5f} "
            f"/ {plain_g[1]:.5f} ms; eager call (host included): kernel "
            f"{kern_e:.5f} ms, plain {plain_e:.5f} ms; bound {b_ms:.6f} ms "
            f"by {b_by} ({nbytes} bytes, {ops})")
    return rows


def _sim_records(metrics) -> list:
    """Per request: served nodes, token count, virtual TTFT, finish."""
    return [(rid, rec.tokens, rec.n_tokens, rec.ttft, rec.finished)
            for rid, rec in sorted(metrics.records.items())]


def phase_sim_digest():
    """The model-free steppers on the card and on the CPU: the same numpy
    trace bank (ee_like_traces, seed 0, 6 nodes), tables and seeded
    Poisson workload through Server + SimStepper — recall_index, FIFO,
    chunked prefill; then EDF with static batching — and a two-rung
    CascadeSimStepper under skip_recall with the recall policy.  Every
    record (served nodes, token count, virtual TTFT and finish) and the
    cascade's stats must be EQUAL on the two devices, and so must each
    serve's span digest and decision digest (an `Observability` rides
    every serve: the virtual clock makes the whole trace
    deterministic)."""
    rng = np.random.default_rng(0)
    losses, _, flops = traces.ee_like_traces(rng, 3_000, 6)
    casc = Cascade.from_traces(losses[:1_500], 0.4 * flops, k=12, lam=0.6)
    bank = losses[1_500:]
    spec = WorkloadSpec(rate=16.0, duration=2.5, prompt_len=32,
                        max_tokens=(4, 16), seed=0)
    crng = np.random.default_rng(3)
    closses, bounds = traces.cascade_traces(
        crng, 3_000, [(1.0, 2.0, 3.0, 4.0, 5.0, 6.0),
                      (4.0, 6.0, 8.0, 10.0, 12.0, 14.0)],
        head_overthink=0.3)
    ccosts = np.concatenate([np.full(6, 0.5 / 6), np.full(6, 2.0 / 6)])
    ccasc = Cascade.from_traces(closses[:1_500], 0.1 * ccosts, k=10,
                                lam=0.9, boundaries=bounds)
    ccasc.solve_skip("cascade")
    digests, out, spans = {}, {}, {}
    for dev in SIM_DEVICES:
        t0 = time.perf_counter()
        c = arrays_to(casc, dev)
        runs, obs = [], []
        for order, static in (("fifo", False), ("edf", True)):
            reqs = rt.make_workload("poisson", spec)
            strategies, sid_of = rt.build_bank(
                reqs, rt.cascade_factory(c), ("recall_index", None))
            stepper = rt.SimStepper(strategies, bank, n_lanes=8,
                                    seg_time=0.002, overhead=0.0005,
                                    prefill_tok_time=0.0001,
                                    prefill_chunk=C, device=dev)
            obs.append(Observability())
            m = rt.Server(stepper, rt.LaneScheduler(8), sid_of,
                          order=order, slo=0.2, static_batching=static,
                          obs=obs[-1]).serve(reqs)
            if m.summary()["completed"] != len(reqs):
                raise SystemExit(f"sim_digest [{dev}]: {order} serve did "
                                 "not complete")
            runs.append(_sim_records(m))
        mbank = ModelBank([
            ModelSpec("small", 6, n_lanes=8, seg_time=0.002,
                      prefill_tok_time=0.0001),
            ModelSpec("large", 6, n_lanes=4, seg_time=0.008,
                      prefill_tok_time=0.0004)])
        strat = (make_strategy("skip_recall", arrays_to(ccasc, dev),
                               mode="cascade"),)
        reqs = rt.make_workload("poisson", spec)
        stepper = CascadeSimStepper(mbank, strat, closses[1_500:],
                                    overhead=0.0005, policy="recall",
                                    chunk=C, device=dev)
        obs.append(Observability())
        m = rt.Server(stepper, rt.LaneScheduler(8), lambda r: 0,
                      slo=0.2, obs=obs[-1]).serve(reqs)
        cs = stepper.cascade_stats()
        if m.summary()["completed"] != len(reqs) or cs["escalations"] <= 0:
            raise SystemExit(f"sim_digest [{dev}]: cascade sim did not "
                             f"complete or escalate: {cs}")
        runs.append((_sim_records(m), cs))
        out[dev] = runs
        digests[dev] = hashlib.sha256(
            repr(runs).encode()).hexdigest()
        spans[dev] = [(o.tracer.span_digest(), o.tracer.decision_digest(),
                       o.tracer.n_emitted, o.tracer.dropped) for o in obs]
        log(f"sim_digest [{dev}]: {len(runs[0])} + {len(runs[1])} + "
            f"{len(runs[2][0])} requests, cascade escalations "
            f"{cs['escalations']}, de-escalations {cs['deescalations']}, "
            f"tokens by rung {cs['tokens_served']}, sha256 "
            f"{digests[dev]}, span / decision digests (events, dropped) "
            f"{[(a[:16], b[:16], n, d) for a, b, n, d in spans[dev]]}, "
            f"{time.perf_counter() - t0:.1f} s")
    if out[SIM_DEVICES[0]] != out[SIM_DEVICES[1]]:
        raise SystemExit("sim_digest: the records differ between "
                         f"{' and '.join(SIM_DEVICES)}")
    if spans[SIM_DEVICES[0]] != spans[SIM_DEVICES[1]]:
        raise SystemExit("sim_digest: the span or decision digests differ "
                         f"between {' and '.join(SIM_DEVICES)}: {spans}")
    log(f"sim_digest: records equal on {' and '.join(SIM_DEVICES)} "
        f"(sha256 {digests[SIM_DEVICES[0]]}), span digests equal "
        f"({', '.join(d for d, _, _, _ in spans[SIM_DEVICES[0]])}), "
        f"decision digests equal")


def phase_dense_model_checks():
    """Each dense config at full width with its weights only on the card
    (10-16 GB of f32, so no CPU copy): a prefill chunk plus one decode
    token through the paged kernels against the page gather, and a
    whole-prompt prefill through flash against the einsum path, within
    TOL_MODEL.  Each model is freed before the next is built."""
    for arch in DENSE:
        cfg = get_config(arch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = torch.Generator(device=DEV).manual_seed(0)
        params = materialize(M.model_defs(cfg), gen, DEV)
        torch.cuda.synchronize()
        sizes = []
        tree_map(lambda t: sizes.append(t.numel()), params)
        log(f"model {arch}: {sum(sizes)} parameters "
            f"({4 * sum(sizes) / 1e9:.2f} GB in f32), "
            f"{sum(seg.n_layers for seg in cfg.segments)} layers, "
            f"{cfg.n_ramps + 1} nodes, built in "
            f"{time.perf_counter() - t0:.1f} s")
        phase_model_check(params, None, cfg)
        phase_flash_model_check(params, None, cfg)
        del params
        torch.cuda.empty_cache()


def _terminal_records(metrics) -> list:
    """Per request: served nodes, token count, status, virtual TTFT and
    end."""
    return [(rid, rec.tokens, rec.n_tokens, rec.status, rec.ttft,
             rec.ended) for rid, rec in sorted(metrics.records.items())]


def _digest(obj) -> str:
    return hashlib.sha256(repr(obj).encode()).hexdigest()


def phase_control_sim():
    """The adaptive leg of the reference's bench_runtime.
    adaptive_vs_frozen on the port's SimStepper (bench.adaptive:
    the same numpy traces, diurnal workload at peak 12.5 req/s over
    30 s, span 1.5, hold 20, lead 1.5, recalibration every 2.5 s), on
    the card and on the CPU: at least 2 switches and 1 recalibration,
    every request finished, one set of bank storages decided with
    (decide_cache_size() == 1) — the reserved tensors, whose data_ptrs
    every publish kept — and records, switch and publish logs EQUAL on
    the two devices."""
    requests = legs.adaptive_requests()
    rows = legs.adaptive_serve_mix()
    out, attribution = {}, {}
    for dev in SIM_DEVICES:
        t0 = time.perf_counter()
        m, stepper, ctl, _, attribution[dev] = legs.leg(requests, rows,
                                                        device=dev)
        st = ctl.stats()
        done = sum(1 for r in m.records.values() if r.finished is not None)
        reserved = [t for a in ctl.swap.bank_arrays()
                    for t in array_leaves(a)]
        ptrs = [t.data_ptr() for t in reserved]
        ok = (st["gear_switches"] >= 2 and st["recalibrations"] >= 1
              and done == len(requests) and stepper.decide_cache_size() == 1
              and stepper.storages == {tuple(ptrs)}
              and all(t.device.type == torch.device(dev).type
                      for t in reserved))
        out[dev] = (_sim_records(m), ctl.swap.switches, ctl.swap.publishes)
        log(f"control_sim [{dev}]: {done}/{len(requests)} requests "
            f"finished, {st['gear_switches']} gear switches at "
            f"{[round(t, 6) for t, _, _ in ctl.swap.switches]} s, "
            f"{st['recalibrations']} recalibrations ({st['publishes']} "
            f"publishes), final gear {st['gear']}, decide_cache_size "
            f"{stepper.decide_cache_size()}, {len(ptrs)} reserved tensors "
            f"on {reserved[0].device} kept their data_ptrs, mean served "
            f"loss {stepper.mean_served_loss:.6f}, sha256 "
            f"{_digest(out[dev])}, {time.perf_counter() - t0:.1f} s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"control_sim [{dev}] failed: {st}")
    if out[SIM_DEVICES[0]] != out[SIM_DEVICES[1]]:
        raise SystemExit("control_sim: records or switch/publish logs "
                         f"differ between {' and '.join(SIM_DEVICES)}")
    if attribution[SIM_DEVICES[0]] != attribution[SIM_DEVICES[1]]:
        raise SystemExit("control_sim: the decision attribution differs "
                         f"between {' and '.join(SIM_DEVICES)}")
    log(f"control_sim: records, switch/publish logs and the decision "
        f"attribution ({len(attribution[SIM_DEVICES[0]])} rows, sha256 "
        f"{_digest(attribution[SIM_DEVICES[0]])}) equal on "
        f"{' and '.join(SIM_DEVICES)}")


def phase_chaos_sim():
    """A seeded FaultPlan — cancellations, deadlines, a rung-1 stall and
    a page squeeze — on the two-rung CascadeSimStepper of
    phase_sim_digest with a rung-0 KVPool and the DegradeGovernor, on
    the card and on the CPU: requests reaped and completed, escalations
    denied, the pool drained, and records, statuses and governor.stats()
    EQUAL on the two devices."""
    crng = np.random.default_rng(3)
    closses, bounds = traces.cascade_traces(
        crng, 3_000, [(1.0, 2.0, 3.0, 4.0, 5.0, 6.0),
                      (4.0, 6.0, 8.0, 10.0, 12.0, 14.0)],
        head_overthink=0.3)
    ccosts = np.concatenate([np.full(6, 0.5 / 6), np.full(6, 2.0 / 6)])
    ccasc = Cascade.from_traces(closses[:1_500], 0.1 * ccosts, k=10,
                                lam=0.9, boundaries=bounds)
    ccasc.solve_skip("cascade")
    spec = WorkloadSpec(rate=16.0, duration=2.5, prompt_len=32,
                        max_tokens=(4, 16), seed=0)
    out = {}
    for dev in SIM_DEVICES:
        t0 = time.perf_counter()
        reqs = rt.make_workload("poisson", spec)
        plan = FaultPlan.generate(reqs, seed=13, cancel_rate=0.25,
                                  cancel_after=(0.05, 0.5),
                                  deadline=(0.3, 1.5),
                                  stalls=[(1, 0.3, 0.8)],
                                  squeezes=[(0.5, 1.2, 8)])
        reqs = plan.stamp(reqs)
        mbank = ModelBank([
            ModelSpec("small", 6, n_lanes=8, seg_time=0.002,
                      prefill_tok_time=0.0001),
            ModelSpec("large", 6, n_lanes=4, seg_time=0.008,
                      prefill_tok_time=0.0004)])
        pool = KVPool(n_lanes=8, page_size=PS, lane_pages=4, n_pages=33)
        gov = DegradeGovernor()
        strat = (make_strategy("skip_recall", arrays_to(ccasc, dev),
                               mode="cascade"),)
        stepper = CascadeSimStepper(mbank, strat, closses[1_500:],
                                    overhead=0.0005, policy="recall",
                                    chunk=C, pool=pool, faults=plan,
                                    governor=gov, device=dev)
        m = rt.Server(stepper, rt.LaneScheduler(8), lambda r: 0, slo=0.2,
                      enforce_deadlines=True).serve(reqs)
        s = m.summary()
        cs = stepper.cascade_stats()
        ok = (s["cancelled"] > 0 and s["timed_out"] > 0
              and s["completed"] > 0 and gov.denied_stall > 0
              and s["cancelled"] + s["timed_out"] + s["completed"]
              == s["requests"])
        drained = _pool_drained(f"chaos_sim [{dev}]", pool)
        out[dev] = (_terminal_records(m), gov.stats(), cs)
        log(f"chaos_sim [{dev}]: {s['requests']} requests: "
            f"{s['completed']} completed, {s['cancelled']} cancelled, "
            f"{s['timed_out']} timed out; governor {gov.stats()}; "
            f"escalations {cs['escalations']}, tokens by rung "
            f"{cs['tokens_served']}; {drained}; sha256 "
            f"{_digest(out[dev])}, {time.perf_counter() - t0:.1f} s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chaos_sim [{dev}]: the storm did not land: "
                             f"{s}, {gov.stats()}")
    if out[SIM_DEVICES[0]] != out[SIM_DEVICES[1]]:
        raise SystemExit("chaos_sim: records, statuses or governor stats "
                         f"differ between {' and '.join(SIM_DEVICES)}")
    log(f"chaos_sim: records, statuses and governor stats equal on "
        f"{' and '.join(SIM_DEVICES)}")


def _check_serve_run(name, argv, run, n_nodes, vocab, eos=None,
                     reaped=False):
    """Every request (or batch row) got its full token count — or, with
    ``eos``, ended on that token, or, with ``reaped``, was cancelled or
    timed out; tokens and served nodes are in range.  Returns a summary
    string."""
    if run is None:
        raise SystemExit(f"serve [{name}]: the workload was empty")
    if isinstance(run, serve.BatchRun):
        st = run.stats
        args = serve.parse_args(argv)
        b, t = args.batch, args.tokens
        if st.tokens.shape != (b, t) or st.served_nodes.shape != (b, t):
            raise SystemExit(f"serve [{name}]: generated "
                             f"{st.tokens.shape}, not {(b, t)}")
        if not ((st.tokens >= 0) & (st.tokens < vocab)).all():
            raise SystemExit(f"serve [{name}]: token out of range")
        if not ((st.served_nodes >= 0) & (st.served_nodes < n_nodes)).all():
            raise SystemExit(f"serve [{name}]: served node out of range")
        hist = np.bincount(st.served_nodes.ravel(), minlength=n_nodes)
        return (f"{b}x{t} tokens, served-node histogram {hist.tolist()}, "
                f"segments run {st.segments_run_batch}/"
                f"{st.segments_full // b} batch launches")
    for req in run.requests:
        rec = run.metrics.records[req.rid]
        if reaped and rec.status in ("cancelled", "timed_out"):
            continue
        ended = eos is not None and rec.n_tokens and rec.tokens[-1] == eos
        if rec.finished is None or not (rec.n_tokens == req.max_tokens
                                        or ended):
            raise SystemExit(f"serve [{name}]: request {req.rid} got "
                             f"{rec.n_tokens}/{req.max_tokens} tokens")
        if not all(0 <= tk < vocab for tk in rec.tokens):
            raise SystemExit(f"serve [{name}]: token out of range")
    s = run.metrics.summary(slo=1.0)
    nodes = run.metrics.served_nodes
    if not set(nodes) <= set(range(n_nodes)) \
            or sum(nodes.values()) != s["tokens"]:
        raise SystemExit(f"serve [{name}]: served nodes {dict(nodes)}")
    if s["cancelled"] or s["timed_out"]:
        p50 = s["deadline_slack"]["p50"] if s["deadline_slack"] else None
        return (f"{s['completed']}/{s['requests']} requests completed, "
                f"{s['cancelled']} cancelled, {s['timed_out']} timed out "
                f"(deadline slack p50 "
                f"{'n/a' if p50 is None else f'{1e3 * p50:.1f} ms'}), "
                f"{s['tokens']} tokens, TTFT p50 "
                f"{1e3 * s['ttft']['p50']:.1f} ms, token latency p50 "
                f"{1e3 * s['token_latency']['p50']:.2f} ms")
    return (f"{s['completed']}/{s['requests']} requests, {s['tokens']} "
            f"tokens, {s['throughput_tok_s']:.1f} tok/s, TTFT p50 "
            f"{1e3 * s['ttft']['p50']:.1f} ms p99 "
            f"{1e3 * s['ttft']['p99']:.1f} ms, token latency p50 "
            f"{1e3 * s['token_latency']['p50']:.2f} ms, mean served node "
            f"{s['mean_served_node']:.2f}, served-node histogram "
            f"{[nodes[i] for i in range(n_nodes)]}")


def _cascade_check(name, run, commit):
    """A cascade serve escalated and caught up on rung 1 (and, under
    commit, committed); returns its summary."""
    cs = run.cascade_stats
    if cs["escalations"] <= 0 or cs["catchup_tokens"][1] <= 0:
        raise SystemExit(f"serve [{name}]: the escalation path did not "
                         f"run: {cs}")
    if commit and cs["commits"] <= 0:
        raise SystemExit(f"serve [{name}]: no request committed: {cs}")
    total = max(sum(cs["tokens_served"]), 1)
    shares = ", ".join(f"{m} {n} tokens ({100 * n / total:.1f}%)"
                       for m, n in zip(cs["models"], cs["tokens_served"]))
    return (f"served by rung: {shares}; escalations {cs['escalations']}, "
            f"de-escalations {cs['deescalations']}, commits "
            f"{cs['commits']}, recalls {cs['recalls']}, catch-up tokens "
            f"{cs['catchup_tokens']}, re-pinned tokens "
            f"{cs['repin_tokens']}, probes {cs['probes']}, sync writes "
            f"{cs['sync_writes']}, peak lanes {cs['peak_lanes']}")



def _step_split(events):
    """Server step times read off the tracer's events: a step ends with
    its `counter` event and starts at the counter before it — or, when
    that counter left every lane idle (the server then waits for an
    arrival), at the admission that ends the wait.  A step carried a
    prefill chunk if a `prefill_chunk` event falls inside it.  Returns
    the chunk steps' and the decode-only steps' times in seconds."""
    chunk, decode = [], []
    occ, start, idle, carried = 0, None, True, False
    for ev in events:
        if ev.kind == "admitted":
            occ += 1
            if idle:
                start = ev.t
        elif ev.kind in ("finish", "cancel", "deadline_miss"):
            occ -= ev.lane >= 0
            idle = idle or (occ == 0 and ev.kind != "finish")
        elif ev.kind in ("prefill_chunk", "token"):
            idle = False
            carried = carried or ev.kind == "prefill_chunk"
        elif ev.kind == "counter":
            (chunk if carried else decode).append(ev.t - start)
            start, idle, carried = ev.t, occ == 0, False
    return chunk, decode


def _p50_ms(xs) -> str:
    return f"{1e3 * float(np.median(xs)):.2f} ms" if xs else "n/a"


def phase_serve(name, argv, must, must_not, eos=None, reaped=False):
    """One full-width serve; every kernel's launch counter is zeroed
    just before and read just after.  Every server serve but UNTRACED
    runs under a tracer (``--trace-out``, unless an observability flag
    is given), whose events split its step times into chunk and
    decode-only steps.  Returns the launches and the run."""
    args = serve.parse_args(argv)
    if args.server and name != UNTRACED and not (args.trace_out
                                                 or args.obs_dir):
        OBS_ROOT.mkdir(parents=True, exist_ok=True)
        argv = argv + ["--trace-out", str(OBS_ROOT / f"{name}.json")]
    cfgs = [get_config(a) for a in (args.cascade.split(":")
                                    if args.cascade else [args.arch])]
    n_nodes = sum(c.n_ramps + 1 for c in cfgs)
    # the tracer's clock is a bound method of its server (a reference
    # cycle): collect earlier serves so their models leave the card
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    run = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: kern.launches for k, kern in KERNELS.items()}
    summary = _check_serve_run(name, argv, run, n_nodes, cfgs[0].vocab,
                               eos, reaped)
    if args.cascade:
        summary += "; " + _cascade_check(name, run,
                                         args.escalate_policy == "commit")
    if eos is not None:
        early = sum(1 for r in run.requests
                    if run.metrics.records[r.rid].n_tokens < r.max_tokens)
        if early == 0:
            raise SystemExit(f"serve [{name}]: no stream ended on eos "
                             f"{eos}")
        summary += (f"; {early}/{len(run.requests)} streams ended early "
                    f"on eos {eos}")
    for k in must:
        if launches[k] <= 0:
            raise SystemExit(f"serve [{name}]: {k} never launched on the "
                             "serve path")
    for k in must_not:
        if launches[k] != 0:
            raise SystemExit(f"serve [{name}]: {k} launched "
                             f"{launches[k]} times off its path")
    peak = torch.cuda.max_memory_allocated() / 2**20
    setup = f"calibration {run.calib_s:.2f} s"
    if isinstance(run, serve.ServeRun):
        m = run.metrics
        setup += f", serve loop {m.t_end - m.t_start:.2f} s"
        if run.obs is not None:
            chunk, decode = _step_split(run.obs.tracer.events)
            if len(chunk) + len(decode) != m.steps:
                raise SystemExit(f"serve [{name}]: the tracer shows "
                                 f"{len(chunk) + len(decode)} steps, the "
                                 f"metrics {m.steps}")
            setup += (f", server steps from the tracer: {len(chunk)} with "
                      f"a prefill chunk (p50 {_p50_ms(chunk)}), "
                      f"{len(decode)} without (p50 {_p50_ms(decode)})")
    log(f"serve [{name}]: {summary}, launches {launches}, peak memory "
        f"{peak:.0f} MiB, wall {wall:.1f} s ({setup})")
    return launches, run


def _chrome_device_stats(path: Path, steps: int) -> str:
    """Device busy time, idle share, device ops, host syncs and top
    device ops of a `torch.profiler` Chrome trace: busy is the union of
    its kernels, copies and sets; the window runs from its first event
    to its last."""
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"]
               if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in evs if str(e.get("cat", "")).lower()
           in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise SystemExit(f"profile {path}: the trace holds no device "
                         "event")
    t0 = min(e["ts"] for e in evs)
    t1 = max(e["ts"] + e["dur"] for e in evs)
    busy = _merged_us((e["ts"], e["ts"] + e["dur"]) for e in dev)
    syncs = sum(1 for e in evs if e.get("cat") == "cuda_runtime"
                and e.get("name") in SYNC_OPS)
    by_dev = collections.Counter()
    for e in dev:
        by_dev[e["name"][:60]] += e["dur"] / 1e3
    top = {k: round(v, 3) for k, v in by_dev.most_common(8)}
    return (f"window {(t1 - t0) / 1e3:.3f} ms (the serve, its warmup "
            f"step included), device busy {busy / 1e3:.3f} ms, idle share "
            f"{1 - busy / (t1 - t0):.3f}, {len(dev)} device ops and "
            f"{syncs} host syncs ({len(dev) / max(steps, 1):.0f} and "
            f"{syncs / max(steps, 1):.1f} a step over {steps} steps), top "
            f"device ms {json.dumps(top)}")


def phase_obs_serves(streams) -> dict:
    """OBS_SERVE: the main path under --obs-dir and --regret.  Its
    streams must equal the untraced serve's (``streams``), the paged
    pair must launch, the ledger must report no violation, every
    request's span must run queued -> admitted -> prefill_chunk... ->
    token... -> finish, the token events must count the metrics' tokens
    and the chunk widths the stepper's computed prompt tokens, and the
    six artifacts must parse.  Prints the tracer's stats, the regret
    headline, the loss map's top causes and the tracer's host cost a
    step (the serve's events re-emitted through a fresh tracer with the
    same listeners).  Then PROFILE_SERVE: the same serve for 0.5 s under
    --profile-dir, read back from its Chrome trace."""
    by_path = {}
    name, argv, must, must_not = OBS_SERVE
    by_path[name], run = phase_serve(name, argv, must, must_not)
    tr, ledger, meter = run.obs.tracer, run.obs.ledger, run.obs.regret
    bad = [rid for rid, rec in run.metrics.records.items()
           if rec.tokens != streams.get(rid)]
    if bad or set(streams) != set(run.metrics.records):
        raise SystemExit(f"obs [{name}]: streams differ from the untraced "
                         f"serve's for requests {bad}")
    rep = ledger.report()
    if rep["total_violations"] or tr.dropped:
        raise SystemExit(f"obs [{name}]: ledger violations "
                         f"{rep['violations']}, ring dropped {tr.dropped}")
    code = {"queued": "Q", "page_blocked": "B", "admitted": "A",
            "prefill_chunk": "C", "token": "T", "finish": "F"}
    for req in run.requests:
        kinds = "".join(code.get(ev.kind, "?")
                        for ev in tr.request_span(req.rid))
        if not re.fullmatch("QB*AC+T+F", kinds):
            raise SystemExit(f"obs [{name}]: request {req.rid}'s span "
                             f"runs {kinds}")
    s = run.metrics.summary()
    n_tok = sum(1 for ev in tr.events if ev.kind == "token")
    width = sum(dict(ev.data)["width"] for ev in tr.events
                if ev.kind == "prefill_chunk")
    computed = run.stepper.chunk_stats["tokens_computed"]
    if n_tok != s["tokens"] or width != computed:
        raise SystemExit(f"obs [{name}]: {n_tok} token events for "
                         f"{s['tokens']} tokens, chunk widths {width} for "
                         f"{computed} computed prompt tokens")
    out_dir = OBS_ROOT / name
    sizes = {}
    for f in OBS_FILES:
        with open(out_dir / f) as fh:
            json.load(fh)
        sizes[f] = (out_dir / f).stat().st_size
    reg = meter.report()
    lm = goodput_lossmap(tr.events, slo=serve.parse_args(argv).slo_ms / 1e3)
    causes = {c: round(v, 3) for c, v in sorted(
        lm["loss_tok_s"].items(), key=lambda kv: -kv[1])[:3]}
    # the tracer's host cost: the serve's events once more through a
    # fresh tracer with the ledger (auditing the serve's pool), flight
    # recorder and regret meter bound, as the serve had them
    fresh = SpanTracer()
    InvariantLedger().bind(fresh, pool=run.stepper.pool)
    FlightRecorder().bind(fresh)
    RegretMeter(run.cascade).bind(fresh)
    events = list(tr.events)
    steps = sum(1 for ev in events if ev.kind == "counter")
    t0 = time.perf_counter()
    for ev in events:
        fresh.emit(ev.kind, t=ev.t, rid=ev.rid, lane=ev.lane,
                   model=ev.model, **dict(ev.data))
    cost = time.perf_counter() - t0
    log(f"obs [{name}]: streams equal the untraced {UNTRACED} serve's; "
        f"every span queued -> admitted -> prefill_chunk... -> token... "
        f"-> finish; {n_tok} token events = {s['tokens']} tokens; chunk "
        f"widths {width} = {computed} computed prompt tokens; tracer "
        f"{json.dumps(tr.stats())}; ledger {len(rep['contracts'])} "
        f"contracts, {sum(c['checks'] for c in rep['contracts'].values())} "
        f"checks, 0 violations; regret ({reg['mode']}) mean "
        f"{reg['regret_mean']:.6f} p99 {reg['regret_p99']:.6f} over "
        f"{reg['requests']} requests; lossmap goodput "
        f"{lm['goodput_tok_s']:.1f} of {lm['ceiling_tok_s']:.1f} tok/s, "
        f"top causes {json.dumps(causes)}; files {json.dumps(sizes)}; "
        f"tracer host cost {1e3 * cost:.3f} ms for {len(events)} events "
        f"({1e6 * cost / max(steps, 1):.1f} us a step over {steps} "
        f"steps, {1e6 * cost / max(len(events), 1):.2f} us an event)")
    del run
    name, argv, must, must_not = PROFILE_SERVE
    by_path[name], run = phase_serve(name, argv, must, must_not)
    steps = sum(1 for ev in run.obs.tracer.events if ev.kind == "counter")
    path = Path(serve.parse_args(argv).profile_dir) / PROFILE_TRACE
    log(f"profile [{name}]: {path} ({path.stat().st_size} bytes): "
        + _chrome_device_stats(path, steps))
    del run
    return by_path


def phase_serves() -> dict:
    """Every serve of SERVES and CASCADE_SERVES, then EDF_EOS; returns
    each serve's launch counts."""
    by_path, streams = {}, {}
    for name, argv, must, must_not in SERVES + CASCADE_SERVES:
        by_path[name], run = phase_serve(name, argv, must, must_not)
        if name == UNTRACED:
            streams = {rid: rec.tokens
                       for rid, rec in run.metrics.records.items()}
        del run
        if name == UNTRACED:
            by_path.update(phase_obs_serves(streams))
    # the EDF serve's eos: the token the recall_index serve emits most
    # often before a stream's last token, so some stream must end early
    counts = collections.Counter(t for toks in streams.values()
                                 for t in toks[:-1])
    eos = counts.most_common(1)[0][0]
    name, argv, must, must_not = EDF_EOS
    by_path[name], run = phase_serve(name, argv + ["--eos", str(eos)], must,
                                     must_not, eos=eos)
    # same requests, and a stream depends on its own request alone: each
    # EDF stream is the recall_index stream cut after its first eos
    for rid, rec in run.metrics.records.items():
        full = streams[rid]
        cut = full[:full.index(eos) + 1] if eos in full else full
        if rec.tokens != cut:
            raise SystemExit(f"serve [{name}]: request {rid} emitted "
                             f"{rec.tokens}, not {cut}")
    log(f"serve [{name}]: every stream is the recall_index serve's, cut "
        f"after its first eos {eos}")
    by_path.update(phase_dense_serves())
    return by_path


def _pool_drained(name, pool) -> str:
    """Every page back in the free list once the prefix cache lets go:
    no lane holds a page or a reserved budget."""
    held, budget = int(pool.n_held.sum()), int(pool.budget.sum())
    cached = len(pool.prefix)
    pool.prefix.clear()
    bad = pool.check_invariants()
    if held or budget or pool.pages_in_use or bad:
        raise SystemExit(f"serve [{name}]: pages left behind: held {held}, "
                         f"budget {budget}, in use {pool.pages_in_use}, "
                         f"{bad}")
    return (f"pool drained ({cached} prefix-cache entries released, "
            f"{pool.reclaimed_pages} pages reclaimed, peak "
            f"{pool.peak_pages} pages)")


def _merged_us(spans) -> float:
    """Microseconds covered by the union of (start, end) spans."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _profile_steps(name, st, occ, sid, steps, chunk):
    """``steps`` steps of stepper ``st`` under `torch.profiler`, each
    required to carry a prefill chunk (``chunk``) or not.  Returns the
    profiler and the steps' host-clock times."""
    walls = []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            walls.append(_timed_step(name, st, occ, sid, chunk))
        torch.cuda.synchronize()
    return prof, walls


def _timed_step(name, st, occ, sid, chunk) -> float:
    """One step on the host clock; it must carry a chunk iff ``chunk``."""
    n0 = st.chunk_stats["chunk_steps"]
    t0 = time.perf_counter()
    st.step(occ, sid)
    wall = time.perf_counter() - t0
    if (st.chunk_stats["chunk_steps"] > n0) != chunk:
        raise SystemExit(f"profile [{name}]: a timed step "
                         f"{'lacked' if chunk else 'carried'} a prefill "
                         "chunk")
    return wall


def _trace_counts(prof, steps):
    """Device events, device busy ms a step, host syncs (a count over
    the ``steps``) by the ops they sit in (innermost first), device and
    host self ms a step by op."""
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise SystemExit("profile: the trace holds no device event")
    busy_ms = _merged_us((e.time_range.start, e.time_range.end)
                         for e in dev) / 1e3 / steps
    sync_by = collections.Counter()
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name in SYNC_OPS):
            chain, op = [], e.cpu_parent
            while op is not None and len(chain) < 3:
                chain.append(op.name)
                op = op.cpu_parent
            sync_by[" < ".join(chain)] += 1
    by_dev, by_host = collections.Counter(), collections.Counter()
    for e in dev:
        by_dev[e.name[:60]] += e.time_range.elapsed_us() / 1e3 / steps
    for e in prof.key_averages():
        by_host[e.key[:60]] += e.self_cpu_time_total / 1e3 / steps
    return dev, busy_ms, sync_by, by_dev, by_host


def _profile_report(name, label, st, steps, chunk, setup, path):
    """The same measurement twice, without and then with a `SpanTracer`
    on the stepper: ``setup()`` admits fresh prompts of the same lengths
    (so both runs step through the same page and chunk operations) and
    returns ``(occ, sid)``; then ``steps`` steps on the host clock and
    ``steps`` more under `torch.profiler`.  The host syncs of the traced
    steps must equal the untraced ones.  Logs the untraced run's host
    clock, device busy, idle share, device ops, syncs and top ops a
    step, and the traced run's host clock; the untraced Chrome trace
    goes to ``path``."""
    runs = {}
    for traced in (False, True):
        st.tracer = SpanTracer() if traced else None
        occ, sid = setup()
        plain = [_timed_step(name, st, occ, sid, chunk)
                 for _ in range(steps)]
        prof, walls = _profile_steps(name, st, occ, sid, steps, chunk)
        runs[traced] = (plain, prof, walls,
                        st.tracer.n_emitted if traced else 0)
        for lane in range(st.n_lanes):
            st.release(lane)
    st.tracer = None
    plain, prof, walls, _ = runs[False]
    plain_t, prof_t, _, emitted = runs[True]
    dev, busy_ms, sync_by, by_dev, by_host = _trace_counts(prof, steps)
    _, _, sync_t, _, _ = _trace_counts(prof_t, steps)
    if sync_by != sync_t:
        raise SystemExit(f"profile [{name}]: host syncs over {steps} "
                         f"{label} steps moved with a tracer attached: "
                         f"{dict(sync_by)} untraced, {dict(sync_t)} traced")
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    wall_ms = 1e3 * sum(walls) / steps
    plain_ms = 1e3 * sum(plain) / steps
    top = lambda c: {k: round(v, 4) for k, v in c.most_common(8)}  # noqa
    syncs = collections.Counter({k: v / steps for k, v in sync_by.items()})
    log(f"profile [{name}]: {steps} {label} steps, {st.n_lanes} lanes: "
        f"host clock {plain_ms:.3f} ms a step untraced ({wall_ms:.3f} "
        f"under the profiler; {1e3 * sum(plain_t) / steps:.3f} with a "
        f"SpanTracer on the stepper), device busy {busy_ms:.3f} ms, idle "
        f"share {1 - busy_ms / plain_ms:.3f}, "
        f"{len(dev) / steps:.0f} device ops and "
        f"{sum(syncs.values()):.0f} host syncs a step "
        f"({json.dumps(top(syncs))}), the same with the tracer on the "
        f"stepper ({emitted} events); top device ms a step "
        f"{json.dumps(top(by_dev))}; top host self ms a step "
        f"{json.dumps(top(by_host))}; trace {path}")


def phase_decode_profile(name, run, steps=3, chunk=False):
    """`torch.profiler` traces of a served model's steps, driven through
    the serve's own `EngineStepper` after its serve (`_profile_report`:
    each measurement twice, without and with a tracer on the stepper).
    Decode-only: every lane takes a fresh 32-token request, chunk steps
    run until no lane prefills, and two decode-only steps warm up.  With
    ``chunk``, steps that carry a prefill chunk as well: lane 0 takes a
    fresh request and prefills, lanes 1-7 take fresh 32-token requests,
    and one chunk step warms up; the measured steps run lanes 1-7's
    chunks beside lane 0's decode.  Chrome traces go to
    build/decode_profile_<name>.json and build/chunk_profile_<name>.json."""
    st = run.stepper
    n = st.n_lanes
    rng = np.random.default_rng(11)
    sid = np.zeros(n, np.int32)

    def admit(lanes, rid0):
        for lane in lanes:
            req = Request(rid=rid0 + lane, max_tokens=32,
                          prompt=rng.integers(0, st.cfg.vocab, 32, np.int32))
            if not st.reserve(req):
                raise SystemExit(f"profile [{name}]: the pool refused lane "
                                 f"{lane}")
            st.admit(lane, req)

    def until_decoding(occ):
        for _ in range(2 * 32):
            if st.step(occ, sid)[4][occ].all():
                return
        raise SystemExit(f"profile [{name}]: lanes still prefilling")

    def decode_only():
        occ = np.ones(n, bool)
        admit(range(n), 10_000)
        until_decoding(occ)
        for _ in range(2):
            _timed_step(name, st, occ, sid, False)
        return occ, sid

    def with_chunks():
        one = np.zeros(n, bool)
        one[0] = True
        admit([0], 20_000)
        until_decoding(one)
        admit(range(1, n), 20_000)
        occ = np.ones(n, bool)
        _timed_step(name, st, occ, sid, True)
        return occ, sid

    st.tracer = None
    _profile_report(name, "decode-only", st, steps, False, decode_only,
                    ROOT / "build" / f"decode_profile_{name}.json")
    if chunk:
        _profile_report(name, "chunk", st, steps, True, with_chunks,
                        ROOT / "build" / f"chunk_profile_{name}.json")


def phase_dense_serves() -> dict:
    """The dense configs at full width (DENSE_SERVES), then qwen3-4b
    under cancellations and deadlines (QWEN3_FAULTS, the deadline half
    the median e2e latency of qwen3_chunked_recall_index: the host's
    speed moves between serves, and at the whole median a faster serve
    reaped nothing), then the two-rung cascade under a fault plan with
    a rung-1 stall over the first escalations (CASCADE_FAULTS).  Each
    model is freed before the next serve builds its own."""
    by_path = {}
    e2e = []
    for name, argv, must, must_not in DENSE_SERVES:
        by_path[name], run = phase_serve(name, argv, must, must_not)
        if name == "qwen3_chunked_recall_index":
            e2e = [r.e2e for r in run.metrics.records.values()]
        if name in PROFILED:
            phase_decode_profile(name, run, chunk=name == CHUNK_PROFILED)
        if run.controller is not None:
            log(f"serve [{name}]: controller.stats() "
                + json.dumps(run.controller.stats(), default=float))
        del run
        torch.cuda.empty_cache()
    deadline_ms = 0.5e3 * float(np.median(e2e))
    name, argv, must, must_not = QWEN3_FAULTS
    by_path[name], run = phase_serve(
        name, argv + ["--deadline-ms", f"{deadline_ms:.3f}"], must,
        must_not, reaped=True)
    s = run.metrics.summary()
    if s["cancelled"] + s["timed_out"] < 1:
        raise SystemExit(f"serve [{name}]: no request reaped at "
                         f"--deadline-ms {deadline_ms:.3f}")
    log(f"serve [{name}]: --deadline-ms {deadline_ms:.3f} (half the median "
        f"e2e latency of qwen3_chunked_recall_index); "
        + _pool_drained(name, run.stepper.pool))
    del run
    torch.cuda.empty_cache()
    name, argv, must, must_not = CASCADE_FAULTS
    plan = FaultPlan(seed=0, stalls=[(1, 0.0, 1.0)],
                     deadline={rid: 60.0 for rid in range(256)})
    path = ROOT / "build" / "cascade_faults_plan.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    plan.save(str(path))
    by_path[name], run = phase_serve(name, argv + ["--faults", str(path)],
                                     must, must_not)
    cs = run.cascade_stats
    if cs.get("governor_denied_stall", 0) < 1:
        raise SystemExit(f"serve [{name}]: the governor denied no "
                         f"escalation into the stalled rung: {cs}")
    drained = "; ".join(f"{sp.name}: " + _pool_drained(name, st.pool)
                        for sp, st in zip(run.stepper.bank.specs,
                                          run.stepper.steppers))
    log(f"serve [{name}]: governor "
        + json.dumps({k: v for k, v in cs.items()
                      if k.startswith("governor")}) + f"; {drained}")
    del run
    torch.cuda.empty_cache()
    return by_path


def main() -> None:
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)}")
    # f32 matmuls in full f32 (no TF32), as the JAX reference computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    resources = phase_build()
    errs = phase_kernel_checks()
    errs["ramp_exit"] = phase_exit_checks()
    cfg = get_config("paper-ee-100m")
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = materialize(M.model_defs(cfg), gen, DEV)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    phase_model_check(params, params_cpu, cfg)
    phase_flash_model_check(params, params_cpu, cfg)
    casc = phase_dp_check(params, cfg)
    decision = phase_decision_check(params, cfg, casc)
    del casc
    phase_calibration_timing(params, cfg, "use_flash")
    del params, params_cpu
    cfg = get_config("mamba2-130m")
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = materialize(M.model_defs(cfg), gen, DEV)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    phase_ssm_model_check(params, params_cpu, cfg)
    phase_calibration_timing(params, cfg, "use_ssd_kernel")
    del params, params_cpu
    torch.cuda.empty_cache()
    phase_dense_model_checks()
    times = phase_timing()
    floor = launch_floor_ms()
    log(f"launch_floor_ms {floor:.6f} (device, graph replay of an in-place "
        f"add on one element)")
    phase_sim_digest()
    phase_control_sim()
    phase_chaos_sim()
    # each path's own counts; each kernel's main path is MAIN_PATH's
    by_path = {DECISION: decision}
    by_path.update(phase_serves())
    kernels = []
    for name in KERNELS:
        cases = times[name]
        main_case = MAIN_CASE.get(name, next(iter(cases)))
        row = dict(name=name, route="cuda", source=SOURCES[name][0],
                   replaces=SOURCES[name][1],
                   launches=by_path[MAIN_PATH[name]][name],
                   launches_by_path={p: n[name] for p, n in by_path.items()},
                   max_abs_err=errs[name], timed_case=main_case,
                   **cases[main_case], ok=True)
        if len(cases) > 1:
            row["timed_cases"] = cases
        if name in resources:
            row["resources"] = resources[name]
        kernels.append(row)
    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
