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
     8 kv heads, head_dim 128), at starcoder2-3b's (24 heads on 2,
     head_dim 128), at phi-3-vision-4.2b's (32 on 32, head_dim 96) and
     at qwen3-14b's (40 on 8: a group of 5), each with a window shorter
     than the context, and paged decode at hymba-1.5b's (25 on 5,
     head_dim 64, window 1024) over the serve's histories and over
     1025-1300 positions (82-page tables: the window cuts every lane),
     atol = rtol = 1e-4; the
     all-masked lane and the padded prefill rows exactly 0;
     flash_attention at the calibration
     prefill's shape (512, 64, 12, 12, 64), a ring admission's (1, 32,
     12, 12, 64), a GQA case with a window and a ragged length, head_dim
     32 and 96 cases, S in {1, 63, 65, 129} at each head_dim (GQA, a
     window past one tile), and qwen3-4b's, starcoder2-3b's and
     qwen3-14b's calibration prefills ((512, 64, 32, 8, 128), (512, 64,
     24, 2, 128) with its 4096-token window, (512, 64, 40, 8, 128)),
     and hymba-1.5b's calibration, admission and a 2048-token prompt
     past its window ((512 | 1, 64 | 32 | 2048, 25, 5, 64), window
     1024), atol = rtol = 1e-4 (f32 sums in another order); bellman_backup at
     K = 24 and 64 on row-stochastic transitions, atol = rtol = 1e-5,
     and the whole solve in one launch (n = 6 at K = 24, n = 13 at K =
     64) within 1e-5 of its plain
     version and EQUAL to n chained single launches; ssd_chunk at what
     the mamba2-130m
     calibration passes ((512, 1, 256, 24, 64, 128) with 64 valid rows,
     zeros after, q_valid 64), the same shape as a random full chunk, a
     ring admission's (1, 1, 256, ...) with q_valid 32, four chunks (2,
     4, 256, ...) with a ragged last one (q_valid 37), q_valid 1, 200 and
     256, hymba-1.5b's calibration call, admission and a full chunk at
     d_state 16 and 50 heads ((512 | 1 | 2, 1, 256, 50, 64, 16), q_valid
     64 | 32 | none), all with dt and da drawn as the model makes them (softplus,
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
     flash prefill against the einsum path, within 1e-3; then the same
     two checks (each model's input stream: tokens, embeds, or 256
     image embeds before the text in 17 chunks) for qwen3-14b,
     musicgen-large, phi-3-vision-4.2b (the paged pair at head_dim 96)
     and phi3.5-moe-42b-a6.6b cut to one layer in each of its 8
     segments (10.67 B parameters), and for deepseek-v2-lite-16b (MLA)
     a 7-token ring prefill and one absorbed decode token against the
     8-token prefill within 2.5e-2 (the reference's tolerance: the
     decode reads the bf16 latent) and the paged-gather decode against
     the ring decode within 1e-3, with no kernel launched, and its int8
     latent (``cache_int8``): the ring decode against the bf16 latent's
     within the reference's rule (0.05 x max|logit| + 0.05), the paged
     gather against the int8 ring within 1e-3; each model's
     size and peak memory printed; then hymba-1.5b (the hybrid mixer,
     ``phase_hybrid_model_check``): its ``count_params`` (1 589 784 320),
     a 2048-token prefill of two lanes past its 1024-token window through
     flash and ssd_chunk against the einsum paths (logits, node losses,
     SSM state within 1e-3; ring K/V and conv within a bf16 ulp), and
     one paged decode token after 1100 positions through the kernel
     against the page gather (1e-3); ``phase_long_prefill``: one
     16 384-token prompt by the banded query chunks, the chunked ones
     and flash (logits within 1e-3 of the banded route's; each route's
     time and peak memory beside the whole-matrix path's one-layer f32
     scores), then 8 decode tokens on the ring of
     ``cache_len_for(long_500k)`` slots, each within 2.5e-2 of the
     prefill of the prompt so far; ``phase_int8``: qwen3-4b's ring and
     paged-gather decode under ``cache_int8`` against the bf16 cache
     (the reference's rule), no paged kernel launched on the int8 pool
     with the switch on, and the serve pool's bytes in each layout;
  4. times each kernel and its plain version with CUDA events (with
     hymba-1.5b's shapes: flash at its calibration and admission beside
     SDPA, ssd_chunk at its calibration and admission, paged decode at
     the serve's histories and past the window) — device
     time from CUDA graph replay, and the time of an eager call, host
     included — on the chunked serve's shapes, at 1024-token contexts
     and at the serve's histories with qwen3-4b's, starcoder2-3b's,
     phi-3-vision-4.2b's and qwen3-14b's widths (paged pair), the
     calibration prefill's, a ring admission's and the three dense
     configs' calibration shapes
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
     twenty-seven times — paper-ee-100m chunked paged under recall_index and
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
     stalled rung; both pools drained), qwen3-14b chunked paged with
     --flash --dp-kernel under recall_index, the phi3.5-moe cut the same
     way (through the launcher's parse_args and _serve_traffic with the
     script's config), and deepseek-v2-lite-16b stop-the-world on the
     paged pool with --paged-kernel --flash --dp-kernel (only the
     Bellman kernel may launch: MLA takes the page gather and its own
     prefill), hymba-1.5b stop-the-world on the paged pool with
     --paged-kernel --flash --ssd-kernel --dp-kernel
     (``hymba_stw_recall_index``: flash, ssd_chunk, paged_attention and
     Bellman must launch, paged_prefill must not; it also prints
     ``model_flops`` of one decode token), and qwen3-4b's chunked
     recall_index serve without --paged-kernel on the bf16 pool
     (``qwen3_gather_chunked_recall_index``) and inside ``cache_int8``
     (``qwen3_int8_chunked_recall_index``), neither launching a paged
     kernel — with every kernel's launch
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
  7. trains full-width paper-ee-100m (``phase_train``): one f32 step
     (no mixed precision) from the same parameters and 2 x 64 synthetic
     tokens on the card and on the CPU — loss, every CE and the grad
     norm within rtol 1e-4, the parameters after the step within 2 lr +
     1e-6 with at most 0.1% of them more than 1e-6 apart; then 300 steps
     of examples/train_ee.py's run (lr 6e-4, 8 x 256 tokens, bf16 on f32
     master weights, per-layer recomputation) from the launcher's seed-0
     init, printing loss and ce_final first -> last, the step time p50 /
     p90 (CUDA events after 6 steps), tokens/s and peak memory, and
     requiring the last loss below 0.8x the first; saves the checkpoint
     to build/train/, loads it back (every leaf EQUAL) and prints the
     frame the install writes (zstd or ZLB0); runs the model check of
     step 3 on the trained weights; prints the calibration prompts' node
     losses (per-node mean and std) at init and trained, and a held-out
     synthetic batch's; requires ``forward_train(use_flash=True)`` and
     the flash wrapper to refuse autograd on the card; and serves the
     main path at random init once more (``init_chunked_recall_index``)
     and then from the checkpoint (``--ckpt``,
     ``ckpt_chunked_recall_index``; the paged pair must launch in both),
     printing the served-node histogram, token p50 and TTFT p50 of both
     beside the first ``chunked_recall_index`` serve's.  Training steps
     3-5 run under torch.profiler (device busy, idle share against the
     p50 step, device ops, top device and host ops a step) and are left
     out of the step times;
  8. counts work with ``launch.op_cost`` (``phase_op_cost``): full-width
     qwen3-4b's prefill of 1 x 4096 tokens, plain and through the
     flash kernel (its 36 launches counted as kernel records: operand
     and result bytes, no flops), and its decode_step of 8 lanes on a
     4096-slot ring, on the card; the plain counts (flops, HBM bytes)
     must EQUAL those taken on fake tensors of the same shapes, and the
     plain prefill's attention matmuls 36 x 4 S^2 H hd exactly (the
     flash prefill none); each step is timed with CUDA events (median
     of 5) and its TFLOP/s and TB/s printed beside 67 TFLOP/s f32 and
     3.35 TB/s; then the multi-pod dry run (``phase_dryrun``): ``python
     -m repro_torch.launch.dryrun`` on the 256- or 512-rank fake world,
     one process a combination, 8 at a time, none on the card — every
     assigned arch at decode_32k, prefill_32k for qwen3-4b,
     phi3.5-moe-42b-a6.6b and hymba-1.5b, long_500k for mamba2-130m,
     hymba-1.5b and qwen3-4b, qwen3-4b decode_32k on pod2x16x16 and
     qwen3-14b decode_32k with ``--variant gqa_mesh`` (train_4k is left
     out: its DTensor trace takes minutes a combination), each
     process's exit 0 required and its per-device numbers printed;
  9. prints a ``kernels`` JSON line (``launches`` is each kernel's
     count on its own main path — for ramp_exit the decision check;
     ``launches_by_path`` holds every path's; the times are the first
     timed case's — for bellman_backup the solve's, the case its path
     runs — ``timed_cases`` holds every case of a kernel timed at more
     than one, ``resources`` what the runtime reported; the object also
     carries ``launch_floor_ms``, the training run's numbers,
     ``train``, and ``op_cost``'s), the card line, and last ``{"ok":
     true, "device": {...}}``.

It exits nonzero, printing no result, when CUDA is not available, when
the repository's sources are not beside it, or when any check fails.
"""

from __future__ import annotations

import collections
import dataclasses
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
from repro_torch.data.pipeline import (DataConfig,            # noqa: E402
                                       SyntheticLM, batches)
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
from repro_torch.launch import op_cost, serve                 # noqa: E402
from repro_torch.launch.flops import model_flops              # noqa: E402
from repro_torch.launch.shapes import SHAPES, cache_len_for   # noqa: E402
from repro_torch.models import attention as A                 # noqa: E402
from repro_torch.models import blocks                         # noqa: E402
from repro_torch.models import model as M                     # noqa: E402
from repro_torch.models import moe as MOE                     # noqa: E402
from repro_torch.models.common import rms_norm                # noqa: E402
from repro_torch.models.param import (count_params,           # noqa: E402
                                      materialize, tree_leaves, tree_map)
from repro_torch.models.quant import cache_int8               # noqa: E402
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
from repro_torch.training import checkpoint                   # noqa: E402
from repro_torch.training.loop import make_train_step         # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,      # noqa: E402
                                            cosine_schedule,
                                            init_opt_state)

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
HYMBA = "hymba-1.5b"
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
# the other families served at full width (FAMILY_ARCHS' token-input
# configs): qwen3-14b and the phi3.5-moe cut chunked paged through the
# paged pair, flash and Bellman; deepseek-v2-lite stop-the-world on the
# paged pool, where MLA takes the page gather and its own prefill (the
# reference's route), so the kernel flags launch Bellman alone.  Each:
# (name, argv, kernels that must launch, that must not, cut config)
FAMILY_SERVES = [
    ("qwen3_14b_chunked_recall_index",
     ["--arch", "qwen3-14b"] + DENSE_PAGED + [
         "--flash", "--dp-kernel", "--policy", "recall_index"],
     PAGED + NEW, ("ssd_chunk",) + EXIT, False),
    ("phi35moe_cut_chunked_recall_index",
     ["--arch", "phi3.5-moe-42b-a6.6b"] + DENSE_PAGED + [
         "--flash", "--dp-kernel", "--policy", "recall_index"],
     PAGED + NEW, ("ssd_chunk",) + EXIT, True),
    ("deepseek_stw_recall_index",
     ["--arch", "deepseek-v2-lite-16b"] + LOAD + [
         "--server", "--kv", "paged", "--page-size", str(PS),
         "--paged-kernel", "--flash", "--dp-kernel", "--policy",
         "recall_index"],
     ("bellman_backup",), ATTN + ("ssd_chunk",) + EXIT, False),
    # hymba-1.5b: stop-the-world on the paged pool (the hybrid mixer has
    # no prefill chunk), calibrated and admitted through flash and
    # ssd_chunk, decoded through paged_attention, solved by Bellman
    ("hymba_stw_recall_index",
     ["--arch", HYMBA] + LOAD + [
         "--server", "--kv", "paged", "--page-size", str(PS),
         "--paged-kernel", "--flash", "--ssd-kernel", "--dp-kernel",
         "--policy", "recall_index"],
     ("flash_attention", "ssd_chunk", "paged_attention", "bellman_backup"),
     ("paged_prefill",) + EXIT, False)]
# qwen3-4b's chunked recall_index serve without --paged-kernel on the
# bf16 pool (the page gather), then the same inside `cache_int8` (an int8
# pool takes the page gather, so the flag would ask for kernels that
# cannot run): the int8 cache beside the bf16 one on the same route
GATHER_ARGV = [a for a in DENSE_RECALL["qwen3-4b"] if a != "--paged-kernel"]
INT8_SERVES = [("qwen3_gather_chunked_recall_index", GATHER_ARGV, NEW,
                PAGED + ("ssd_chunk",) + EXIT, False),
               ("qwen3_int8_chunked_recall_index", GATHER_ARGV, NEW,
                PAGED + ("ssd_chunk",) + EXIT, True)]
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
# and at the new families' serve widths: phi-3-vision-4.2b's (32 heads
# on 32, head_dim 96: the hd 96 instance) and qwen3-14b's (40 heads on
# 8, head_dim 128: a GQA group of 5)
G1H96 = dict(h=32, hkv=32, hd=96)
G5 = dict(h=40, hkv=8, hd=128)
# hymba-1.5b's attention: 25 heads on 5 kv heads of 64 (a group of 5)
# under its 1024-token window; the long cases' histories of 1025-1300
# positions outrun the window on every lane (82-page tables)
G5H64 = dict(h=25, hkv=5, hd=64)
HYMBA_WINDOW = 1024
HYMBA_MAXP = 82
HYMBA_LENS = [1100, 1300, 1025, 1201, 1150, 1111, 1279, 1064]


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
    ("starcoder2-3b-calibration", (512, 64, 24, 2, 128, 4096)),
    # qwen3-14b's calibration prefill: a GQA group of 5 at head_dim 128
    ("qwen3-14b-calibration", (512, 64, 40, 8, 128, None)),
    # hymba-1.5b's: its calibration prefill and a stop-the-world
    # admission (inside its 1024-token window), and a 2048-token prompt
    # past the window
    ("hymba-calibration", (512, 64, 25, 5, 64, HYMBA_WINDOW)),
    ("hymba-admission", (1, 32, 25, 5, 64, HYMBA_WINDOW)),
    ("hymba-past-window", (1, 2048, 25, 5, 64, HYMBA_WINDOW))]
# timed beside SDPA(is_causal=True): each prompt fits its window, so
# that call computes the same function
FLASH_TIMED = ("calibration", "ring-admission", "qwen3-4b-calibration",
               "starcoder2-3b-calibration", "qwen3-14b-calibration",
               "hymba-calibration", "hymba-admission")


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
             ("small-per-head-bc", (2, 3, 32, 4, 32, 16, False, None)),
             # hymba-1.5b's SSD heads: 50 of 64 at d_state 16, its
             # calibration's 64 valid rows of a 256-row chunk, an
             # admission's 32, and a full chunk
             ("hymba-calibration", (512, 1, 256, 50, 64, 16, True, 64)),
             ("hymba-admission", (1, 1, 256, 50, 64, 16, True, 32)),
             ("hymba-full-chunk", (2, 1, 256, 50, 64, 16, True, None))]
SSD_TIMED = ("calibration", "full-chunk", "ring-admission",
             "hymba-calibration", "hymba-admission")


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
                for case, (h, hkv, hd, maxp) in (
                    list(PAGED_TIMED.items())
                    + [("hymba-serve", (25, 5, 64, MAXP)),
                       ("hymba-past-window", (25, 5, 64, HYMBA_MAXP))])}),
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
              prefill_case(51, window=20, **G12), TOL_KERNEL),
             ("paged_attention", "g1-hd96-window",
              decode_case(52, window=40, **G1H96), TOL_KERNEL),
             ("paged_prefill", "g1-hd96-window",
              prefill_case(53, window=20, **G1H96), TOL_KERNEL),
             ("paged_attention", "g5-hd128-window",
              decode_case(54, window=40, **G5), TOL_KERNEL),
             ("paged_prefill", "g5-hd128-window",
              prefill_case(55, window=20, **G5), TOL_KERNEL),
             ("paged_attention", "hymba-serve", hymba_serve_case(),
              TOL_KERNEL),
             ("paged_attention", "hymba-past-window", hymba_long_case(),
              TOL_KERNEL)]
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


def model_batch(cfg, rows, seed, dev):
    """A numpy-seeded batch of two prompts of ``rows`` text positions
    in the model's own input mode: tokens; embeds N(0, 0.5) (an
    embeds-input model); or image embeds N(0, 0.1) of ``image_tokens``
    rows before the tokens (multimodal)."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeds":
        return {"embeds": torch.as_tensor(
            rng.normal(0, 0.5, (2, rows, cfg.d_model)).astype(np.float32),
            device=dev)}
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (2, rows)).astype(np.int32), device=dev)}
    if cfg.input_mode == "multimodal":
        batch["image_embeds"] = torch.as_tensor(
            rng.normal(0, 0.1, (2, cfg.image_tokens, cfg.d_model))
            .astype(np.float32), device=dev)
    return batch


def decode_input(prm, cfg, dev):
    """A fixed decode input (not the argmax, so a near-tie in the
    first-token logits cannot change it): tokens 7 and 11, or for an
    embeds-input model two seeded embeds.  (2, 1, D)."""
    if cfg.input_mode == "embeds":
        return torch.as_tensor(np.random.default_rng(8).normal(
            0, 0.5, (2, 1, cfg.d_model)).astype(np.float32), device=dev)
    return prm["embed"]["table"][torch.tensor([7, 11], device=dev)][:, None]


def phase_model_check(params, params_cpu, cfg):
    """Full-width model on a small input: two lanes' prompts (16 rows,
    the second lane's 11; a multimodal model's 256 image embeds first,
    so 272 and 267 rows) in 16-row prefill chunks against page
    histories, then one decode token, through the kernels and through
    the page gather on the card, and through the gather on the CPU —
    or, with ``params_cpu`` None (the larger configs, whose weights
    stay on the card), the kernels against the gather."""
    rows = C + cfg.image_tokens
    widths = (rows, rows - 5)
    lane_pages = -(-(rows + 1) // PS)
    n_pages = 1 + 2 * lane_pages
    table = np.arange(1, n_pages, dtype=np.int32).reshape(2, lane_pages)
    dec_pos = np.asarray(widths, np.int32)
    outs = {}
    paths = [("kernel", params, DEV, True), ("gather", params, DEV, False)]
    if params_cpu is not None:
        paths.append(("cpu", params_cpu, torch.device("cpu"), False))
    launched = {}
    for name, prm, dev, kern in paths:
        def t(a, dtype=torch.int32, dev=dev):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
        caches = []
        for spec in M.paged_cache_specs(cfg, 2, n_pages, PS):
            caches.append({"attn": {
                k: (torch.full(s, -1, dtype=d, device=dev) if k == "pos"
                    else torch.zeros(s, dtype=d, device=dev))
                for k, (s, d) in spec["attn"].items()}})
        n0 = (paged_attention.launches, paged_prefill.launches)
        with torch.no_grad(), A.paged_kernel(kern):
            x_all, _ = M._embed_inputs(prm, cfg, model_batch(cfg, C, 5, dev))
            # pad rows (position -1) past the prompt, to whole chunks
            x_all = F.pad(x_all, (0, 0, 0, -rows % C))
            for c0 in range(0, rows, C):
                pos = np.full((2, C), -1, np.int32)
                for lane, w in enumerate(widths):
                    live = np.arange(c0, min(c0 + C, w))
                    pos[lane, :len(live)] = live
                dp = np.where(pos >= 0, table[np.arange(2)[:, None],
                                              np.maximum(pos, 0) // PS], 0)
                active = (pos >= 0).any(axis=1)
                chunk = A.PrefillChunk(
                    tok=t(np.zeros((2, C))), pos=t(pos), dest_page=t(dp),
                    dest_slot=t(np.maximum(pos, 0) % PS),
                    start=t([c0, c0]),
                    last_idx=t([max(min(w - c0, C) - 1, 0)
                                for w in widths]),
                    emit=t(active, torch.bool), active=t(active, torch.bool))
                x = x_all[:, c0:c0 + C]
                for si in range(len(cfg.segments)):
                    x, _ = M.prefill_chunk_segment(prm, cfg, si, x,
                                                   caches[si],
                                                   t(table), chunk)
            h = x[torch.arange(2, device=dev), chunk.last_idx.long()]
            first, _ = M.ramp_readout(prm, cfg, h)
            kv = A.PagedKV(page_table=t(table),
                           write_page=t(table[np.arange(2), dec_pos // PS]),
                           write_slot=t(dec_pos % PS))
            x = decode_input(prm, cfg, dev)
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
        launched[name] = (paged_attention.launches - n0[0],
                          paged_prefill.launches - n0[1])
        outs[name] = [first.float().cpu(), logits.float().cpu(),
                      torch.stack(ells, 1).cpu()]
    n_layers = sum(seg.n_layers for seg in cfg.segments)
    n_chunks = -(-rows // C)
    if launched["kernel"] != (n_layers, n_chunks * n_layers) \
            or launched["gather"] != (0, 0):
        raise SystemExit(f"model check {cfg.name}: paged launches "
                         f"{launched}, not one a layer and chunk")
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
        log(f"model check {cfg.name} [{where[name]} vs {where[ref]}, "
            f"{n_chunks} chunk(s) of {rows} rows]: first-token logits "
            f"{errs[0]:.3e}, decode logits {errs[1]:.3e}, node losses "
            f"{errs[2]:.3e} (atol=rtol={TOL_MODEL}) "
            f"{'ok' if ok else 'FAIL'}")
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
    prompt (40 positions; a multimodal model's 256 image embeds first)
    outruns the 32-slot ring, so the caches keep its tail."""
    cache_len = 32
    outs = {}
    n0 = flash_attention.launches
    paths = [("flash", params, DEV, True), ("einsum", params, DEV, False)]
    if params_cpu is not None:
        paths.append(("cpu", params_cpu, torch.device("cpu"), False))
    for name, prm, dev, flash in paths:
        with torch.no_grad():
            logits, caches, losses, _ = M.prefill(
                prm, cfg, model_batch(cfg, 40, 6, dev), cache_len,
                use_flash=flash)
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
            x, _, _ = blocks.block_forward(M.layer(p_seg, li), x,
                                           positions, seg.block,
                                           cfg.norm_eps, False, False)
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
# 1024-token contexts, and the serve's histories at qwen3-4b's,
# starcoder2-3b's, phi-3-vision-4.2b's and qwen3-14b's widths
PAGED_TIMED = {"serve": (H, HKV, HD, MAXP),
               "long-context": (H, HKV, HD, LONG_MAXP),
               "serve-g4-hd128": (G4["h"], G4["hkv"], G4["hd"], MAXP),
               "serve-g12-hd128": (G12["h"], G12["hkv"], G12["hd"], MAXP),
               "serve-g1-hd96": (G1H96["h"], G1H96["hkv"], G1H96["hd"],
                                 MAXP),
               "serve-g5-hd128": (G5["h"], G5["hkv"], G5["hd"], MAXP)}


def long_decode_case():
    return decode_case(6, lens=LONG_LENS, maxp=LONG_MAXP)


def hymba_serve_case():
    """Paged decode at hymba-1.5b's widths and the serve's histories."""
    return decode_case(56, lens=SERVE_LENS, window=HYMBA_WINDOW, **G5H64)


def hymba_long_case():
    """The same past the window: 1025-1300 positions a lane."""
    return decode_case(57, lens=HYMBA_LENS, maxp=HYMBA_MAXP,
                       window=HYMBA_WINDOW, **G5H64)


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
          for tag, g in (("g4-hd128", G4), ("g12-hd128", G12),
                         ("g1-hd96", G1H96), ("g5-hd128", G5))
          for kern, mk, seed, kw, bound in (
              ("paged_attention", decode_case, 4, dict(lens=SERVE_LENS),
               decode_bound),
              ("paged_prefill", prefill_case, 5,
               dict(starts=SERVE_STARTS, widths=SERVE_WIDTHS),
               prefill_bound))]
TIMED += [("paged_attention", "hymba-serve", hymba_serve_case, decode_bound),
          ("paged_attention", "hymba-past-window", hymba_long_case,
           decode_bound)]
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


# the other model families at full width, each built on the card and
# freed before the next: qwen3-14b (untied, GQA 5:1), musicgen-large
# (embeds input, G 1 at hd 64), phi-3-vision-4.2b (multimodal, untied,
# G 1 at hd 96), phi3.5-moe cut to one layer in each of its 8 segments
# (16 experts top-2 at full width, GQA 4:1) and deepseek-v2-lite-16b
# (MLA, 64 routed experts top-6 and 2 shared)
PHI35 = "phi3.5-moe-42b-a6.6b"
FAMILY_ARCHS = ("qwen3-14b", "musicgen-large", "phi-3-vision-4.2b", PHI35,
                "deepseek-v2-lite-16b")
TOL_MLA = 2.5e-2   # decode over the bf16 latent vs the f32 prefill
MLA_S = 7          # prompt of the MLA check: S + 1 = 8 tokens a group


def phi35_cut():
    """phi3.5-moe-42b-a6.6b at full layer width, all 8 segments (so all
    8 nodes) of 1 layer each: 10.67 B parameters (39.7 GiB in f32) of
    the full 41.87 B, which no 80 GB card holds in f32."""
    full = get_config(PHI35)
    return dataclasses.replace(
        full, name=PHI35 + "-cut-8x1",
        segments=tuple(dataclasses.replace(seg, n_layers=1)
                       for seg in full.segments))


def family_config(arch):
    return phi35_cut() if arch == PHI35 else get_config(arch)


def build_model(cfg):
    """Seeded weights on the card (generator seed 0), with the count and
    the build time printed."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = materialize(M.model_defs(cfg), gen, DEV)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"model {cfg.name}: {n} parameters ({4 * n / 1e9:.2f} GB, "
        f"{4 * n / 2**30:.1f} GiB in f32), "
        f"{sum(seg.n_layers for seg in cfg.segments)} layers, "
        f"{cfg.n_ramps + 1} nodes, input {cfg.input_mode}, "
        f"{'tied' if cfg.tie_embeddings else 'untied'}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return params


def _mla_pool(ring: dict, n_pages=3) -> dict:
    """A paged pool holding two lanes' ring caches (ring slot = position,
    ring length PS): lane 0 in page 1, lane 1 in page 2, page 0 the
    garbage sink.  Leaves may be layer-stacked; the lane axis is the
    one before the slots."""
    pool = {}
    for k, leaf in ring.items():
        # pos and an int8 latent's scales have no feature axis
        axis = leaf.dim() - (1 if k == "pos" or k.endswith("_s") else 2) - 1
        shape = list(leaf.shape)
        shape[axis] = n_pages
        new = (torch.full(shape, -1, dtype=leaf.dtype, device=DEV)
               if k == "pos" else torch.zeros(shape, dtype=leaf.dtype,
                                              device=DEV))
        new.narrow(axis, 1, 2).copy_(leaf)
        pool[k] = new
    return pool


def phase_mla_model_check(params, cfg):
    """deepseek-v2-lite's MLA at full width, on a ring prefill of S = 7
    tokens and one absorbed decode token (the reference's
    `test_decode_consistent_with_prefill`), against the prefill of
    S + 1:
      (a) every layer's attention alone, fed the S + 1 prefill's own
          layer inputs: the decode over the ring (bf16 latent) against
          the prefill's last row within TOL_MLA, the reference's
          tolerance (the decode reads the bf16 latent, the prefill
          recomputes in f32); the same decode over the paged pool
          (page-table gather) against the ring decode within TOL_MODEL;
      (b) the whole model: node losses within TOL_MLA, and the logits of
          every lane whose decode token each MoE layer routes to the
          experts the prefill routes its last token to (a latent one
          bf16 ulp off can swap the 6th and 7th of 64 near-equal router
          probabilities at random init, and then the two compute
          different functions); the paged-gather decode against the
          ring decode within TOL_MODEL.
    No kernel launches, with use_flash and the paged-kernel switch on:
    MLA returns before them.  S + 1 = 8 tokens keeps every expert
    within its 8 slots a group (a token's experts are distinct), so no
    capacity drop separates the two prefills."""
    s = MLA_S
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, s + 1)), device=DEV)
    pos = torch.full((2,), s, dtype=torch.int32, device=DEV)

    def paged():
        return A.PagedKV(
            page_table=torch.tensor([[1], [2]], dtype=torch.int32,
                                    device=DEV),
            write_page=torch.tensor([1, 2], dtype=torch.int32, device=DEV),
            write_slot=pos)

    n0 = {k: kern.launches for k, kern in KERNELS.items()}
    worst = {"decode": 0.0, "paged": 0.0, "int8": 0.0}
    with torch.no_grad(), A.paged_kernel(True):
        x, positions = M._embed_inputs(params, cfg, {"tokens": toks})
        for si, seg in enumerate(cfg.segments):
            acfg = seg.block.attn
            for li in range(seg.n_layers):
                p = M.layer(params["segments"][si]["blocks"], li)
                xn = rms_norm(p["norm1"], x, cfg.norm_eps)
                y_full, _ = A.attn_forward(p["attn"], xn, positions, acfg,
                                           cfg.norm_eps, use_flash=True)
                _, kv = A.attn_forward(p["attn"], xn[:, :s],
                                       positions[:, :s], acfg, cfg.norm_eps,
                                       use_flash=True)
                ring = blocks.build_ring_cache(
                    {"attn_kv": kv}, positions[:, :s], PS)["attn"]
                y_pag, _ = A.attn_decode(p["attn"], xn[:, s:], _mla_pool(ring),
                                         pos, acfg, cfg.norm_eps,
                                         paged=paged())
                y_dec, _ = A.attn_decode(p["attn"], xn[:, s:], ring, pos,
                                         acfg, cfg.norm_eps)
                # the same decode over the int8 latent: the reference's
                # rule against the bf16 latent's
                with cache_int8():
                    ring8 = blocks.build_ring_cache(
                        {"attn_kv": kv}, positions[:, :s], PS)["attn"]
                y_dec8, _ = A.attn_decode(p["attn"], xn[:, s:], ring8, pos,
                                          acfg, cfg.norm_eps)
                err8 = float((y_dec8 - y_dec).abs().max())
                bound8 = 0.05 * float(y_dec.abs().max()) + 0.05
                worst["int8"] = max(worst["int8"], err8 / bound8)
                if not (err8 < bound8 and bool(torch.isfinite(y_dec8).all())
                        and ring8["c_kv"].dtype == torch.int8):
                    raise SystemExit(
                        f"MLA int8 latent at segment {si} layer {li}: "
                        f"{err8:.3e} against the bound {bound8:.3e}")
                for key, a, b, tol in (("decode", y_dec[:, 0], y_full[:, s],
                                        TOL_MLA),
                                       ("paged", y_pag, y_dec, TOL_MODEL)):
                    worst[key] = max(worst[key],
                                     float((a - b).abs().max()))
                    if not (torch.allclose(a, b, atol=tol, rtol=tol)
                            and bool(torch.isfinite(a).all())):
                        raise SystemExit(
                            f"MLA model check failed at segment {si} "
                            f"layer {li}: {key} attention "
                            f"{float((a - b).abs().max()):.3e}")
                x = blocks.block_forward(p, x, positions, seg.block,
                                         cfg.norm_eps, True, False)[0]
    n_layers = sum(seg.n_layers for seg in cfg.segments)
    log(f"model check {cfg.name} [MLA attention, {n_layers} layers, the "
        f"{s + 1}-token prefill's layer inputs]: absorbed decode over the "
        f"ring vs the prefill's last row {worst['decode']:.3e} "
        f"(atol=rtol={TOL_MLA}); paged-gather decode vs ring decode "
        f"{worst['paged']:.3e} (atol=rtol={TOL_MODEL}); the decode over "
        f"the int8 latent vs the bf16 latent's at most {worst['int8']:.3f} "
        f"of the reference's bound (0.05 x max|y| + 0.05) ok")

    # (b) the whole model, each MoE layer's routing recorded
    picks = []
    route = MOE.route

    def recording(p, xg, mcfg):
        out = route(p, xg, mcfg)
        picks.append(torch.sort(out[3], dim=-1).values)
        return out

    MOE.route = recording
    try:
        with torch.no_grad(), A.paged_kernel(True):
            full, _, full_nl, _ = M.prefill(params, cfg, {"tokens": toks},
                                            PS, use_flash=True)
            full_picks = [t[:, -1] for t in picks]
            _, ring, _, _ = M.prefill(params, cfg,
                                      {"tokens": toks[:, :-1]}, PS,
                                      use_flash=True)
            pool = [{"attn": _mla_pool(c["attn"])} for c in ring]
            x = params["embed"]["table"][toks[:, -1].long()][:, None]
            ells = []
            for si in range(len(cfg.segments)):
                x, _, ro = M.decode_segment(params, cfg, si, x, pool[si],
                                            pos, paged=paged())
                if ro is not None:
                    ells.append(ro[1])
            paged_logits, ell = M.ramp_readout(params, cfg, x[:, 0, :])
            paged_nl = torch.stack(ells + [ell], 1)
            del picks[:]
            dec, _, dec_nl = M.decode_step(params, cfg,
                                           {"tokens": toks[:, -1]}, ring,
                                           pos)
            dec_picks = [t[0] for t in picks]
            # (c) the int8 latent (models.quant): the same prefill and
            # decode token with the ring and the pool built under
            # cache_int8
            with cache_int8():
                _, ring8, _, _ = M.prefill(params, cfg,
                                           {"tokens": toks[:, :-1]}, PS,
                                           use_flash=True)
            pool8 = [{"attn": _mla_pool(c["attn"])} for c in ring8]
            x = params["embed"]["table"][toks[:, -1].long()][:, None]
            for si in range(len(cfg.segments)):
                x, _, _ = M.decode_segment(params, cfg, si, x, pool8[si],
                                           pos, paged=paged())
            paged8 = M.ramp_readout(params, cfg, x[:, 0, :])[0]
            del picks[:]
            dec8, _, _ = M.decode_step(params, cfg,
                                       {"tokens": toks[:, -1]}, ring8, pos)
            picks8 = [t[0] for t in picks]
    finally:
        MOE.route = route
    if len(dec_picks) != len(full_picks):
        raise SystemExit("MLA model check: MoE layers routed "
                         f"{len(dec_picks)} / {len(full_picks)} times")
    first_flip = [next((i for i, (a, b) in enumerate(zip(dec_picks,
                                                         full_picks))
                        if not torch.equal(a[lane], b[lane])), None)
                  for lane in range(2)]
    same = [lane for lane in range(2) if first_flip[lane] is None]
    checks = [((dec_nl,), (full_nl,), TOL_MLA,
               f"node losses, ring decode vs the {s + 1}-token prefill"),
              ((paged_logits, paged_nl), (dec, dec_nl), TOL_MODEL,
               "paged-gather decode vs ring decode")]
    if same:
        checks.append(((dec[same],), (full[same],), TOL_MLA,
                       f"logits of lanes {same} (their routing equal), "
                       f"ring decode vs the {s + 1}-token prefill"))
    for a, b, tol, what in checks:
        err = max(float((x - y).abs().max()) for x, y in zip(a, b))
        ok = all(torch.allclose(x, y, atol=tol, rtol=tol)
                 and bool(torch.isfinite(x).all()) for x, y in zip(a, b))
        log(f"model check {cfg.name} [MLA, {what}]: {err:.3e} "
            f"(atol=rtol={tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"MLA model check failed: {what}")
    log(f"model check {cfg.name} [MLA]: the decode token's experts vs "
        f"the prefill's last token's, first MoE layer that differs by "
        f"lane (of {len(dec_picks)}): {first_flip}; logits "
        f"{float((dec - full).abs().max()):.3e} over both lanes")
    dtypes = {k: str(t.dtype).removeprefix("torch.")
              for k, t in ring8[0]["attn"].items()}
    if dtypes != {"c_kv": "int8", "k_rope": "int8", "c_kv_s": "bfloat16",
                  "k_rope_s": "bfloat16", "pos": "int32"}:
        raise SystemExit(f"MLA int8 latent layout: {dtypes}")
    flip8 = [next((i for i, (a, b) in enumerate(zip(picks8, dec_picks))
                   if not torch.equal(a[lane], b[lane])), None)
             for lane in range(2)]
    same8 = [lane for lane in range(2) if flip8[lane] is None]
    perr = float((paged8 - dec8).abs().max())
    ok = (torch.allclose(paged8, dec8, atol=TOL_MODEL, rtol=TOL_MODEL)
          and bool(torch.isfinite(dec8).all()))
    msg = (f"model check {cfg.name} [MLA int8 latent {dtypes}]: paged-"
           f"gather int8 decode vs ring int8 decode {perr:.3e} "
           f"(atol=rtol={TOL_MODEL}); the int8 decode token's experts vs "
           f"the bf16 decode's, first MoE layer that differs by lane: "
           f"{flip8}; logits {float((dec8 - dec).abs().max()):.3e} over "
           f"both lanes")
    if same8:
        err = float((dec8[same8] - dec[same8]).abs().max())
        bound = 0.05 * float(dec[same8].abs().max()) + 0.05
        ok &= err < bound
        msg += (f"; lanes {same8} (routing equal) {err:.3e} (the "
                f"reference's rule: < 0.05 x max|logit| + 0.05 = "
                f"{bound:.3e})")
    log(msg + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("MLA int8 latent check failed")
    launched = {k: kern.launches - n0[k] for k, kern in KERNELS.items()}
    if any(launched.values()):
        raise SystemExit(f"the MLA checks launched kernels: {launched}")
    log(f"model check {cfg.name} [MLA]: no kernel launched with "
        f"use_flash and the paged-kernel switch on")


def ring_to_pool(ring: dict, ps: int = PS):
    """A paged pool holding layer-stacked ring caches (L, B, C, ...)
    whose slot t holds position t (C a multiple of ``ps``): lane b's
    pages are 1 + b * C / ps onward, in order; page 0 is the garbage
    sink.  Returns (pool, page table (B, C / ps) i32)."""
    n_l, b, c = ring["pos"].shape
    lp = c // ps
    pool = {}
    for k, leaf in ring.items():
        body = leaf.reshape(n_l, b * lp, ps, *leaf.shape[3:])
        sink = (torch.full_like(body[:, :1], -1) if k == "pos"
                else torch.zeros_like(body[:, :1]))
        pool[k] = torch.cat([sink, body], dim=1)
    table = (1 + torch.arange(b * lp, dtype=torch.int32, device=DEV)) \
        .reshape(b, lp)
    return pool, table


def paged_decode(params, cfg, caches, table, pos, tok, kernel):
    """One decode token of every lane through every segment against the
    paged pools ``caches`` (SSM state per lane), written at ``pos``:
    (logits, node losses)."""
    p = pos.long()
    kv = A.PagedKV(page_table=table,
                   write_page=table[torch.arange(len(p), device=DEV),
                                    p // PS],
                   write_slot=(p % PS).to(torch.int32))
    x = params["embed"]["table"][tok.long()][:, None]
    ells = []
    with torch.no_grad(), A.paged_kernel(kernel):
        for si in range(len(cfg.segments)):
            x, _, ro = M.decode_segment(params, cfg, si, x, caches[si], pos,
                                        paged=kv)
            if ro is not None:
                ells.append(ro[1])
        logits, ell = M.ramp_readout(params, cfg, x[:, 0, :])
    return logits, torch.stack(ells + [ell], 1)


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


HYMBA_PARAMS = 1_589_784_320   # the reference's count_params
HYMBA_FLASH_S = 2048           # the flash check's prompt: past the window
HYMBA_PAGED_S = 1100           # the paged decode's history
LONG_S = 16_384                # the long-prompt routes' prompt


def phase_hybrid_model_check(params, cfg):
    """Full-width hymba-1.5b, weights on the card:
      (a) its parameter count is the reference's (1 589 784 320);
      (b) a 2048-token prompt (past the 1024-token window), two lanes,
          prefilled through the flash and ssd_chunk kernels and through
          the einsum paths, into 1024-slot rings: logits, node losses
          and SSM state within TOL_MODEL, ring positions equal, ring
          K/V and the conv window within one bf16 ulp beyond TOL_MODEL;
      (c) an 1100-token history in the paged pool and one decode token
          through the paged-decode kernel (its window cuts the first 77
          keys) and through the page gather: logits and node losses
          within TOL_MODEL, one launch a layer and none on the gather."""
    n = count_params(M.model_defs(cfg))
    log(f"model {cfg.name}: count_params {n} (the reference's "
        f"{HYMBA_PARAMS}), {4 * n / 1e9:.2f} GB in f32")
    if n != HYMBA_PARAMS:
        raise SystemExit(f"{cfg.name}: {n} parameters, not {HYMBA_PARAMS}")
    n_layers = sum(seg.n_layers for seg in cfg.segments)
    rng = np.random.default_rng(11)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, HYMBA_FLASH_S)),
                           device=DEV)
    outs = {}
    for name, kern in (("kernels", True), ("einsum", False)):
        n0 = (flash_attention.launches, ssd_chunk.launches)
        with torch.no_grad():
            logits, caches, losses, _ = M.prefill(
                params, cfg, {"tokens": toks}, HYMBA_WINDOW, use_flash=kern,
                use_ssd_kernel=kern)
        got = (flash_attention.launches - n0[0], ssd_chunk.launches - n0[1])
        if got != ((n_layers, n_layers) if kern else (0, 0)):
            raise SystemExit(f"hymba {name} prefill launched flash / "
                             f"ssd_chunk {got} times")
        outs[name] = (logits.float(), losses, caches)
        torch.cuda.empty_cache()
    (la, na, ca), (lb, nb, cb) = outs["kernels"], outs["einsum"]
    ok = all(torch.allclose(x, y, atol=TOL_MODEL, rtol=TOL_MODEL)
             and bool(torch.isfinite(x).all()) for x, y in ((la, lb),
                                                            (na, nb)))
    ok &= all(torch.equal(x["attn"]["pos"], y["attn"]["pos"])
              for x, y in zip(ca, cb))
    ok &= all(_within_bf16(x["attn"][k], y["attn"][k])
              for x, y in zip(ca, cb) for k in ("k", "v"))
    ok &= all(torch.allclose(x["ssm"]["ssm"], y["ssm"]["ssm"],
                             atol=TOL_MODEL, rtol=TOL_MODEL)
              and _within_bf16(x["ssm"]["conv"], y["ssm"]["conv"])
              for x, y in zip(ca, cb))
    kv_err = max(float((x["attn"][k].float() - y["attn"][k].float())
                       .abs().max()) for x, y in zip(ca, cb)
                 for k in ("k", "v"))
    ssm_err = max(float((x["ssm"]["ssm"] - y["ssm"]["ssm"]).abs().max())
                  for x, y in zip(ca, cb))
    log(f"model check {cfg.name} [prefill of 2 x {HYMBA_FLASH_S} tokens "
        f"past the {HYMBA_WINDOW}-token window, flash + ssd_chunk vs "
        f"einsum]: logits {float((la - lb).abs().max()):.3e}, node losses "
        f"{float((na - nb).abs().max()):.3e}, ssm state {ssm_err:.3e} "
        f"(atol=rtol={TOL_MODEL}); ring pos equal; ring k/v {kv_err:.3e} "
        f"and conv state within one bf16 ulp + {TOL_MODEL} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("hymba prefill check failed")
    del outs, ca, cb
    torch.cuda.empty_cache()
    # (c) the paged decode past the window
    s = HYMBA_PAGED_S
    ring_len = -(-(s + 1) // PS) * PS
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, s + 1)),
                           device=DEV)
    with torch.no_grad():
        _, caches, _, pos = M.prefill(params, cfg, {"tokens": toks[:, :s]},
                                      ring_len, use_flash=True,
                                      use_ssd_kernel=True)
    pools, table = [], None
    for c in caches:
        pool, table = ring_to_pool(c["attn"])
        pools.append({"attn": pool, "ssm": c["ssm"]})
    del caches
    res = {}
    for name, kern in (("kernel", True), ("gather", False)):
        n0 = paged_attention.launches
        res[name] = paged_decode(params, cfg, _clone(pools), table, pos,
                                 toks[:, s], kern)
        got = paged_attention.launches - n0
        if got != (n_layers if kern else 0):
            raise SystemExit(f"hymba paged decode ({name}) launched the "
                             f"kernel {got} times")
    errs = [float((a - b).abs().max()) for a, b in zip(res["kernel"],
                                                       res["gather"])]
    ok = all(torch.allclose(a, b, atol=TOL_MODEL, rtol=TOL_MODEL)
             and bool(torch.isfinite(a).all())
             for a, b in zip(res["kernel"], res["gather"]))
    log(f"model check {cfg.name} [paged decode after {s} tokens, window "
        f"{HYMBA_WINDOW}, kernel vs page gather]: logits {errs[0]:.3e}, "
        f"node losses {errs[1]:.3e} (atol=rtol={TOL_MODEL}); "
        f"paged_attention launched once a layer ({n_layers}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("hymba paged decode check failed")
    shapes = [tuple(t.shape) for t in res["kernel"]]
    if shapes != [(2, cfg.vocab), (2, cfg.n_ramps + 1)]:
        raise SystemExit(f"hymba decode shapes {shapes}")


def phase_long_prefill(params, cfg):
    """hymba-1.5b, one 16 384-token prompt, by three routes: the banded
    query chunks (the default), the chunked ones (every key for every
    chunk) and flash, the SSD through its kernel in all three: logits
    and node losses within TOL_MODEL of the banded route's, each route's
    time and peak memory printed beside what the old whole-matrix path
    needs for one layer's f32 scores.  Then 8 decode tokens on the
    banded prefill's ring of ``cache_len_for(long_500k)`` slots, each
    within 2.5e-2 of a prefill of the prompt so far (the reference's
    rule), through flash."""
    s = LONG_S
    ring_len = cache_len_for(cfg, SHAPES["long_500k"])
    a = cfg.segments[0].block.attn
    whole = s * s * a.n_heads * 4
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab, (1, s + 8)), device=DEV)
    n_layers = sum(seg.n_layers for seg in cfg.segments)
    calls = collections.Counter()
    inner = A._sdpa_chunked

    def counting(*args):
        calls[A._ATTN_IMPL.get()] += 1
        return inner(*args)

    outs = {}
    A._sdpa_chunked = counting
    try:
        for route, impl, flash in (("banded", "banded", False),
                                   ("chunked", "chunked", False),
                                   ("flash", "banded", True)):
            calls.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            n0 = flash_attention.launches
            t0 = time.perf_counter()
            with torch.no_grad(), A.attention_impl(impl):
                logits, caches, losses, pos = M.prefill(
                    params, cfg, {"tokens": toks[:, :s]}, ring_len,
                    use_flash=flash, use_ssd_kernel=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            fl = flash_attention.launches - n0
            want = ({} if flash else {impl: n_layers}, n_layers if flash
                    else 0)
            if (dict(calls), fl) != want:
                raise SystemExit(f"long prefill [{route}]: chunked calls "
                                 f"{dict(calls)}, flash launches {fl}")
            outs[route] = (logits.float(), losses, peak, wall)
            if route == "banded":
                ring, next_pos = caches, pos
            del caches
            torch.cuda.empty_cache()
    finally:
        A._sdpa_chunked = inner
    lb, nb, _, _ = outs["banded"]
    for route, (lg, nl, peak, wall) in outs.items():
        err = (float((lg - lb).abs().max()), float((nl - nb).abs().max()))
        ok = (torch.allclose(lg, lb, atol=TOL_MODEL, rtol=TOL_MODEL)
              and torch.allclose(nl, nb, atol=TOL_MODEL, rtol=TOL_MODEL)
              and bool(torch.isfinite(lg).all()))
        if route == "banded":
            ok &= peak < whole
        log(f"long prefill {cfg.name} [{route}, 1 x {s} tokens, ring "
            f"{ring_len}]: {wall:.2f} s, peak memory above the weights "
            f"{peak / 2**30:.2f} GiB (the whole-matrix path: "
            f"{whole / 2**30:.2f} GiB of f32 scores a layer); vs banded: "
            f"logits {err[0]:.3e}, node losses {err[1]:.3e} "
            f"(atol=rtol={TOL_MODEL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"long prefill [{route}] failed")
    worst = 0.0
    for i in range(8):
        with torch.no_grad():
            dec, ring, _ = M.decode_step(params, cfg,
                                         {"tokens": toks[:, s + i]}, ring,
                                         next_pos + i)
            ref, _, _, _ = M.prefill(params, cfg,
                                     {"tokens": toks[:, :s + i + 1]},
                                     ring_len, use_flash=True,
                                     use_ssd_kernel=True)
        err = float((dec - ref).abs().max())
        worst = max(worst, err)
        if not (torch.allclose(dec, ref, atol=TOL_MLA, rtol=TOL_MLA)
                and bool(torch.isfinite(dec).all())):
            raise SystemExit(f"long decode token {i}: {err:.3e} from the "
                             f"prefill of {s + i + 1} tokens")
        torch.cuda.empty_cache()
    log(f"long decode {cfg.name} [8 tokens on the {ring_len}-slot ring "
        f"after {s}, full depth]: each vs the prefill of the prompt so far "
        f"(flash) at most {worst:.3e} (atol=rtol={TOL_MLA}, the "
        f"reference's rule) ok")


def phase_hybrid_checks():
    """hymba-1.5b built once on the card for `phase_hybrid_model_check`
    and `phase_long_prefill`, then freed."""
    cfg = get_config(HYMBA)
    params = build_model(cfg)
    phase_hybrid_model_check(params, cfg)
    phase_long_prefill(params, cfg)
    log(f"model {cfg.name}: peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    del params
    torch.cuda.empty_cache()


def _spec_bytes(spec) -> int:
    """Bytes of a (shape, dtype) spec tree (lists and dicts of pairs)."""
    if isinstance(spec, list):
        return sum(_spec_bytes(v) for v in spec)
    if isinstance(spec, dict):
        return sum(_spec_bytes(v) for v in spec.values())
    shape, dtype = spec
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def phase_int8():
    """qwen3-4b at full width with the int8 KV cache (models.quant): a
    24-token ring prefill of two lanes and one decode token under
    `cache_int8` against the bf16 cache (the reference's rule: error <
    0.05 x max |logit| + 0.05), and the same token through the paged
    pool's page gather, int8 (with the paged-kernel switch on: an int8
    pool takes the gather, no kernel launches) against bf16 (switch
    off), and against the int8 ring decode within TOL_MODEL; the pool
    bytes of the serve's layout in each."""
    cfg = get_config("qwen3-4b")
    params = build_model(cfg)
    s, ring_len = 24, 2 * PS
    toks = torch.as_tensor(np.random.default_rng(13).integers(
        0, cfg.vocab, (2, s + 1)), device=DEV)
    res = {}
    for name, on in (("bf16", False), ("int8", True)):
        with torch.no_grad(), cache_int8(on):
            _, caches, _, pos = M.prefill(params, cfg,
                                          {"tokens": toks[:, :s]}, ring_len)
            pools = []
            for c in caches:
                pool, table = ring_to_pool(c["attn"])
                pools.append({"attn": pool})
            n0 = paged_attention.launches
            paged = paged_decode(params, cfg, pools, table, pos, toks[:, s],
                                 kernel=on)
            launched = paged_attention.launches - n0
            ring = M.decode_step(params, cfg, {"tokens": toks[:, s]}, caches,
                                 pos)[0]
        if launched:
            raise SystemExit(f"int8 check: the {name} paged decode "
                             f"launched paged_attention {launched} times")
        res[name] = (ring.float(), paged[0].float(),
                     {k: str(t.dtype).removeprefix("torch.")
                      for k, t in caches[0]["attn"].items()})
    (rb, pb, _), (r8, p8, layout) = res["bf16"], res["int8"]
    worst = 0.0
    for what, got, ref in (("ring decode", r8, rb), ("paged gather", p8, pb)):
        err = float((got - ref).abs().max())
        bound = 0.05 * float(ref.abs().max()) + 0.05
        ok = err < bound and bool(torch.isfinite(got).all())
        worst = max(worst, err)
        log(f"int8 check {cfg.name} [{what}, int8 vs bf16 cache]: {err:.3e} "
            f"(the reference's rule: < 0.05 x max|logit| + 0.05 = "
            f"{bound:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"int8 check failed: {what}")
    perr = float((p8 - r8).abs().max())
    if not torch.allclose(p8, r8, atol=TOL_MODEL, rtol=TOL_MODEL):
        raise SystemExit(f"int8 paged gather vs ring: {perr:.3e}")
    n_pages = B * -(-128 // PS) + 1
    sizes = {}
    for name, on in (("bf16", False), ("int8", True)):
        with cache_int8(on):
            sizes[name] = _spec_bytes(M.paged_cache_specs(cfg, B, n_pages,
                                                          PS))
    log(f"int8 check {cfg.name}: layout {layout}; int8 paged gather vs "
        f"int8 ring decode {perr:.3e} (atol=rtol={TOL_MODEL}); no paged "
        f"kernel launched on the int8 pool with the switch on; the "
        f"serve's pool ({B} lanes, {n_pages} pages of {PS}): bf16 "
        f"{sizes['bf16']} bytes, int8 {sizes['int8']} bytes "
        f"({sizes['int8'] / sizes['bf16']:.3f} of bf16)")
    del params
    torch.cuda.empty_cache()


def phase_family_model_checks():
    """Each of FAMILY_ARCHS at full width, weights only on the card: the
    paged chunks plus a decode token through the kernels against the
    page gather, and the whole-prompt prefill through flash against the
    einsum path, within TOL_MODEL (deepseek: `phase_mla_model_check`);
    the peak memory of each."""
    for arch in FAMILY_ARCHS:
        cfg = family_config(arch)
        params = build_model(cfg)
        if cfg.segments[-1].block.attn.mla is not None:
            phase_mla_model_check(params, cfg)
        else:
            phase_model_check(params, None, cfg)
            phase_flash_model_check(params, None, cfg)
        log(f"model {cfg.name}: peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
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


def serve_config(argv, cfg):
    """The launcher's --server path for a config the registry does not
    hold (``cfg``), through its own internals as `serve.main` runs them:
    seeded weights, the calibration on its numpy prompts, then
    `serve._serve_traffic`."""
    args = serve.parse_args(argv)
    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    params = materialize(M.model_defs(cfg), gen, DEV)
    tokens = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (serve.CALIB_PROMPTS, serve.CALIB_LEN))
    casc, calib_s = serve._timed(
        DEV, Cascade.calibrate, params, cfg, tokens, args.lam,
        k=serve.CALIB_K, solve=False, use_flash=args.flash,
        use_ssd_kernel=args.ssd_kernel, use_kernel=args.dp_kernel)
    run = serve._serve_traffic(args, cfg, params, casc, DEV)
    run.calib_s = calib_s
    return run


def phase_serve(name, argv, must, must_not, eos=None, reaped=False,
                cfg=None, int8=False):
    """One full-width serve; every kernel's launch counter is zeroed
    just before and read just after.  Every server serve but UNTRACED
    runs under a tracer (``--trace-out``, unless an observability flag
    is given), whose events split its step times into chunk and
    decode-only steps.  With ``cfg`` the serve runs that config through
    `serve_config`; with ``int8`` inside `cache_int8` (the pool int8).
    Returns the launches and the run."""
    args = serve.parse_args(argv)
    if args.server and name != UNTRACED and not (args.trace_out
                                                 or args.obs_dir):
        OBS_ROOT.mkdir(parents=True, exist_ok=True)
        argv = argv + ["--trace-out", str(OBS_ROOT / f"{name}.json")]
    cfgs = [cfg] if cfg is not None else [
        get_config(a) for a in (args.cascade.split(":") if args.cascade
                                else [args.arch])]
    n_nodes = sum(c.n_ramps + 1 for c in cfgs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    with cache_int8(int8):
        run = serve.main(argv) if cfg is None else serve_config(argv, cfg)
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
    if int8:
        attn = next(c["attn"] for c in run.stepper.caches if "attn" in c)
        setup += (", int8 KV: pool leaves "
                  + ", ".join(f"{k} {str(t.dtype).removeprefix('torch.')}"
                              for k, t in attn.items()))
    log(f"serve [{name}]: {summary}, launches {launches}, peak memory "
        f"{peak:.0f} MiB, wall {wall:.1f} s ({setup})"
        + ("" if cfg is None else f"; config {cfg.name}"))
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


def serve_stats(run, n_nodes) -> dict:
    """A server serve's served-node histogram, token and TTFT p50 (ms)."""
    s = run.metrics.summary(slo=1.0)
    nodes = run.metrics.served_nodes
    return {"served_nodes": [nodes[i] for i in range(n_nodes)],
            "token_p50_ms": 1e3 * s["token_latency"]["p50"],
            "ttft_p50_ms": 1e3 * s["ttft"]["p50"]}


def phase_serves():
    """Every serve of SERVES and CASCADE_SERVES, then EDF_EOS; returns
    each serve's launch counts and the random-init main path's
    `serve_stats`."""
    by_path, streams = {}, {}
    for name, argv, must, must_not in SERVES + CASCADE_SERVES:
        by_path[name], run = phase_serve(name, argv, must, must_not)
        if name == UNTRACED:
            streams = {rid: rec.tokens
                       for rid, rec in run.metrics.records.items()}
            init_stats = serve_stats(
                run, get_config("paper-ee-100m").n_ramps + 1)
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
    by_path.update(phase_family_serves())
    return by_path, init_stats


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
    for name, argv, must, must_not, int8 in INT8_SERVES:
        by_path[name], run = phase_serve(name, argv, must, must_not,
                                         int8=int8)
        kv = run.stepper.caches[0]["attn"]["k"].dtype
        if kv != (torch.int8 if int8 else torch.bfloat16):
            raise SystemExit(f"serve [{name}]: the pool is {kv}")
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

def phase_family_serves() -> dict:
    """FAMILY_SERVES at full width, each model freed before the next."""
    by_path = {}
    for name, argv, must, must_not, cut in FAMILY_SERVES:
        cfg = phi35_cut() if cut else None
        if cfg is not None:
            log(f"serve [{name}]: {cfg.name}, {PHI35} cut to one layer in "
                f"each of its {len(cfg.segments)} segments, through the "
                f"launcher's own parse_args and _serve_traffic")
        by_path[name], run = phase_serve(name, argv, must, must_not,
                                         cfg=cfg)
        if name == "hymba_stw_recall_index":
            hcfg = get_config(HYMBA)
            ctx = run.stepper.prompt_len + max(r.max_tokens
                                               for r in run.requests)
            fl = model_flops(hcfg, kind="decode", global_batch=1,
                             seq_len=ctx)
            p50 = run.metrics.summary(slo=1.0)["token_latency"]["p50"]
            log(f"serve [{name}]: model_flops of one decode token at "
                f"{ctx} positions of context {fl:.6e} (launch/flops.py, "
                f"full depth); at the token p50 {1e3 * p50:.2f} ms, "
                f"{fl / p50 / 1e12:.4f} TFLOP/s a lane")
        del run
        torch.cuda.empty_cache()
    return by_path


# phase_train: full-width paper-ee-100m trained on the synthetic source
# with examples/train_ee.py's settings, then served from its checkpoint
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 300, 8, 256, 6e-4
TRAIN_WARMUP_STEPS = 3         # untimed steps before the step times
TRAIN_PROFILED_STEPS = 3       # then steps traced by torch.profiler
TOL_STEP = 1e-4                # f32 loss, CEs, grad norm: card vs CPU
CKPT_DIR = ROOT / "build" / "train"
INIT_AGAIN = "init_chunked_recall_index"
CKPT_SERVE = ("ckpt_chunked_recall_index",
              SERVE_ARGS + ["--policy", "recall_index"],
              PAGED, NEW + ("ssd_chunk",) + EXIT)


def _to(tree, dev):
    return tree_map(lambda t: t.detach().to(dev, copy=True), tree)


def phase_train_step_check(cfg):
    """(a) One f32 train step (no mixed precision, the default AdamW)
    from the same parameters and 2 x 64 synthetic tokens on the card and
    on the CPU: loss, every CE and the grad norm within rtol TOL_STEP;
    the parameters after the step within 2 lr + 1e-6 — Adam's first
    step moves a parameter by about lr * sign(g), so a gradient entry
    near 0 whose sign the two devices' sums disagree on lands 2 lr
    apart — with at most 0.1% of entries more than 1e-6 apart."""
    init = materialize(M.model_defs(cfg), torch.Generator().manual_seed(1),
                       "cpu")
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=65,
                                   global_batch=2, seed=1)).sample_batch(0)
    opt_cfg = AdamWConfig()
    lr1 = float(cosine_schedule(opt_cfg, torch.tensor(1)))
    out = {}
    for label, dev in (("card", DEV), ("cpu", torch.device("cpu"))):
        params = _to(init, dev)
        t0 = time.perf_counter()
        params, _, metrics = make_train_step(
            cfg, opt_cfg, mixed_precision=False)(
            params, init_opt_state(params),
            {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        metrics = {k: float(v) for k, v in metrics.items()}
        out[label] = (metrics, _to(params, "cpu"), time.perf_counter() - t0)
        del params
    (mc, pc, tc), (mh, ph, th) = out["card"], out["cpu"]
    errs = {k: abs(mc[k] - mh[k]) / max(abs(mh[k]), 1e-12) for k in mh}
    diffs = [(a - b).abs() for a, b in zip(tree_leaves(pc),
                                           tree_leaves(ph))]
    worst = max(float(d.max()) for d in diffs)
    far = sum(int((d > 1e-6).sum()) for d in diffs)
    total = sum(d.numel() for d in diffs)
    ok = (all(e <= TOL_STEP for e in errs.values())
          and worst <= 2 * lr1 + 1e-6 and far <= 1e-3 * total
          and all(math.isfinite(v) for v in mc.values()))
    log(f"train step check {cfg.name} [card vs CPU, f32, 2x64 tokens]: "
        f"loss {mc['loss']:.6f} vs {mh['loss']:.6f}, grad norm "
        f"{mc['grad_norm']:.6f} vs {mh['grad_norm']:.6f}, worst relative "
        f"metric error {max(errs.values()):.3e} (rtol {TOL_STEP}); "
        f"parameters after the step: max |diff| {worst:.3e} (bound "
        f"{2 * lr1 + 1e-6:.3e}), {far}/{total} entries beyond 1e-6; step "
        f"{tc:.2f} s on the card (first call), {th:.2f} s on the CPU "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"train step check failed: {errs}")


def node_loss_stats(params, cfg, tokens) -> str:
    """Per-node mean and spread (std) of the loss proxy of a prefill of
    ``tokens``, as the calibration computes it."""
    with torch.no_grad():
        _, _, nl, _ = M.prefill(params, cfg, {"tokens": torch.as_tensor(
            tokens, device=DEV)}, tokens.shape[1] + 8)
    nl = nl.float().cpu().numpy()
    if not np.isfinite(nl).all():
        raise SystemExit("node losses are not finite")
    def fmt(xs):
        return "[" + ", ".join(f"{x:.4f}" for x in xs) + "]"
    return f"mean {fmt(nl.mean(0))} std {fmt(nl.std(0))}"


def calib_tokens(cfg):
    """The launcher's calibration prompts (numpy, --seed 0)."""
    return np.random.default_rng(0).integers(
        0, cfg.vocab, (serve.CALIB_PROMPTS, serve.CALIB_LEN))


def phase_train_run(cfg, steps):
    """(b) ``steps`` steps of examples/train_ee.py's training (lr 6e-4,
    8 x 256 tokens, bf16 on f32 masters, remat) from the launcher's
    seed-0 init: loss and ce_final first -> last, step time p50 / p90
    from CUDA events around each step after TRAIN_WARMUP_STEPS and the
    TRAIN_PROFILED_STEPS after them (the batches are made and uploaded
    outside the events), tokens/s at the p50, peak memory.  The
    profiled steps (training steps like the others) give device busy,
    idle share against the p50, device ops and the top device and host
    ops a step.  The last loss must be below 0.8 x the first
    (tests/test_system.py's bar).  Returns the trained params, the
    held-out batch and a summary dict."""
    params = materialize(M.model_defs(cfg),
                         torch.Generator(device=DEV).manual_seed(0), DEV)
    log(f"train [{cfg.name}] random init: calibration node losses "
        f"{node_loss_stats(params, cfg, calib_tokens(cfg))}")
    opt_cfg = AdamWConfig(lr=TRAIN_LR, total_steps=steps,
                          warmup_steps=max(steps // 20, 1))
    state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg)
    data = batches(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ + 1,
                              global_batch=TRAIN_BATCH))
    host = [next(data) for _ in range(steps)]
    held_out = next(data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, metrics = [], []
    first = TRAIN_WARMUP_STEPS
    last = first + TRAIN_PROFILED_STEPS
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    for i, b in enumerate(host):
        batch = {k: torch.as_tensor(v, device=DEV) for k, v in b.items()}
        if i == first:
            torch.cuda.synchronize()
            prof.__enter__()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, state, m = step_fn(params, state, batch)
        e1.record()
        if i == last - 1:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        events.append((e0, e1))
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    ms = np.asarray([a.elapsed_time(b) for a, b in events[last:]])
    loss = [float(m["loss"]) for m in metrics]
    ce = [float(m["ce_final"]) for m in metrics]
    gnorm = [float(m["grad_norm"]) for m in metrics]
    p50, p90 = float(np.percentile(ms, 50)), float(np.percentile(ms, 90))
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3)
    dev, busy_ms, sync_by, by_dev, by_host = _trace_counts(
        prof, TRAIN_PROFILED_STEPS)
    top = lambda c: {k: round(v, 3) for k, v in c.most_common(8)}  # noqa
    log(f"profile [train {cfg.name}]: steps {first}-{last - 1} under "
        f"torch.profiler: device busy {busy_ms:.3f} ms a step, idle share "
        f"{1 - busy_ms / p50:.3f} of the p50 step, "
        f"{len(dev) / TRAIN_PROFILED_STEPS:.0f} device ops and "
        f"{sum(sync_by.values()) / TRAIN_PROFILED_STEPS:.0f} host syncs a "
        f"step ({json.dumps(top(sync_by))} over the {TRAIN_PROFILED_STEPS}"
        f"); top device ms a step {json.dumps(top(by_dev))}; top host "
        f"self ms a step {json.dumps(top(by_host))}")
    del prof
    summary = {"steps": steps, "loss_first": loss[0], "loss_last": loss[-1],
               "ce_final_first": ce[0], "ce_final_last": ce[-1],
               "step_ms_p50": p50, "step_ms_p90": p90,
               "tokens_per_s": tok_s, "peak_mib": peak, "wall_s": wall,
               "device_busy_ms": busy_ms,
               "device_ops": len(dev) / TRAIN_PROFILED_STEPS}
    log(f"train [{cfg.name}] {steps} steps of {TRAIN_BATCH}x{TRAIN_SEQ} "
        f"tokens (bf16 on f32 masters, remat, lr {TRAIN_LR}): loss "
        f"{loss[0]:.4f} -> {loss[-1]:.4f}, ce_final {ce[0]:.4f} -> "
        f"{ce[-1]:.4f}, grad norm {gnorm[0]:.3f} -> {gnorm[-1]:.3f}; step "
        f"time p50 {p50:.3f} ms p90 {p90:.3f} ms (CUDA events, "
        f"{len(ms)} steps after {last}), {tok_s:.0f} "
        f"tokens/s at the p50, peak memory {peak:.0f} MiB, loop wall "
        f"{wall:.1f} s")
    if not all(math.isfinite(v) for v in loss + gnorm):
        raise SystemExit("training produced a non-finite loss or grad norm")
    if not loss[-1] < 0.8 * loss[0]:
        raise SystemExit(f"training did not converge: loss {loss[0]} -> "
                         f"{loss[-1]} (needs < 0.8x)")
    return params, held_out, summary


def phase_ckpt_roundtrip(params, steps) -> Path:
    """(c) Save the trained params under build/ and load them back:
    every leaf EQUAL.  Prints the frame the card's install writes."""
    path = CKPT_DIR / f"state_{steps}.ckpt"
    t0 = time.perf_counter()
    checkpoint.save(str(path), {"params": params}, steps)
    t1 = time.perf_counter()
    tree, step = checkpoint.load(str(path))
    t2 = time.perf_counter()
    got = tree_leaves(tree["params"])
    want = tree_leaves(params)
    if step != steps or len(got) != len(want) or not all(
            torch.equal(w.cpu(), torch.as_tensor(g))
            for w, g in zip(want, got)):
        raise SystemExit("checkpoint round trip changed the parameters")
    log(f"checkpoint {path.relative_to(ROOT)}: {len(got)} leaves EQUAL "
        f"after save and load, codec {checkpoint.codec()}, "
        f"{path.stat().st_size / 2**20:.1f} MiB, save {t1 - t0:.2f} s, "
        f"load {t2 - t1:.2f} s")
    return path


def phase_autograd_refusal(params, cfg):
    """(f) forward_train with use_flash under autograd raises on the
    card, and so does the flash wrapper given a tensor that requires
    grad (the kernels have no backward)."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    toks = torch.zeros((1, 16), dtype=torch.int32, device=DEV)
    refused = []
    try:
        M.forward_train(p, cfg, {"tokens": toks, "labels": toks},
                        use_flash=True)
    except NotImplementedError as e:
        refused.append(str(e))
    q = torch.zeros((1, 16, 2, 64), device=DEV, requires_grad=True)
    try:
        flash_attention(q, q, q, scale=1.0)
    except NotImplementedError as e:
        refused.append(str(e))
    if len(refused) != 2:
        raise SystemExit(f"autograd through a kernel was not refused: "
                         f"{refused}")
    log("autograd refusal on the card: " + "; ".join(refused))


def phase_train(init_stats, steps=TRAIN_STEPS):
    """Steps (a)-(f): the f32 step on the card against the CPU, the
    training run, the checkpoint round trip, the model check on the
    trained weights, the main path served from the checkpoint
    (``--ckpt``) beside the random-init serve's ``init_stats``, and the
    autograd refusal.  Returns the serve's launches and the training
    summary."""
    cfg = get_config("paper-ee-100m")
    phase_train_step_check(cfg)
    torch.cuda.empty_cache()
    params, held_out, summary = phase_train_run(cfg, steps)
    path = phase_ckpt_roundtrip(params, steps)
    phase_model_check(params, _to(params, "cpu"), cfg)
    log(f"train [{cfg.name}] trained: calibration node losses "
        f"{node_loss_stats(params, cfg, calib_tokens(cfg))}; held-out "
        f"synthetic batch node losses (examples/train_ee.py's export) "
        f"{node_loss_stats(params, cfg, held_out['tokens'])}")
    phase_autograd_refusal(params, cfg)
    del params
    torch.cuda.empty_cache()
    # the random-init main path once more, right before the checkpoint's
    # serve, so the two compare under the same conditions
    name, argv, must, must_not = CKPT_SERVE
    by_path, stats = {}, {}
    for label, extra in ((INIT_AGAIN, []), (name, ["--ckpt", str(path)])):
        by_path[label], run = phase_serve(label, argv + extra, must,
                                          must_not)
        stats[label] = serve_stats(run, cfg.n_ramps + 1)
        del run
    stats[UNTRACED] = init_stats

    def line(st):
        return (f"served-node histogram {st['served_nodes']}, token p50 "
                f"{st['token_p50_ms']:.2f} ms, TTFT p50 "
                f"{st['ttft_p50_ms']:.1f} ms")
    log(f"serve [{name}]: {line(stats[name])}; random init just before "
        f"([{INIT_AGAIN}]): {line(stats[INIT_AGAIN])}; random init earlier "
        f"([{UNTRACED}]): {line(init_stats)}")
    summary["serves"] = stats
    return by_path, summary


# ---- the mesh tooling: op-cost counts on the card, the dry run ----------

OP_COST_ARCH = "qwen3-4b"
OP_COST_S = 4096           # the prefill's tokens (one row)
OP_COST_DECODE = (8, 4096)  # decode_step: lanes, ring slots


def _fake_tree(tree, fake):
    """A tree of real tensors as fake tensors of the same shapes."""
    return tree_map(lambda t: fake.from_tensor(t), tree)


def _counts(cost) -> dict:
    """What must agree between a real and a fake count (the op records
    may not: a size-1 dim's stride can differ between a fake tensor and
    a real one, and matmul then folds one into ``mm`` where it keeps the
    other a ``bmm`` of the same flops and bytes)."""
    return {"flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
            "collectives": cost.collectives, "kernels": cost.kernels}


def _event_ms(fn, reps=5) -> float:
    """Median device time of ``fn`` by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        out.append(t0.elapsed_time(t1))
    return float(np.median(out))


def phase_op_cost(card) -> dict:
    """`launch.op_cost` on real CUDA tensors at full-width qwen3-4b, with
    no mesh: prefill of 1 x OP_COST_S tokens plain and through the flash
    kernel (one kernel record a layer, bytes only), and decode_step of
    OP_COST_DECODE[0] lanes on a ring of OP_COST_DECODE[1] slots.  The
    plain counts must EQUAL those taken on fake tensors of the same
    shapes; the flash prefill must count no attention matmul, the plain
    one exactly the 2 x 2 S^2 H hd of its score and value products a
    layer.  Each step is timed (CUDA events, median of 5) and its
    achieved rates printed beside the card's f32 and memory rates."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(OP_COST_ARCH)
    params = build_model(cfg)
    n_layers = sum(seg.n_layers for seg in cfg.segments)
    a = cfg.segments[0].block.attn
    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (1, OP_COST_S)),
                          dtype=torch.int32, device=DEV)
    lanes, slots = OP_COST_DECODE
    def zeros(spec):
        if isinstance(spec, dict):
            return {k: zeros(v) for k, v in spec.items()}
        return torch.zeros(spec[0], dtype=spec[1], device=DEV)

    caches = [zeros(spec) for spec in M.cache_specs(cfg, lanes, slots)]
    for seg in caches:    # every slot holds a past position
        seg["attn"]["pos"].copy_(torch.arange(slots, device=DEV))
    dtok = torch.as_tensor(rng.integers(0, cfg.vocab, (lanes,)),
                           dtype=torch.int32, device=DEV)
    dpos = torch.full((lanes,), slots, dtype=torch.int32, device=DEV)
    steps = {
        "prefill": lambda p, t: M.prefill(p, cfg, {"tokens": t}, OP_COST_S),
        "prefill_flash": lambda p, t: M.prefill(
            p, cfg, {"tokens": t}, OP_COST_S, use_flash=True),
        "decode": lambda p, t, c, q: M.decode_step(p, cfg, {"tokens": t},
                                                   c, q),
    }
    args = {"prefill": (params, tok), "prefill_flash": (params, tok),
            "decode": (params, dtok, caches, dpos)}
    out = {}
    with torch.no_grad():
        for name, fn in steps.items():
            flash0 = FLASH_MOD.flash_attention.launches
            cost = op_cost.analyze(fn, *args[name])
            launched = FLASH_MOD.flash_attention.launches - flash0
            cost.result = None
            if name != "prefill_flash":
                fake = FakeTensorMode()
                with fake:
                    fargs = _fake_tree(args[name], fake)
                    fcost = op_cost.analyze(fn, *fargs)
                if _counts(fcost) != _counts(cost):
                    raise SystemExit(
                        f"op_cost [{name}]: the real count (flops "
                        f"{cost.flops}, bytes {cost.hbm_bytes}) differs "
                        f"from the fake one (flops {fcost.flops}, bytes "
                        f"{fcost.hbm_bytes})")
                del fcost, fargs
            ms = _event_ms(lambda: fn(*args[name]))
            out[name] = dict(flops=cost.flops, hbm_bytes=cost.hbm_bytes,
                             kernels=cost.kernels, launched=launched,
                             bmm_flops=sum(r["flops"] for r in cost.records
                                           if r["op"] == "bmm"),
                             temp_bytes=cost.temp_bytes, ms=ms,
                             tflops=cost.flops / ms / 1e9,
                             tbs=cost.hbm_bytes / ms / 1e9)
            log(f"op_cost [{OP_COST_ARCH} {name}]: flops {cost.flops:.6g}, "
                f"HBM bytes {cost.hbm_bytes:.6g}, kernel records "
                f"{cost.kernels}, temp {cost.temp_bytes / 2**30:.2f} GiB; "
                f"{ms:.3f} ms (CUDA events, median of 5): "
                f"{out[name]['tflops']:.2f} TFLOP/s "
                f"({out[name]['tflops'] / (F32_FLOP_S / 1e12):.1%} of "
                f"{F32_FLOP_S / 1e12:.0f} f32), {out[name]['tbs']:.3f} TB/s "
                f"({out[name]['tbs'] / (HBM_BYTES_S / 1e12):.1%} of "
                f"{HBM_BYTES_S / 1e12} TB/s) [{card}]"
                + ("" if name == "prefill_flash" else "; fake count EQUAL"))
    plain, flash = out["prefill"], out["prefill_flash"]
    attn = n_layers * 2 * (2 * OP_COST_S ** 2 * a.n_heads * a.head_dim)
    if flash["kernels"] != {"flash_attention": n_layers} \
            or flash["launched"] != n_layers:
        raise SystemExit(f"op_cost: the flash prefill reported "
                         f"{flash['kernels']} ({flash['launched']} "
                         f"launches), not {n_layers} flash records")
    if plain["bmm_flops"] != attn or flash["bmm_flops"] != 0:
        raise SystemExit(f"op_cost: attention matmuls {plain['bmm_flops']} "
                         f"(plain) / {flash['bmm_flops']} (flash), want "
                         f"{attn} / 0")
    log(f"op_cost [{OP_COST_ARCH}]: plain - flash prefill = "
        f"{plain['flops'] - flash['flops']:.6g} flops: the attention "
        f"matmuls' {attn:.6g} and {plain['flops'] - flash['flops'] - attn:.6g}"
        f" of masking and softmax")
    del params, caches
    torch.cuda.empty_cache()
    return out


# each combination of the dry run: (arch, shape, extra flags).  train_4k
# is left out: its 16 microbatches of 36 layers take the DTensor trace
# tens of minutes (ROADMAP), far past this phase's budget.
DRYRUN_COMBOS = (
    [(a, "decode_32k", []) for a in (
        "deepseek-v2-lite-16b", "qwen3-4b", "qwen3-14b", "mamba2-130m",
        "hymba-1.5b", "phi3.5-moe-42b-a6.6b", "granite-3-2b",
        "musicgen-large", "starcoder2-3b", "phi-3-vision-4.2b")]
    + [(a, "prefill_32k", []) for a in ("qwen3-4b", "phi3.5-moe-42b-a6.6b",
                                        "hymba-1.5b")]
    + [(a, "long_500k", []) for a in ("mamba2-130m", "hymba-1.5b",
                                      "qwen3-4b")]
    + [("qwen3-4b", "decode_32k", ["--multi-pod"]),
       ("qwen3-14b", "decode_32k", ["--variant", "gqa_mesh"])])
DRYRUN_OUT = ROOT / "build" / "dryrun_torch"
DRYRUN_PROCS = 8


def phase_dryrun() -> dict:
    """`python -m repro_torch.launch.dryrun` for every DRYRUN_COMBOS
    entry, each in a process of its own (the fake backend's 512-rank
    world is process-wide), DRYRUN_PROCS at a time, none on the card.
    A process that exits nonzero fails the script; each result's
    per-device numbers and trace time are printed."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    todo = list(DRYRUN_COMBOS)
    running, results = [], {}
    t0 = time.perf_counter()
    try:
        while todo or running:
            while todo and len(running) < DRYRUN_PROCS:
                arch, shape, extra = todo.pop(0)
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--force",
                       "--out", str(DRYRUN_OUT), *extra]
                # the output goes to a file: a pipe nobody reads until
                # the process ends would fill and stall it
                out = DRYRUN_OUT / ("_".join([arch, shape] + [
                    e.lstrip("-") for e in extra]) + ".log")
                with open(out, "w") as sink:
                    proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                            stdout=sink,
                                            stderr=subprocess.STDOUT)
                running.append(((arch, shape, extra, out), proc))
            time.sleep(0.5)
            for item in [r for r in running if r[1].poll() is not None]:
                running.remove(item)
                (arch, shape, extra, out), proc = item
                if proc.returncode != 0:
                    raise SystemExit(f"dry run {arch} {shape} {extra} "
                                     f"exited {proc.returncode}:\n"
                                     f"{out.read_text()[-3000:]}")
                mesh = "pod2x16x16" if "--multi-pod" in extra else \
                    "pod16x16"
                tag = "baseline" if not extra or "--multi-pod" in extra \
                    else f"baseline+{extra[1]}"
                res = json.loads((DRYRUN_OUT / f"{arch}__{shape}__{mesh}__"
                                  f"{tag}.json").read_text())
                results[(arch, shape, mesh, tag)] = res
                mem = res["memory"]
                log(f"dryrun [{arch} x {shape} x {mesh} ({tag})]: trace "
                    f"{res['trace_s']} s; per device: flops "
                    f"{res['flops_per_device']:.6g}, HBM bytes "
                    f"{res['hbm_bytes_per_device']:.6g}, wire "
                    f"{res['wire_bytes_per_device']:.6g} (pod "
                    f"{res['pod_wire_bytes_per_device']:.6g}), argument "
                    f"{mem['argument_bytes']}, output {mem['output_bytes']},"
                    f" temp {mem['temp_bytes']}; model flops "
                    f"{res['model_flops']:.6g}; replicated ops "
                    f"{res['replicated_ops']}")
    finally:
        for _, proc in running:
            proc.kill()
            proc.wait()
    log(f"dryrun: {len(results)} combinations in "
        f"{time.perf_counter() - t0:.1f} s ({DRYRUN_PROCS} processes; "
        f"train_4k left out, see DRYRUN_COMBOS)")
    return results


_LAP = [0.0]


def lap(what: str) -> None:
    """Log the script time since the previous lap (the first lap starts
    the clock)."""
    now = time.perf_counter()
    if _LAP[0]:
        log(f"phase time [{what}]: {now - _LAP[0]:.1f} s")
    _LAP[0] = now


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
    lap("start")
    resources = phase_build()
    lap("build")
    errs = phase_kernel_checks()
    errs["ramp_exit"] = phase_exit_checks()
    lap("kernel checks")
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
    lap("paper-ee-100m checks")
    cfg = get_config("mamba2-130m")
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = materialize(M.model_defs(cfg), gen, DEV)
    params_cpu = tree_map(lambda t: t.cpu(), params)
    phase_ssm_model_check(params, params_cpu, cfg)
    phase_calibration_timing(params, cfg, "use_ssd_kernel")
    del params, params_cpu
    torch.cuda.empty_cache()
    lap("mamba2-130m checks")
    phase_dense_model_checks()
    lap("dense model checks")
    phase_family_model_checks()
    lap("family model checks")
    phase_hybrid_checks()
    lap("hymba-1.5b checks and long prefill")
    phase_int8()
    lap("int8 checks")
    times = phase_timing()
    floor = launch_floor_ms()
    log(f"launch_floor_ms {floor:.6f} (device, graph replay of an in-place "
        f"add on one element)")
    lap("timing")
    phase_sim_digest()
    phase_control_sim()
    phase_chaos_sim()
    lap("sims")
    # each path's own counts; each kernel's main path is MAIN_PATH's
    by_path = {DECISION: decision}
    serves, init_stats = phase_serves()
    by_path.update(serves)
    lap("serves")
    train_paths, train = phase_train(init_stats)
    by_path.update(train_paths)
    lap("training")
    counted = phase_op_cost(card)
    lap("op_cost")
    phase_dryrun()
    lap("dry run")
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
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor,
                      "train": train, "op_cost": counted}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
