#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of RANGE-LSH on one NVIDIA GPU.

    python3 chip_smoke.py            # N = 2,340,373, d = 150, 1,000 queries

Phases, each fatal on failure:

1. Device and build: the card's name and power limit (nvidia-smi), then
   the CUDA kernels built from ``src/repro_torch/kernels/csrc``.
2. Main path, at the scale of the paper's ImageNet set (synthetic
   ``imagenet`` profile, d = 150): RANGE-LSH build (code_len 32, m 32,
   percentile) and planner calibration, then 1,000 held-out queries in
   batches of 64 through the fused, fused-int8, staged bucket and dense
   arms under the planned recall-0.9 budgets. The kernels' launch
   counters are zeroed just before and read just after; every kernel must
   have launched. Bucket and dense candidate ids must be identical, fused
   ids must match the staged ids tie-aware, and recall@10 against exact
   MIPS must reach the target less 0.05.
3. Streaming: phase 2's index mounted as a ``MutableIndex`` (capacity
   1024, 256 tombstones, engine "auto"), calibrated (256 queries, k 10),
   then 32 rounds of traffic: 64 inserts of fresh ``imagenet``-profile
   vectors, 16 deletes of random live ids (8 base rows, 8 delta slots),
   and one 64-query batch at recall target 0.9 through the "auto" (dense
   at this size) and the bucket arm. At round 8 one insert has 2.5 times
   the largest range bound: a localized repartition of the top range,
   after which the stale calibration is redone. The launch counters are
   zeroed before the mount and read after the traffic; every kernel of
   the streaming path must have launched. Then: merged candidates equal
   a from-scratch rebuild (the port's bucket store and core engines) in
   both arms, candidates are unchanged across ``compact()``, and recall@10
   against ``mips_topk`` over the live set reaches 0.85 over all batches.
4. Kernels against their plain PyTorch versions on the card. First the
   kernel registry's checks (``repro_torch.analysis.kernelcheck``, K1-K5,
   fatal on any finding): the reference's padding probes, kernel against
   plain version, and every launch plan of phases 2 and 3 against the
   card's limits. Then at the shapes the two paths gave them:
   integer outputs exactly, fused-query and mips_topk values within atol
   1e-4 and rtol 1e-5 (150-term f32 dots summed in another order), ids
   tie-aware. Times are medians of 10 CUDA-event-timed runs after
   warm-up (``ms``); the fused query and mips_topk also get ``ms_cold``,
   each launch timed alone after a 256 MiB write that flushes the 50 MB
   L2, and with it K5 at the path's shape (here and in every later
   phase's rows): the kernel's cost model, its operations over 67
   TOP/s and bytes over 3.35 TB/s, at most 105% of ``ms_cold``
   (``cost_share``); fatal on any finding. The cost is the kernel's own
   work (``RegisteredKernel.kernel_cost``: for mips_topk each item row
   read once a 64-query tile, where the billed model reads it once a
   query). A kernel's bound counts each input byte it needs once (for the
   fused query: each probed row once, however many queries of the batch
   probe it) and the operations this run's inputs need, over 67 TOP/s,
   or for hash_encode, whose multiplies and adds are rounded apart (no
   FMA), over half that (``op_rate``). A row's ``launches`` are those of
   the path it serves (phase 2 for slice 1's kernels, phase 3 for
   bucket_match, delta_scan, mips_topk and ``bucket_gather_stream``) at
   the shape the row is timed at; ``launches_all`` counts every shape.
   ``hamming_scan`` is timed also at N rounded down to a multiple of 8
   (every output row sector-aligned; no path launches that shape), under
   ``hamming_scan_aligned`` inside that kernel's record, and
   ``hash_encode`` at a 64-query batch (``hash_encode_query``, the shape
   of most of its launches) inside its record. ``bucket_gather_stream``
   is the gather of the streaming bucket arm, its runs built as that
   arm builds them at phase 3's final state. The ``hamming.cu`` and
   ``bucket_gather`` rows get ``ceiling_ms``, the event-timed ``fill_``
   of an int32 tensor of their output's shape (for the wide outputs the
   practical store ceiling, for delta_scan the launch floor); those rows
   and ``hash_encode`` get ``device_ms``, the median device time of 20
   calls under ``torch.profiler`` (of those it recorded). Lines headed
   ``yardstick:`` time one PyTorch call that computes part of a kernel's
   function (``torch.searchsorted`` for the run index, ``x @ A`` for the
   projection); they are not library pairs. The port's own kernel
   ``planned_runs`` (the per-range take, plain jnp in the reference) has a
   row at the main path's probe order and budgets, bound by its bytes
   (no operations counted), and one at the benchmark cell's shape
   (``yahoomusic``, 136,736 x 300, m 32, code length 32, a seeded plan at
   recall 0.9): there 8 batches of 64 are served through the fused engine
   with the launch counters zeroed before, ``planned_runs`` must launch
   once a batch, and a ``yardstick:`` line times the parent's composition
   (32 masked passes, the take, the exclusive cumsum, caps copied from
   the host).

5. The rest of the spec API at the same N and d. The launch counters are
   zeroed just before the path and read right after its last call,
   before any check or case input that calls a kernel; every kernel must
   have launched. The path: a SIGN-ALSH and an L2-ALSH index (code_len
   32, m 32, recall target 0.9) are built and calibrated (256 queries)
   and answer the 1,000 queries in batches of 64 through the bucket and
   fused engines at the planned budgets (recall@10 against ``mips_topk``
   must reach 0.85 in every arm, fused ids must match the bucket ids
   tie-aware); ``adaptive_query`` at target 0.9 on phase 2's bucket
   engine (128 queries); a 4-table SIMPLE-LSH index (16 bits, m 32); the
   paper's Fig. 2 at code length 32 (probed-item recall@10 at 0.5%, 2%
   and 10% of N and the probes for recall 0.5 of SIMPLE-LSH, RANGE-LSH
   at m 32, phase 2's index, and m 64, flat L2-ALSH and the SIGN-ALSH
   index, with the SIMPLE-LSH to RANGE-LSH probe ratio: measurements, no
   limit); one SIGN-ALSH streaming round (64 inserts, 16 deletes, one
   batch through "auto" and "bucket" at the planned width). Then the
   checks: both families' item codes and a query batch's codes must
   equal the paper's transform and hash recomputed in f64 except inside
   the band an f32 product can cross; the adaptive (vals, ids) must equal
   the planned re-rank's tie-aware; the multi-table ids and candidate
   counts must equal ``impl="ref"``'s; the streaming candidates must
   equal a rebuild. Then each kernel is held against its plain version
   at the shapes this phase gave it (as in phase 4; the plain fused
   query runs a few queries at a time), and every ``kernels`` row gets
   its kernel's launches on each path (``launches_by_path``).

6. Observability and the legacy shims at the same N and d. The launch
   counters are zeroed just before the path and read right after its last
   call, before any comparison or case input. The path: each arm of phase
   2 (fused, fused int8, bucket, dense) as a fresh ``QueryEngine`` with a
   ``Tracker([RingBufferSink()])`` and the kernels' dispatch tracker, over
   4 batches of 64 at phase 2's budgets; one round of 64 inserts, 16
   deletes, a compaction and one batch through "auto" and "bucket" on
   phase 3's index with a tracker set; the SIMPLE-LSH (L 32) and RANGE-LSH
   (L 32, m 64) shims built and their ``bucket_stats`` (the paper's §3.1
   balance, a measurement with no limit), a RANGE-LSH bucket-engine query
   at ``num_probe`` 0.5% of N; the SIGN-ALSH and L2-ALSH shims built and
   queried densely at that width; a 4-table shim. Then the checks: each
   tracked batch equals the untracked engine's (``torch.equal``), every
   stage span of the arm was recorded, ``repro.engine.queries`` counted
   256, each op's ``.cuda`` dispatch count equals its launches in the
   arm's window (``fused_query`` counts both builds) and no ``.ref``
   dispatch appears; the streaming round's events reach the tracker with
   the drift gauges, and its ids equal the untracked call's; the shims'
   ids equal indexes built through the spec API on the same parameters,
   and the multi-table shim equals ``ComposedMultiTable``. Printed: each
   arm's span p50s and tracked against bare ms per batch, and the event
   count of a Chrome trace of one fused batch written to
   ``chiprun_out/obs_fused_batch_trace.json``. Then ``bucket_match`` is
   held against its plain version at the legacy directory's shape.

7. LSH-decode serving and the distributed engine. Qwen3-0.6B at full
   width (28 layers, d 1024, 16/8 heads, head_dim 128, d_ff 3072, vocab
   151,936 padded to 152,064, tied embeddings), bf16 weights drawn from a
   seeded generator on the card, the vocabulary's padding rows zero. The
   launch counters and a dispatch tracker are zeroed just before the path
   and read right after its last call. The path: the vocab index
   (code_len 128, 64 ranges), the sharded heads' indexes (code_len 64, 16
   ranges, one shard and four) and the streaming head's, then 8 requests
   of 64 seeded tokens, 16 greedy tokens each, through ``BatchedServer``
   with every head (exact; LSH dense at 1,024 probes and at num_probe =
   V; LSH bucket, fused f32 and int8 at V; sharded over a one-rank NCCL
   group and over 4 in-process shards at V; streaming at V, then 64
   inserts, 16 deletes and a second call); the head's planner fitted on
   512 held-out prefill states and a server at recall target 0.9; the
   distributed engine over slice 1's index (phase 2's parameters and
   calibration) on 4 in-process shards and on the NCCL group, both arms,
   planned budgets and target 0.9, 2 batches of 64. Then the checks:
   every kernel of the path launched, each op's ``.cuda`` dispatch count
   equals its launches and no ``.ref`` dispatch appears; at num_probe = V
   every LSH head's tokens equal the exact head's; no deleted token comes
   back; recall@1 of the calibrated head against the exact head on 512
   fresh prefill states is at least 0.85; the distributed ids equal
   ``QueryEngine``'s. Printed: each head's prefill, decode-step and head
   span p50s and tokens/s, and a profile of one decode step (exact head)
   and one fused head call. Then the kernels at the path's new shapes:
   ``hash_encode`` at 152,064 x 1024 x 122 (with the 8-row step inside
   its row) and x 60, ``hamming_scan`` and ``bucket_match`` at 8 x the
   vocabulary, ``bucket_gather`` and both fused builds at num_probe = V,
   ``delta_scan`` at the streaming head's buffer.

8. Every other config of ``configs/`` through the LSH vocabulary head, at
   full width, bf16 weights drawn from a seeded generator on the card
   (no checkpoint is in the repository), the vocabulary's padding rows
   zero, each model freed before the next (``MODEL_RUNS``):
   granite-moe-1b-a400m (24 layers, MoE 32 experts top-8; heads exact,
   LSH dense, bucket, fused f32 and int8), minicpm3-4b (62 layers, MLA;
   exact, dense, fused), xlstm-1.3b (48 layers, mLSTM 7 : sLSTM 1,
   d_ff = 0; exact, dense, fused), internvl2-1b (24 layers, QKV bias;
   exact, dense, fused), whisper-small (12 + 12 layers; exact, dense,
   fused f32 and int8) and llama4-scout (8 of its 48 layers: the full
   stack is ~214 GB of bf16 weights; top-1 routing and the shared
   expert; exact, dense, fused f32 and int8); every LSH head at
   num_probe = V. For each model the launch counters and a dispatch
   tracker are zeroed just before its path and read right after it: the
   vocab index (code_len 128, 64 ranges), then 8 requests of 64 seeded
   prompt tokens and 16 greedy tokens through ``BatchedServer`` with
   each head; internvl2 also prefills 256 seeded patch embeddings before
   the prompt and decodes 15 steps from the padded cache (positions
   320+) through the exact and dense heads; whisper, which the reference
   serves without ``BatchedServer``, runs its serving path: 1,500 seeded
   frames through ``encoder_forward`` and ``cross_kv``, then 16 decode
   steps with each head on the hidden state. Then the checks: every
   kernel of the model's heads launched, each op's ``.cuda`` dispatch
   count equals its launches and no ``.ref`` dispatch appears; at
   num_probe = V every LSH head's tokens equal the exact head's; for
   minicpm3, xlstm and internvl2 (neither MoE, whose decode capacity is
   per decode group, nor encoder-decoder) a teacher-forced decode over
   the exact tokens, on f32 copies of the weights, equals a full forward
   at the same positions within atol and rtol 5e-2
   (``tests/test_models.py``'s bound; the bf16 run's largest difference
   is printed: its roundings compound through the random-weight layers);
   every hidden state seen is finite. Printed: each model's parameter count, prefill,
   decode-step and head span p50s and tokens/s, and the phase's wall
   time. Then, the model's layers freed, its kernel rows: ``hash_encode``
   at its vocabulary build (V x d x 122, the decode step's 8-row encode
   inside the row), ``hamming_scan`` at 8 x 202,240 (llama4) and both
   fused builds at 8 x V for whisper's d 768 and llama4's d 5120. Last,
   jamba-1.5-large at d 8192, blocks only (its ~796 GB of weights fit no
   1 or 4 cards): one Mamba layer (prefill 64 tokens through the chunked
   scan, 16 decode steps, equal to one forward over all 80 within 5e-2,
   the conv cache exactly) and one MoE layer (16 experts top-2, d_ff 24,576: a prefill
   batch and a decode group, finite, aux >= 1).

9. Training at full width, no kernel of its own (the reference trains
   with jnp ops under ``jax.value_and_grad``; the port with autograd).
   Qwen3-0.6B as published (28 layers, d 1024, vocab 151,936 padded to
   152,064, tied embeddings), random bf16 weights from a seed (no
   checkpoint is in the repository), the synthetic corpus at sequence
   512 and global batch 8, ``TrainHParams(lr=1e-3, warmup=2,
   total_steps=20)`` with bf16 gradient compression: ``run_training`` for
   4 steps with one checkpoint (~8.4 GB: bf16 params, f32 AdamW moments
   and residuals) in a temporary directory under ``build/``, whose
   restore must equal the saved state bit for bit, then ``run_training``
   again to step 6 from it, which must start at step 4; the loss at step
   5 must lie below step 0's. Then Qwen3-0.6B, granite-moe-1b-a400m (24
   layers, 32 experts top-8, batch 8 x 512) and whisper-small (12 + 12
   layers, 1,500 seeded frames, batch 4 x 448, its decoder's limit)
   through ``make_train_step`` for 5 steps each: every loss, ce, aux and
   gnorm finite, granite's aux >= 1, every param and gradient on the
   card. Printed for each: parameter count, step p50 on the host clock
   (ending in a synchronise, the first step left out), tokens/s, one
   profiled step's device-busy share and its forward, backward and
   optimizer split, peak memory above what the earlier phases still hold;
   each state's checkpoint size, write and restore seconds. The directory
   is removed afterwards. Then xlstm-1.3b at full width (d 2048, 4
   heads, its 7 mLSTM : 1 sLSTM period) cut to one period, 8 of its 48
   blocks, at 4 x 64 tokens through ``make_train_step`` for 5 steps, the
   same checks and prints (no checkpoint), and the loss on a held-out
   batch must fall across the steps. Last, jamba's Mamba block at full
   width (d 8192, d_inner 16,384, N 16, chunk 16) on f32 copies of
   seeded weights, 2 x 1,024 tokens: forward and backward (the gradients
   of a seeded cotangent with respect to the input and every weight)
   through the chunked scan, timed, with its peak memory, then with the
   sequential loop in its place (``sequential_scan``, the plain version):
   the output, the final state and every gradient within 1e-4 of the
   loop's largest magnitude. A whole jamba layer does not train on one
   card (its MoE's f32 AdamW moments alone are ~77 GB).

10. The paper's own application: ALS embeddings served through
    RANGE-LSH. ``synthetic_ratings`` at 20,000 users x 17,770 items
    (Netflix's item count; users cut from 480,189, whose dense ratings
    and weights would take 68 GB), true rank 16, density 0.05;
    ``als_factorize`` at rank 300 (the ``netflix`` profile's d), 8
    sweeps, each sweep one call from the previous factors. A RANGE-LSH
    index (code_len 32, m 32, percentile, recall target 0.9) over the
    item factors, calibrated on 256 held-out users; 1,024 user queries
    in batches of 64 through the fused, fused-int8, bucket and dense arms
    at the planned budgets, truth from ``mips_topk``. The launch counters
    and a dispatch tracker are zeroed just before the path and read right
    after. Checks: the loss falls from sweep 1 to sweep 8, recall@10 >=
    0.85 in every arm, bucket and dense candidate ids identical, fused
    ids equal the bucket arm's tie-aware, each of ``ALS_KERNELS``
    launched with ``.cuda`` dispatch counts equal to launches and no
    ``.ref`` dispatch. Printed: loss and seconds by sweep, the item-norm
    max/median, the planned width and ms per batch per arm; then kernel
    rows for ``hash_encode`` at 17,770 x 300 x 27 and ``fused_query`` at
    d 300, measured as phase 4's.

11. The analysis layer. The launch counters are zeroed just before
    ``kernelcheck.run_kernelcheck`` and read right after; every kernel
    must have launched. Kernelcheck on the card: K1-K3 over every plan of
    the registry's shape classes and of every launch shape phases 2-10
    recorded (shared memory against the card's opt-in limit, threads,
    grid limits, ptxas registers x threads, coverage, merges declared),
    K4 (the padding probes), K5 (the kernel's cost model; each class timed
    cold, the cost's operations over 67 TOP/s and bytes over 3.35 TB/s
    at most 105% of the time; the paths' shapes had theirs in their
    rows); a row per kernel, class and build is printed, any finding is
    fatal. Then ``FlopCounterMode`` over one Qwen3-0.6B
    ``lm.prefill`` and one ``make_train_step`` step at 8 x 512 (random
    bf16 weights from a seed, no LSH head) against
    ``parallel/analytic.estimate``'s matmul and attention terms: the
    counts, their ratio and the terms the two count differently (no
    gate). The roofline (``parallel/roofline.py``, the card's data-sheet
    peaks) of phase 9's three step p50s and phase 7's exact-head decode
    step: compute and memory terms, ``roofline_fraction`` and the share
    of the bf16 peak the measured step attains. Last, the dry run's
    parameter counts, estimates and input stand-ins for all 32 cells of
    ``configs/`` x ``shape_cells`` on meta parameters: fatal if a tensor
    leaves ``meta`` or ``torch.cuda.memory_allocated`` moves.

12. The mesh. The dry run's Qwen3-0.6B cells (train_4k, prefill_32k,
    decode_32k) and xlstm-1.3b's train_4k (its time loops traced by
    trip) on the 16 x 16 pod mesh start first, each in its own
    process without the card (``python -m repro_torch.launch.dryrun``: a
    fake 256-rank group, meta DTensors). The launch counters are zeroed
    and an NCCL world of one rank is initialised (a ``file://``
    rendezvous in a temporary directory); on its 1 x 1 mesh: (a) three
    ``make_train_step`` steps of Qwen3-0.6B at full width, 8 x 512, from
    one seeded state meshless and placed by ``state_specs``: equal
    losses, states equal bit for bit, both step times printed; (b) 8
    requests of 64 prompt tokens and 16 greedy tokens through
    ``make_prefill``/``make_decode_step`` meshless and with the mesh:
    equal tokens, both step times printed; (c)
    ``decode_attention_seq_sharded`` at Qwen3's decode layer shape (B 8,
    cache 32,768, KV 8, hd 128, H 16; f32) over 4 in-process shards
    against ``decode_attention``, both timed; (d) the MIPS cell on the pod
    mesh on the card (2,000,000 x 128 items, L 128, m 256, 1,024 queries,
    k 10, probe 512; 16 item shards x 16 query shards in process), its
    ids equal to the kernels' plain versions'; (e) ``elastic_recover`` of
    a reduced Qwen3 state from a checkpoint under ``build/``, bit for
    bit. Every kernel of the MIPS cell's path must have launched. Then
    the dry-run cells' records are read: ok, per-device argument bytes
    against the card's memory, collectives by op, wire bytes and roofline
    terms. Fatal on any failure.

The line before the last is a JSON ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the repository's ``src/repro_torch`` beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
PEAK_OPS = 67e12          # H100 SXM f32 outside the tensor cores, op/s
# hash_encode rounds each multiply and add on its own (no FMA): two f32
# instructions a term, at half the FMA-counted rate
PEAK_OPS_NO_FMA = PEAK_OPS / 2
ATOL, RTOL = 1e-4, 1e-5   # f32 dots of 150 terms summed in another order
N_ITEMS = 2340373         # ImageNet, Yan et al. 2018 section 6
DIM = 150
NUM_QUERIES = 1000
K = 10
RECALL_TARGET = 0.9
BATCH = 64
SEED = 0
CELL_ITEMS = 136736       # the benchmark cell's catalogue (Yahoo!Music R2)
CELL_DIM = 300
CELL_BATCHES = 8          # budgeted batches served at the cell's shape
SLICE1_KERNELS = ("hash_encode", "hamming_scan", "bucket_gather",
                  "fused_query", "fused_query_int8", "planned_runs")
STREAM_KERNELS = ("hash_encode", "bucket_match", "bucket_gather",
                  "delta_scan", "mips_topk")
ROUNDS = 32               # streaming traffic
INSERTS = 64
DELETES = 16              # half from the base, half from the delta
OVERFLOW_ROUND = 8
OVERFLOW_FACTOR = 2.5
STREAM_RECALL = 0.85
ALSH_KERNELS = ("hash_encode", "hamming_scan", "bucket_gather",
                "fused_query", "bucket_match", "delta_scan", "mips_topk")
ALSH_RECALL = 0.85        # each arm of both ALSH families at target 0.9
ADAPTIVE_QUERIES = 128    # two batches through adaptive_query
FIG2_M = 64               # benchmarks/fig2_recall.py's M_FOR_L[32]
FIG2_FRACTIONS = (0.005, 0.02, 0.10)
OBS_KERNELS = ("hash_encode", "hamming_scan", "bucket_gather",
               "fused_query", "fused_query_int8", "bucket_match",
               "delta_scan")
OBS_BATCHES = 4           # tracked 64-query batches in each arm
LEGACY_M = 64             # the RANGE-LSH shim's ranges (Fig. 2's m at L 32)
LEGACY_PROBE = 0.005      # the legacy queries' num_probe, a share of N
TRACE_DIR = Path("chiprun_out")
SERVE_ARCH = "qwen3_0_6b"  # full width: 28 layers, d 1024, vocab 151,936
SERVE_BATCH = 8           # requests of a generate call
SERVE_PROMPT = 64         # prompt tokens
SERVE_MAX_SEQ = 128
SERVE_STEPS = 16          # greedy tokens a request
SERVE_CAL = 512           # held-out prefill states for the head's planner
SERVE_RECALL = 0.85       # recall@1 floor of the head at target 0.9
SERVE_INSERTS, SERVE_DELETES = 64, 16
DIST_SHARDS = 4           # in-process shards of the slice-1 index
DIST_BATCHES = 2          # 64-query batches through the distributed arms
SERVE_KERNELS = ("hash_encode", "hamming_scan", "bucket_match",
                 "bucket_gather", "fused_query", "fused_query_int8",
                 "delta_scan")
SERVE_SPANS = ("repro.serve.prefill", "repro.serve.decode_step",
               "repro.serve.topk_head")
# phase 8: every other config of configs/ through the LSH vocabulary head,
# each at full width: (arch, layers run (None: all), heads it is served
# by, heads whose kernels get rows beyond the vocabulary encode)
MODEL_RUNS = (
    ("granite_moe_1b_a400m", None,
     ("exact", "lsh_dense", "lsh_bucket", "fused", "fused_int8"), ()),
    ("minicpm3_4b", None, ("exact", "lsh_dense", "fused"), ()),
    ("xlstm_1_3b", None, ("exact", "lsh_dense", "fused"), ()),
    ("internvl2_1b", None, ("exact", "lsh_dense", "fused"), ()),
    ("whisper_small", None, ("exact", "lsh_dense", "fused", "fused_int8"),
     ("fused", "fused_int8")),
    # 8 of 48 layers: the full stack is ~214 GB of bf16 weights
    ("llama4_scout_17b_a16e", 8,
     ("exact", "lsh_dense", "fused", "fused_int8"),
     ("lsh_dense", "fused", "fused_int8")),
)
FUSED_HEADS = ("fused", "fused_int8")
# phase 9: training, Qwen3-0.6B through run_training with a checkpoint and
# a resume, then (arch, global batch, sequence) through make_train_step
TRAIN_ARCH = "qwen3_0_6b"
TRAIN_BATCH = 8
TRAIN_SEQ = 512
TRAIN_STEPS = 4           # the first run, one checkpoint at its end
TRAIN_RESUME = 6          # the resumed run's last step + 1
TRAIN_HP = dict(lr=1e-3, warmup=2, total_steps=20)
TRAIN_RUNS = (("qwen3_0_6b", 8, 512), ("granite_moe_1b_a400m", 8, 512),
              ("whisper_small", 4, 448))   # whisper's decoder holds 448
TRAIN_TIMED = 5           # host-timed steps of each model
# xLSTM-1.3b at full width (d 2048, 4 heads, its 7 mLSTM : 1 sLSTM period)
# through make_train_step, cut to one period (8 of 48 blocks) at 4 x 64
# tokens: its cells step through time on the host (~5 x 10^4 launches a
# step, each profiled), and the period's recompute holds two (B, 4, 512,
# 1024) f32 memory states a step in each mLSTM block (~28 GiB here, ~112
# GiB at 4 x 256)
XLSTM_TRAIN = ("xlstm_1_3b", 4, 64, 8)    # arch, batch, sequence, blocks
# jamba's Mamba block at full width (d 8192, d_inner 16,384, N 16, chunk
# 16), forward and backward on f32 copies of its weights: B x S tokens give
# 2 GiB a (B, S, d_inner, N) f32 tensor
MAMBA_BATCH, MAMBA_SEQ = 2, 1024
MAMBA_TOL = 1e-4          # f32: x the plain version's largest magnitude
# phase 10: ALS at Netflix's item count (data/synthetic.py's netflix
# profile: 17,770 items, d 300); users cut from 480,189
ALS_USERS = 20000
ALS_ITEMS = 17770
ALS_RANK = 300
ALS_TRUE_RANK = 16
ALS_DENSITY = 0.05
ALS_SWEEPS = 8
ALS_CAL = 256             # held-out users calibrating the planner
ALS_QUERIES = 1024        # user queries, 16 batches of 64
ALS_RECALL = 0.85
ALS_KERNELS = ("hash_encode", "hamming_scan", "bucket_gather",
               "fused_query", "fused_query_int8", "mips_topk")
# phase 12: the mesh. Qwen3-0.6B at full width on a 1 x 1 card mesh (an
# NCCL world of one), the sequence-sharded combine at its decode layer's
# shape, the dry run's Qwen3 cells, xlstm's train_4k (its time loops
# traced by trip) and the MIPS cell on the pod mesh
MESH_ARCH = "qwen3_0_6b"
MESH_TRAIN_STEPS = 3
MESH_REQUESTS = 8         # (b): requests of 64 prompt + 16 greedy tokens
MESH_PROMPT = 64
MESH_TOKENS = 16
SEQ_SHARDS = 4            # (c): in-process sequence shards
SEQ_B, SEQ_CACHE, SEQ_KV, SEQ_HD, SEQ_H = 8, 32768, 8, 128, 16
SEQ_POS = 20000           # the write slot, in shard 2 of 4
SEQ_ATOL, SEQ_RTOL = 1e-5, 1e-4   # f32, one divide against softmax's
DRYRUN_CELLS = (("qwen3_0_6b", "train_4k"), ("qwen3_0_6b", "prefill_32k"),
                ("qwen3_0_6b", "decode_32k"), ("xlstm_1_3b", "train_4k"))
DRYRUN_TIMEOUT = 600      # s a dry-run cell's process may take
MESH_KERNELS = ("hash_encode", "hamming_scan", "bucket_gather")
MODEL_BATCH = 8           # requests of a generate call
MODEL_PROMPT = 64         # prompt tokens
MODEL_STEPS = 16          # greedy tokens a request
MODEL_MAX_SEQ = 128
MODEL_TOL = 5e-2          # decode vs full forward (tests/test_models.py)
JAMBA_ARCH = "jamba_1_5_large_398b"   # blocks only: ~796 GB of weights
JAMBA_PREFILL, JAMBA_DECODE = 64, 16
MODEL_KERNELS = {"lsh_dense": ("hash_encode", "hamming_scan"),
                 "lsh_bucket": ("hash_encode", "bucket_match",
                                "bucket_gather"),
                 "fused": ("hash_encode", "bucket_match", "fused_query"),
                 "fused_int8": ("hash_encode", "bucket_match",
                                "fused_query_int8"),
                 "exact": ()}
# every stage span of each arm (the reference's names)
ARM_SPANS = {
    "fused": ("repro.engine.query", "repro.engine.hash_encode",
              "repro.engine.directory_match", "repro.engine.fused_query"),
    "bucket": ("repro.engine.query", "repro.engine.hash_encode",
               "repro.engine.directory_match",
               "repro.engine.segmented_gather", "repro.engine.re_rank",
               "repro.engine.top_k"),
    "dense": ("repro.engine.query", "repro.engine.hash_encode",
              "repro.engine.dense_match", "repro.engine.dense_select",
              "repro.engine.re_rank", "repro.engine.top_k"),
}
ARM_SPANS["fused_int8"] = ARM_SPANS["fused"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def timed(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed
    runs after ``warmup`` untimed ones."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_topk(name, ids, vals, ref_ids, ref_vals, queries, rows):
    """Tie-aware top-k agreement: the value sequences agree within the
    tolerance, every returned id scores its returned value (f64 dot), and
    ids are unique per row; ids may differ only where values are tied
    within the tolerance. Returns (max |val diff|, differing slots)."""
    import torch
    if ids.shape != ref_ids.shape:
        fail(f"{name}: shape {tuple(ids.shape)} != {tuple(ref_ids.shape)}")
    if not torch.allclose(vals, ref_vals, atol=ATOL, rtol=RTOL):
        fail(f"{name}: values differ by "
             f"{float((vals - ref_vals).abs().max())}")
    for i, v in ((ids, vals), (ref_ids, ref_vals)):
        ok = i >= 0
        true = torch.einsum("qd,qpd->qp", queries.double(),
                            rows[torch.where(ok, i, 0).long()].double())
        if not torch.allclose(torch.where(ok, true, 0.0),
                              torch.where(ok, v.double(), 0.0),
                              atol=ATOL, rtol=RTOL):
            fail(f"{name}: an id does not score its returned value")
        srt = torch.sort(torch.where(ok, i, -1 - torch.arange(
            i.shape[1], device=i.device)), dim=1).values
        if bool((srt[:, 1:] == srt[:, :-1]).any()):
            fail(f"{name}: an id appears twice in one row")
    return (float((vals - ref_vals).abs().max()),
            int((ids != ref_ids).sum()))


def profiled(run, reps: int = 1):
    """``torch.profiler`` over ``reps`` calls of ``run()``, after a traced
    warm-up call whose events are discarded: a window loses its first few
    launches (the first three kernels of a one-call-each window, in every
    run), and the warm-up absorbs them. Returns (profiler, wall
    microseconds of the ``reps`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
        prof.step()
    return prof, wall_us


def is_range(e) -> bool:
    """A ``record_function`` range: the profiler's step, or a stage span of
    the port (``repro.*``; every span site opens one while the profiler
    records). Its device-side row spans the kernels it holds, so it is no
    device work of its own."""
    return (getattr(e, "is_user_annotation", False) is True
            or e.key.startswith(("ProfilerStep", "repro.")))


def profile_batch(label, run, top: int = 8):
    """Where one query batch (or one kernel call) spends device time: the
    device kernels with the most time under ``torch.profiler``, and the
    device busy share of the wall time (profiler overhead included).
    Returns the profiler."""
    from torch.autograd import DeviceType
    prof, wall_us = profiled(run)

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    # kernel events only: an operator's row repeats its kernels' time, and
    # a range's row (the step's, a stage's) spans the kernels it holds
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not is_range(e)),
                     key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels)
    if busy <= 0:
        print("profile: the profiler recorded no device time "
              "(busy share not measured)")
        return prof
    print(f"profile: {label}: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%)")
    for e in kernels[:top]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")
    return prof


def device_ms(call, reps: int = 20, names=("_kernel",)) -> float | None:
    """Device time (ms) of one ``call()``: for each kernel it launches
    (device events whose name holds one of ``names``), the median over the
    launches ``torch.profiler`` recorded out of ``reps`` calls, summed over
    the kernels; None when it recorded none of one."""
    from torch.autograd import DeviceType
    prof, _ = profiled(call, reps)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = 0.0
    for name in names:
        times = [e.time_range.elapsed_us() for e in events if name in e.name]
        if not times:
            return None
        total += statistics.median(times)
    return total / 1e3


def held_runs(cum, num_probe: int) -> int:
    """Runs over all queries that hold a probe slot below ``num_probe``:
    the (cum, starts) entries a gather must read."""
    return int(((cum[:, 1:] > cum[:, :-1]) & (cum[:, :-1] < num_probe))
               .sum())


def ptxas_report(log: str):
    """(function, registers and shared memory, spills) of each kernel
    function in ``nvcc -Xptxas -v`` output."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line
        elif "Used" in line and "registers" in line and name:
            out.append((name, line.split("info    :")[-1].strip(), spill))
            name, spill = None, ""
    return out


def registry_checks(dev, label, launched=(), card=None):
    """``kernelcheck.run_kernelcheck`` on the card: K1-K5 over the kernel
    registry (the reference's padding probes, kernel against plain
    version, among them) and K1-K3 over the ``launched`` shapes; fatal on
    any finding. With ``card``, prints a row per kernel, shape class and
    variant. Returns the report."""
    from repro_torch.analysis import kernelcheck
    from repro_torch.kernels import _build
    findings, report = kernelcheck.run_kernelcheck(
        device=dev, probes=True, launched=launched,
        build_log=_build.build_log)
    if card is not None:
        for line in kernelcheck.report_lines(report):
            print(f"{line} [{card}]")
    if findings:
        for f in findings:
            print(f.format())
        fail(f"{label}: kernelcheck: {len(findings)} finding(s)")
    return report


def rebuild_candidates(mi, queries, num_probe, engine, match_fn):
    """Oracle: a bucket store rebuilt from scratch over the live set with
    the port's core (``build_buckets``, ``bucket_candidates``,
    ``dense_candidates``), mapped back to global ids."""
    import numpy as np
    import torch
    from repro_torch.core.bucket_index import build_buckets
    from repro_torch.core.engine import bucket_candidates, dense_candidates
    dev = mi.device
    rows = np.flatnonzero(mi._live)
    slots = np.flatnonzero(mi.delta._live[:mi.delta.count])
    codes = np.concatenate([mi._codes[rows], mi.delta._codes[slots]])
    rid = np.concatenate([mi._rid[rows], mi.delta._rid[slots]])
    gids = torch.as_tensor(np.concatenate([rows, mi.store_size + slots]),
                           device=dev)
    ctens = torch.as_tensor(codes.view(np.int32), device=dev)
    rtens = torch.as_tensor(rid, device=dev)
    b = build_buckets(ctens, rtens, torch.as_tensor(mi.upper, device=dev),
                      mi.hash_bits, mi.eps)
    q_codes = mi.encode_queries(queries)
    if engine == "bucket":
        local = bucket_candidates(b, q_codes, num_probe, match_fn=match_fn)
    else:
        local = dense_candidates(b, q_codes, ctens, rtens, num_probe,
                                 match_fn=match_fn)
    return gids[local.long()].to(torch.int32)


def streaming_phase(idx, ops, dev):
    """Phase 3: the streaming service at full size. Returns the launch
    counts of its path, the inputs of its kernels for phase 4 and the
    index (phase 6 drives one more round on it)."""
    import numpy as np
    import torch
    from repro_torch import streaming
    from repro_torch.core import planner
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.streaming.engine import bucket_runs

    traffic = make_dataset("imagenet", SEED + 7, n=ROUNDS * INSERTS, d=DIM,
                           num_queries=ROUNDS * BATCH)
    cal_gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    cal_q = torch.randn((planner.DEFAULT_CAL_QUERIES, DIM),
                        generator=cal_gen, device=dev)
    rng = np.random.default_rng(SEED + 9)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    mi = streaming.MutableIndex.from_composed(idx)

    def calibrate():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mi.set_calibration(planner.calibrate_streaming(mi, cal_q, k=K))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    cal_s = [calibrate()]
    ms = {"insert": [], "delete": [], "query_auto": [], "query_bucket": []}
    structural = {"compaction": [], "repartition": []}
    hits = truth_n = 0

    def timed_op(kind, fn):
        before = (mi.num_compactions, mi.num_repartitions)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ms[kind].append(1e3 * dt)
        if mi.num_compactions > before[0]:
            structural["compaction"].append((kind, dt))
        if mi.num_repartitions > before[1]:
            structural["repartition"].append((kind, dt))
        return out

    for r in range(ROUNDS):
        vecs = traffic.items[r * INSERTS:(r + 1) * INSERTS].clone()
        if r == OVERFLOW_ROUND:
            top = float(mi.upper.max())
            vecs[0] *= OVERFLOW_FACTOR * top / float(vecs[0].norm())
        timed_op("insert", lambda: mi.insert(vecs))
        base = np.flatnonzero(mi._live)
        delta = mi.store_size + np.flatnonzero(
            mi.delta._live[:mi.delta.count])
        victims = np.concatenate([
            rng.choice(base, DELETES // 2, replace=False),
            rng.choice(delta, DELETES // 2, replace=False)])
        timed_op("delete", lambda: mi.delete(victims))
        if mi.calib_stale:
            cal_s.append(calibrate())
        qb = traffic.queries[r * BATCH:(r + 1) * BATCH]
        mi.engine = "auto"
        _, got = timed_op("query_auto", lambda: mi.query(
            qb, K, recall_target=RECALL_TARGET))
        mi.engine = "bucket"
        _, got_b = timed_op("query_bucket", lambda: mi.query(
            qb, K, recall_target=RECALL_TARGET))
        mi.engine = "auto"
        if not torch.equal(got, got_b):
            fail(f"streaming round {r}: bucket and auto query ids differ")
        live_vecs, gids = mi.live_vectors()
        _, tpos = ops.mips_topk(qb, live_vecs, K)
        truth = torch.as_tensor(gids, device=dev)[tpos.long()]
        hits += int((got[:, :, None] == truth[:, None, :]).any(1).sum())
        truth_n += truth.numel()
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    shapes = dict(ops.launch_shapes)
    print(f"launches on the streaming path: "
          f"{ {k: launches[k] for k in STREAM_KERNELS} }")
    idle = [op for op in STREAM_KERNELS if launches[op] == 0]
    if idle:
        fail(f"kernels never launched on the streaming path: {idle}")
    stats = mi.stats()
    width = planner.plan_global(mi.calib, RECALL_TARGET).num_probe
    recall = hits / truth_n
    kinds = [e["kind"] for e in mi.events]
    print(f"stream: {ROUNDS} rounds of {INSERTS} inserts, {DELETES} deletes, "
          f"one {BATCH}-query batch at target {RECALL_TARGET}; live "
          f"{stats['live']}, planned width {width}, recall@{K} {recall:.4f}")
    for kind, vals in ms.items():
        print(f"stream: {kind} median {statistics.median(vals):.3f} ms per "
              f"batch (max {max(vals):.3f} ms)")
    print(f"stream: calibration s {[round(c, 3) for c in cal_s]}, "
          f"compactions {stats['compactions']} "
          f"{[(k, round(d, 3)) for k, d in structural['compaction']]}, "
          f"repartitions {stats['repartitions']} "
          f"{[(k, round(d, 3)) for k, d in structural['repartition']]}, "
          f"events {kinds}")
    if recall < STREAM_RECALL:
        fail(f"streaming recall@{K} {recall:.4f} < {STREAM_RECALL}")
    if "overflow_localized" not in kinds or stats["compactions"] < 1:
        fail(f"streaming traffic missed its structural events: {kinds}")
    profile_batch(f"streaming (auto arm) batch of {BATCH}", lambda: mi.query(
        traffic.queries[:BATCH], K, recall_target=RECALL_TARGET), top=12)

    # the kernels' inputs at this state, for phase 4; the bucket arm's
    # gather runs as its recall-target query builds them
    qb = traffic.queries[:BATCH]
    live_vecs, _ = mi.live_vectors()
    q_codes = mi.encode_queries(qb)
    n_csr = mi.num_csr_items
    probe_base = min(n_csr, min(width, n_csr + mi.delta.capacity)
                     + mi.max_tombstones)
    _, g_cum, g_starts = bucket_runs(mi._arrs(), q_codes, probe_base,
                                     mi.hash_bits, "auto")
    inputs = dict(q_codes=q_codes, queries=qb,
                  bucket_code=mi.buckets.bucket_code.clone(),
                  csr_codes=mi.csr_codes.clone(),
                  d_codes=mi.delta.codes.clone(), d_live=mi.delta.live.clone(),
                  live_vecs=live_vecs, hash_bits=mi.hash_bits,
                  gather_cum=g_cum, gather_starts=g_starts,
                  probe_base=probe_base)

    # merged candidates against a from-scratch rebuild, both arms
    def match_fn(q_codes, codes):
        return idx.family.match_counts(idx.params, q_codes, codes,
                                       mi.hash_bits)
    for engine in ("bucket", "dense"):
        mi.engine = engine
        got = mi.candidates(qb, width)
        want = rebuild_candidates(mi, qb, width, engine, match_fn)
        if not torch.equal(got, want):
            fail(f"streaming {engine} candidates differ from a rebuild "
                 f"({int((got != want).sum())} slots)")
    mi.engine = "auto"
    before = mi.candidates(qb, width)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mi.compact()
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    if not torch.equal(before, mi.candidates(qb, width)):
        fail("streaming candidates changed across compact()")
    print(f"stream: candidates equal a from-scratch rebuild (bucket and "
          f"dense, width {width}) and are unchanged across compact() "
          f"({t_compact:.3f} s)")
    return launches, shapes, inputs, mi


def truth_ids(ops, queries, items):
    """Exact top-K ids of ``queries`` over ``items`` through ``mips_topk``,
    BATCH queries a launch."""
    import torch
    return torch.cat([ops.mips_topk(queries[s:s + BATCH], items, K)[1]
                      for s in range(0, queries.shape[0], BATCH)])


def in_chunks(call, q: int, rows: int):
    """``call(sl)`` over query slices of ``rows``, outputs concatenated
    along the query axis: a plain version held to a bounded block."""
    import torch
    outs = [call(slice(s, s + rows)) for s in range(0, q, rows)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def planned_runs_case(order, buckets, budgets, dev, **extra):
    """The per-range take's row at a path's probe order and budgets,
    bound by the bytes it must move (its analytic cost: the order read
    once, the tables once, ``starts`` and ``cum`` written once)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.obs.cost import planned_runs_cost
    caps = torch.tensor(budgets, dtype=torch.int32, device=dev)
    q, b = order.shape

    def check(got, want):
        for label, g, w in zip(("cum", "starts"), got, want):
            if not torch.equal(g, w):
                fail(f"planned_runs: {label} differs from the plain "
                     f"version's at {tuple(order.shape)} "
                     f"({int((g != w).sum())} entries)")
        return 0.0, 0
    return dict(
        call=lambda impl: ops.planned_runs(order, buckets.bucket_start,
                                           buckets.bucket_rid, caps,
                                           impl=impl),
        bytes=int(planned_runs_cost(q, b, len(budgets))["hbm_bytes"]),
        ops=0,
        kernel="planned_runs", device=("planned_runs_kernel",), check=check,
        source="src/repro_torch/kernels/csrc/bucket_gather.cu",
        replaces="none: plain jnp in src/repro/core/engine.py "
                 "(range_cum_before, planned_take)", **extra)


def served_cell_phase(ops, dev, card):
    """Phase 4's last rows: the per-range take at the benchmark cell's
    shape (``yahoomusic``, 136,736 x 300 with two clusters of norms,
    RANGE-LSH m 32 at code length 32, 64-query batches at the budgets of
    a seeded plan at recall 0.9). The launch counters are zeroed, 8
    batches are served through the fused engine, and ``planned_runs``
    must have launched once a batch. Returns (launches, shapes, cases)
    and prints the parent's composition (the 32 masked passes, caps copied
    from the host) as the yardstick."""
    import torch
    from repro_torch.core import planner
    from repro_torch.core.engine import (_directory_order, check_budgets,
                                         engine_for)
    from repro_torch.core.index import IndexSpec, build
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import ref
    ds = make_dataset("yahoomusic", SEED, n=CELL_ITEMS, d=CELL_DIM,
                      num_queries=CELL_BATCHES * BATCH, device=dev)
    spec = IndexSpec(family="simple", code_len=32, m=32, scheme="percentile",
                     engine="fused", recall_target=RECALL_TARGET)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    idx = build(dataclasses.replace(spec, recall_target=None), ds.items, gen,
                device=dev)
    idx = idx._replace(spec=spec, calib=planner.calibrate(idx,
                                                          generator=gen))
    eng = engine_for(idx, engine="fused")
    budgets, total = check_budgets(planner.resolve_budgets(
        idx.calib, RECALL_TARGET, k=K).budgets, eng._range_counts)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for s in range(0, CELL_BATCHES * BATCH, BATCH):
        eng.query(ds.queries[s:s + BATCH], K, budgets=budgets)
    torch.cuda.synchronize()
    launches, shapes = dict(ops.launch_counts), dict(ops.launch_shapes)
    if launches["planned_runs"] != CELL_BATCHES:
        fail(f"cell: planned_runs launched {launches['planned_runs']} "
             f"times for {CELL_BATCHES} budgeted batches")
    qb = ds.queries[:BATCH]
    order = _directory_order(eng.buckets, eng._encode(qb), eng._match_fn)
    bs, br = eng.buckets.bucket_start, eng.buckets.bucket_rid
    y_ms = timed(lambda: ref.planned_runs_ref(order, bs, br, budgets),
                 warmup=1)
    print(f"yardstick: planned_runs_cell: the parent's composition (the "
          f"{len(budgets)} masked passes of range_cum_before, the take, "
          f"the exclusive cumsum; caps from the host) {y_ms:.4f} ms at "
          f"{tuple(order.shape)}, width {total}; launches "
          f"{launches['planned_runs']} in {CELL_BATCHES} batches [{card}]")
    return launches, shapes, {"planned_runs_cell": planned_runs_case(
        order, eng.buckets, budgets, dev, path="cell")}


def run_cases(name, queries, cum, starts, items_csr, total, kp, dev):
    """Phase-4 cases of the gather and the fused query at one planned
    arm's shapes; the plain fused query runs a few queries at a time so
    its (Q, total, d) block stays within 4 GiB."""
    import torch
    from repro_torch.kernels import ops
    q, d = queries.shape
    runs = held_runs(cum, total)
    takes = cum[:, -1].clamp(max=total)
    slots = int(takes.sum())
    surv = int(takes.clamp(max=kp).sum())
    probed = ops.bucket_gather(cum, starts, total, impl="ref")
    live = torch.arange(total, device=dev)[None] < takes[:, None]
    hit = torch.zeros(items_csr.shape[0], dtype=torch.bool, device=dev)
    hit[probed[live].long()] = True
    rows = int(hit.sum())
    del probed, live, hit
    chunk = max(1, (4 << 30) // (4 * total * d))

    def fused(impl):
        if impl != "ref":
            return ops.fused_query(queries, cum, starts, items_csr, total, K,
                                   impl=impl)
        return in_chunks(lambda sl: ops.fused_query(
            queries[sl], cum[sl], starts[sl], items_csr, total, K,
            impl="ref"), q, chunk)
    return {
        f"bucket_gather_{name}": dict(
            call=lambda impl: ops.bucket_gather(cum, starts, total,
                                                impl=impl),
            bytes=4 * (2 * runs + q * total), ops=2 * slots,
            kernel="bucket_gather", path="alsh", plain_reps=3,
            source="src/repro_torch/kernels/csrc/bucket_gather.cu",
            replaces="src/repro/kernels/bucket_probe.py:124"),
        f"fused_query_{name}": dict(
            call=fused, kernel="fused_query", path="alsh", plain_reps=3,
            bytes=4 * q * d + 8 * runs + 8 * q * K + rows * (4 * d + 4),
            ops=2 * (slots + surv) * d,
            check=lambda got, want: check_topk(
                f"fused_query_{name}", got[1], got[0], want[1], want[0],
                queries, items_csr),
            source="src/repro_torch/kernels/csrc/fused_query.cu",
            replaces="src/repro/kernels/fused_query.py:156"),
    }


def check_alsh_codes(fidx, items, queries):
    """The card's codes of an ALSH index and of a query batch against the
    paper's transform and hash recomputed here in f64 (not through the
    port's functions): a code may differ only inside the band an f32
    product can move it across, a sign bit where ``|P(x).a| < 1e-5
    ||P(x)|| ||a||``, an L2 hash where ``(P(x).a + b)/r`` lies within
    ``1e-5 (1 + |.|)`` of an integer. Returns (codes held, codes that
    differ inside the band)."""
    import torch
    fam, L = fidx.family, fidx.hash_bits
    sign = fam.packed
    if sign:                                        # SIGN-ALSH: P(x).a >= 0
        A, b = fidx.params.double(), None
    else:                                           # L2-ALSH: floor((.+b)/r)
        A, b = fidx.params.a.double(), fidx.params.b.double()
    a_norm = A.norm(dim=0)

    def held(aug, codes):
        proj = aug @ A
        if sign:
            want = proj >= 0
            band = proj.abs() < 1e-5 * aug.norm(dim=1, keepdim=True) * a_norm
            words = codes.long() & 0xFFFFFFFF
            got = ((words[:, :, None] >> torch.arange(
                32, device=codes.device)) & 1).reshape(codes.shape[0], -1)
            got = got[:, :L].bool()
        else:
            v = (proj + b) / fam.r
            want = torch.floor(v)
            band = (v - torch.round(v)).abs() < 1e-5 * (1.0 + v.abs())
            got = codes.double()
        diff = got != want
        return int(diff.numel()), int(diff.sum()), int((diff & ~band).sum())

    totals = [0, 0, 0]
    scale = fam.U / fidx.upper_eff.double()[fidx.range_id.long()]
    rows = 1 << 18
    for s in range(0, items.shape[0], rows):
        x = items[s:s + rows].double() * scale[s:s + rows, None]
        powers, acc = [], (x * x).sum(1)            # ||Ux||^2, ^4, ..., ^2^m
        for _ in range(fam.m):
            powers.append(acc)
            acc = acc * acc
        tail = torch.stack(powers, 1)
        aug = torch.cat([x, 0.5 - tail if sign else tail], 1)
        for i, v in enumerate(held(aug, fidx.codes[s:s + rows])):
            totals[i] += v
    qn = queries.double() / queries.double().norm(dim=1, keepdim=True)
    aug = torch.cat([qn, torch.full((qn.shape[0], fam.m),
                                    0.0 if sign else 0.5, dtype=qn.dtype,
                                    device=qn.device)], 1)
    for i, v in enumerate(held(aug, fam.encode_queries(fidx.params,
                                                       queries))):
        totals[i] += v
    held_n, differ, outside = totals
    if outside:
        fail(f"{fam.name}: {outside} of {held_n} card codes differ from the "
             f"f64 transform and hash outside the f32 band")
    return held_n, differ


def alsh_phase(ds, idx, bucket_eng, ops, dev, card):
    """Phase 5: the SIGN-ALSH and L2-ALSH families, adaptive early
    termination, multi-table single-probe, the paper's Fig. 2 and one
    SIGN-ALSH streaming round, at N_ITEMS and DIM. The launch counts are
    copied right after the path's last call, before any check that calls
    a kernel (the adaptive comparison, the rebuild, the code check) and
    before the kernel cases' inputs are built. Returns the path's launch
    counts and shapes and the phase-4 cases of the kernels at the shapes
    it gave them."""
    import numpy as np
    import torch
    from repro_torch import streaming
    from repro_torch.core import planner, topk
    from repro_torch.core.engine import (QueryEngine, _directory_order,
                                         _planned_runs)
    from repro_torch.core.hashing import (scalar_over,
                                          sign_alsh_item_transform)
    from repro_torch.core.index import IndexSpec, build
    from repro_torch.data.synthetic import make_dataset

    qs, items = ds.queries, ds.items
    traffic = make_dataset("imagenet", SEED + 51, n=INSERTS, d=DIM,
                           num_queries=BATCH)
    rng = np.random.default_rng(SEED + 50)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    truth = truth_ids(ops, qs, items)                      # (Q, K) int32

    # -- the two ALSH families, built, calibrated, queried ------------------
    fams = {}
    for s_, fam in enumerate(("sign_alsh", "l2_alsh")):
        gen = torch.Generator(device=dev).manual_seed(SEED + 20 + s_)
        spec = IndexSpec(family=fam, code_len=32, m=32, engine="bucket",
                         recall_target=RECALL_TARGET)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fidx = build(dataclasses.replace(spec, recall_target=None), items,
                     gen)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        bucket = QueryEngine(fidx, engine="bucket")
        torch.cuda.synchronize()
        t_store = time.perf_counter() - t0 - t_build
        t0 = time.perf_counter()
        fidx = fidx._replace(spec=spec, calib=planner.calibrate(
            fidx, generator=gen, buckets=bucket.buckets))
        torch.cuda.synchronize()
        t_cal = time.perf_counter() - t0
        fused = QueryEngine(fidx, engine="fused", buckets=bucket.buckets)
        plan = planner.resolve_budgets(fidx.calib, RECALL_TARGET, k=K)
        ms = {"bucket": [], "fused": []}
        hits = {"bucket": 0, "fused": 0}
        swaps = 0
        for s in range(0, NUM_QUERIES, BATCH):
            qb = qs[s:s + BATCH]
            out = {}
            for arm, eng in (("bucket", bucket), ("fused", fused)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[arm] = eng.query(qb, K, budgets=plan.budgets)
                torch.cuda.synchronize()
                ms[arm].append(1e3 * (time.perf_counter() - t0))
                hits[arm] += int((out[arm][1][:, :, None]
                                  == truth[s:s + BATCH, None, :]).any(1)
                                 .sum())
            swaps += check_topk(f"{fam} fused vs bucket", out["fused"][1],
                                out["fused"][0], out["bucket"][1],
                                out["bucket"][0], qb, items)[1]
        print(f"alsh: {fam} index {t_build:.3f} s, bucket store "
              f"B={bucket.buckets.num_buckets} {t_store:.3f} s, "
              f"calibration ({planner.DEFAULT_CAL_QUERIES} queries) "
              f"{t_cal:.3f} s; planned width {plan.num_probe} "
              f"(predicted {plan.predicted_recall:.4f}) [{card}]")
        for arm in ms:
            rec = hits[arm] / truth.numel()
            print(f"alsh: {fam} {arm:6s} recall@{K} {rec:.4f} median "
                  f"{statistics.median(ms[arm]):.3f} ms/batch of {BATCH} "
                  f"(first {ms[arm][0]:.3f} ms) [{card}]")
            if rec < ALSH_RECALL:
                fail(f"{fam} {arm} recall@{K} {rec:.4f} < {ALSH_RECALL}")
        print(f"alsh: {fam} fused vs bucket ids differ in {swaps} tied "
              f"slots")
        fams[fam] = dict(index=fidx, bucket=bucket, fused=fused, plan=plan)

    # -- adaptive early termination on the slice-1 RANGE-LSH engine ---------
    adaptive = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, ADAPTIVE_QUERIES, BATCH):
        adaptive.append(planner.adaptive_query(
            bucket_eng, qs[s:s + BATCH], K, recall_target=RECALL_TARGET))
    torch.cuda.synchronize()
    t_ad = time.perf_counter() - t0

    # -- multi-table single-probe --------------------------------------------
    mspec = IndexSpec(family="simple", code_len=16, m=32, num_tables=4,
                      engine="dense")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mt = build(mspec, items, torch.Generator(device=dev).manual_seed(
        SEED + 30))
    torch.cuda.synchronize()
    t_mt = time.perf_counter() - t0
    qb = qs[:BATCH]
    t0 = time.perf_counter()
    mv, mi_, mn = mt.query(qb, K)
    torch.cuda.synchronize()
    t_mq = time.perf_counter() - t0

    # -- the paper's Fig. 2 at code length 32 ---------------------------------
    fig = {"simple_lsh_m1": IndexSpec(family="simple", code_len=32),
           "range_lsh_m32": None,
           "range_lsh_m64": IndexSpec(family="simple", code_len=32,
                                      m=FIG2_M),
           "l2_alsh_m1": IndexSpec(family="l2_alsh", code_len=32),
           "sign_alsh_m32": None}
    probes = [max(K, int(N_ITEMS * f)) for f in FIG2_FRACTIONS]
    curves = {}
    for s_, (name, fspec) in enumerate(fig.items()):
        if fspec is None:
            fidx = (idx if name == "range_lsh_m32"
                    else fams["sign_alsh"]["index"])
        else:
            fidx = build(fspec, items, torch.Generator(device=dev)
                         .manual_seed(SEED + 40 + s_))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pos = torch.cat([topk.truth_positions(
            fidx.probe_order(qs[s:s + BATCH]), truth[s:s + BATCH])
            for s in range(0, NUM_QUERIES, BATCH)])
        torch.cuda.synchronize()
        t_ord = time.perf_counter() - t0
        rec = topk.recall_from_positions(pos, probes)
        srt = torch.sort(pos.reshape(-1)).values
        need = int(srt[-(-srt.numel() // 2) - 1]) + 1   # recall 0.5
        curves[name] = need
        print(f"fig2: {name:14s} recall@{K} at 0.5%/2%/10% of N "
              f"{float(rec[0]):.4f} {float(rec[1]):.4f} "
              f"{float(rec[2]):.4f}; probes for recall 0.5: {need}; "
              f"{NUM_QUERIES} probe orders {t_ord:.3f} s [{card}]")
    del fidx
    for m_ in ("range_lsh_m32", "range_lsh_m64"):
        print(f"fig2: SIMPLE-LSH / {m_} probes for recall 0.5: "
              f"{curves['simple_lsh_m1'] / max(curves[m_], 1):.2f}")

    # -- one SIGN-ALSH streaming round -----------------------------------------
    sidx = fams["sign_alsh"]["index"]
    mi = streaming.MutableIndex.from_composed(sidx)
    t0 = time.perf_counter()
    mi.insert(traffic.items[:INSERTS])
    base = np.flatnonzero(mi._live)
    dslots = mi.store_size + np.flatnonzero(mi.delta._live[:mi.delta.count])
    mi.delete(np.concatenate([rng.choice(base, DELETES // 2, replace=False),
                              rng.choice(dslots, DELETES // 2,
                                         replace=False)]))
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t0
    sq_b = traffic.queries[:BATCH]
    width = min(fams["sign_alsh"]["plan"].num_probe, mi.live_count)
    got = {}
    for engine in ("auto", "bucket"):
        mi.engine = engine
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[engine] = mi.query(sq_b, K, width)
        torch.cuda.synchronize()
        print(f"stream5: sign_alsh {engine:6s} query at width {width} "
              f"{1e3 * (time.perf_counter() - t0):.3f} ms [{card}]")

    # the path ends here: its launches, before any check calls a kernel
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    shapes = dict(ops.launch_shapes)
    print(f"launches on the phase-5 path: "
          f"{ {k: launches[k] for k in ALSH_KERNELS} }")
    idle = [op for op in ALSH_KERNELS if launches[op] == 0]
    if idle:
        fail(f"kernels never launched on the phase-5 path: {idle}")

    # -- the phase's checks ------------------------------------------------------
    for fam, f in fams.items():
        n_held, n_diff = check_alsh_codes(f["index"], items, qs[:BATCH])
        print(f"alsh: {fam} card codes ({n_held} item and query codes) "
              f"equal the f64 transform and hash but {n_diff}, all inside "
              f"the f32 band")
    used, diff = [], 0
    for s, (av, ai, au) in zip(range(0, ADAPTIVE_QUERIES, BATCH), adaptive):
        qb = qs[s:s + BATCH]
        fv, fi = bucket_eng.query(qb, K, recall_target=RECALL_TARGET)
        diff += check_topk("adaptive vs planned re-rank", ai, av, fi, fv,
                           qb, items)[1]
        used.append(au)
    used = torch.cat(used).double()
    a_width = planner.resolve_budgets(idx.calib, RECALL_TARGET,
                                      k=K).num_probe
    print(f"adaptive: target {RECALL_TARGET}, {ADAPTIVE_QUERIES} queries: "
          f"probes_used mean {float(used.mean()):.1f} std "
          f"{float(used.std()):.1f} min {int(used.min())} max "
          f"{int(used.max())} of planned width {a_width} (saves "
          f"{100 * (1 - float(used.mean()) / a_width):.2f}%); (vals, ids) "
          f"equal the planned re-rank ({diff} tied slots differ); "
          f"{t_ad:.3f} s [{card}]")
    qb = qs[:BATCH]
    rv, ri, rn = mt._replace(spec=dataclasses.replace(
        mspec, impl="ref")).query(qb, K)
    if not (torch.equal(mi_, ri) and torch.equal(mn, rn)):
        fail("multi-table ids or candidate counts differ from impl='ref'")
    mrec = float((mi_[:, :, None] == truth[:BATCH, None, :]).any(1)
                 .double().mean())
    print(f"multitable: 4 tables x 16 bits, m=32: build {t_mt:.3f} s, "
          f"{BATCH} queries {1e3 * t_mq:.3f} ms; n_cand mean "
          f"{float(mn.double().mean()):.1f} min {int(mn.min())} max "
          f"{int(mn.max())}; recall@{K} {mrec:.4f}; ids equal impl='ref' "
          f"[{card}]")
    del mt
    if not torch.equal(got["auto"][1], got["bucket"][1]):
        fail("sign_alsh streaming: auto and bucket query ids differ")

    def match_fn(q_codes, codes):
        return sidx.family.match_counts(sidx.params, q_codes, codes,
                                        mi.hash_bits)
    for engine in ("bucket", "dense"):
        mi.engine = engine
        if not torch.equal(mi.candidates(sq_b, width), rebuild_candidates(
                mi, sq_b, width, engine, match_fn)):
            fail(f"sign_alsh streaming {engine} candidates differ from a "
                 f"rebuild")
    print(f"stream5: sign_alsh {INSERTS} inserts + {DELETES} deletes "
          f"{1e3 * t_write:.3f} ms; candidates equal a rebuild (bucket and "
          f"dense, width {width}) [{card}]")

    # -- the kernels' inputs at the shapes the path gave them -----------------
    cases = {}
    qb = qs[:BATCH]
    for fam, f in fams.items():
        fidx, bucket, fused, plan = (f["index"], f["bucket"], f["fused"],
                                     f["plan"])
        q_codes = fused._encode(qb)
        order = _directory_order(bucket.buckets, q_codes, fused._match_fn)
        cum, starts = _planned_runs(bucket.buckets, order, plan.budgets)
        kp = max(K, min(max(4 * K, 32), plan.num_probe))
        cases.update(run_cases(fam, qb, cum, starts, fused._fused_arrays[0],
                               plan.num_probe, kp, dev))
        if fam == "sign_alsh":
            # the item encode's input: P(x) of d + m = 152 columns
            W, n = fidx.codes.shape[1], fidx.codes.shape[0]
            x = items * scalar_over(fidx.family.U, fidx.upper_eff[
                fidx.range_id.long()])[:, None]
            px = sign_alsh_item_transform(x, fidx.family.m, 1.0)
            A, dd, L = fidx.params, px.shape[1], fidx.hash_bits
            bcodes = bucket.buckets.bucket_code
            nb = bcodes.shape[0]
            cases["hash_encode_sign_alsh"] = dict(
                call=lambda impl: ops.hash_encode(px, A, impl=impl),
                bytes=4 * (n * dd + dd * L + n * W),
                ops=2 * n * dd * L, op_rate=PEAK_OPS_NO_FMA,
                kernel="hash_encode", path="alsh",
                source="src/repro_torch/kernels/csrc/hash_encode.cu",
                replaces="src/repro/kernels/hash_encode.py:83")
            cases["hamming_scan_sign_alsh"] = dict(
                call=lambda impl, q_=q_codes: ops.hamming_scan(
                    q_, bcodes, impl=impl),
                bytes=4 * (BATCH * W + nb * W + BATCH * nb),
                ops=2 * BATCH * nb * W, kernel="hamming_scan", path="alsh",
                source="src/repro_torch/kernels/csrc/hamming.cu",
                replaces="src/repro/kernels/hamming.py:46")
    del fams

    # the streaming round's and the truth's kernels at their shapes
    sq = mi.encode_queries(sq_b)
    hb, W = mi.hash_bits, sq.shape[1]
    bc = mi.buckets.bucket_code.clone()
    dc, dlive = mi.delta.codes.clone(), mi.delta.live.clone()
    nb, cap = bc.shape[0], dc.shape[0]
    cases["bucket_match_sign_alsh"] = dict(
        call=lambda impl: ops.bucket_match(sq, bc, hb, impl=impl),
        bytes=4 * (BATCH * W + nb * W + BATCH * nb),
        ops=2 * BATCH * nb * W + BATCH * nb, kernel="bucket_match",
        path="alsh", source="src/repro_torch/kernels/csrc/hamming.cu",
        replaces="src/repro/kernels/bucket_probe.py:70")
    cases["delta_scan_sign_alsh"] = dict(
        call=lambda impl: ops.delta_scan(sq, dc, dlive, hb, impl=impl),
        bytes=4 * (BATCH * W + cap * W + BATCH * cap) + cap,
        ops=2 * BATCH * cap * W + 2 * BATCH * cap, kernel="delta_scan",
        path="alsh", source="src/repro_torch/kernels/csrc/hamming.cu",
        replaces="src/repro/kernels/delta_scan.py:58")
    qt = qs[:BATCH]
    cases["mips_topk_truth"] = dict(
        call=lambda impl: ops.mips_topk(qt, items, K, impl=impl),
        bytes=4 * (BATCH * DIM + N_ITEMS * DIM + 2 * BATCH * K),
        ops=2 * BATCH * N_ITEMS * DIM, kernel="mips_topk", path="alsh",
        library=lambda: torch.topk(qt @ items.T, K),
        check=lambda got, want: check_topk("mips_topk_truth", got[1],
                                           got[0], want[1], want[0], qt,
                                           items),
        source="src/repro_torch/kernels/csrc/mips_topk.cu",
        replaces="src/repro/kernels/mips_topk.py:93")
    del mi
    return launches, shapes, cases


def obs_phase(ds, idx, arms, budgets, mi, ops, dev, card):
    """Phase 6: observability through the main path and streaming, and
    the legacy index shims, at N_ITEMS and DIM. The path: each arm of
    phase 2 as a fresh tracked engine over ``OBS_BATCHES`` batches; one
    tracked streaming round on phase 3's index; the SIMPLE-LSH and
    RANGE-LSH shims built, their bucket balance, a RANGE-LSH bucket-engine
    query; the SIGN-ALSH and L2-ALSH shims built and queried densely; a
    multi-table shim. The launch counts are copied right after, before
    any comparison (untracked batches, spec-API indexes) or case input.
    Returns the path's launch counts and shapes and the phase-4 case of
    the legacy directory match."""
    import numpy as np
    import torch
    from repro_torch.core import (l2_alsh, multi_table, planner, range_lsh,
                                  sign_alsh, simple_lsh)
    from repro_torch.core.bucket_index import build_bucket_index
    from repro_torch.core.engine import QueryEngine, encode_queries
    from repro_torch.core.index import IndexSpec, build
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.obs import (RingBufferSink, Tracker,
                                 chrome_trace_events, validate_chrome_trace)

    qs, items = ds.queries, ds.items
    batches = [qs[s:s + BATCH] for s in range(0, OBS_BATCHES * BATCH, BATCH)]
    traffic = make_dataset("imagenet", SEED + 61, n=INSERTS, d=DIM,
                           num_queries=BATCH)
    rng = np.random.default_rng(SEED + 60)
    num_probe = int(N_ITEMS * LEGACY_PROBE)
    torch.cuda.synchronize()
    ops.reset_launch_counts()

    # -- tracked engines over the main path --------------------------------
    tracked = {}
    for arm, bare in arms.items():
        tr = Tracker([RingBufferSink(capacity=1 << 16)])
        eng = QueryEngine(idx, engine=bare.engine, quantized=bare.quantized,
                          buckets=bare.buckets, tracker=tr)
        torch.cuda.synchronize()
        before = dict(ops.launch_counts)
        ops.set_dispatch_tracker(tr)
        outs, ms = [], []
        try:
            for qb in batches:
                t0 = time.perf_counter()
                outs.append(eng.query(qb, K, budgets=budgets))
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
        finally:
            ops.set_dispatch_tracker(None)
        delta = {k: v - before[k] for k, v in ops.launch_counts.items()}
        tracked[arm] = dict(tracker=tr, outs=outs, ms=ms, launched=delta)

    # -- one tracked streaming round on phase 3's index ---------------------
    width = planner.plan_global(mi.calib, RECALL_TARGET).num_probe
    str_tr = Tracker([RingBufferSink(capacity=1 << 16)])
    mi.set_tracker(str_tr)
    n_events = len(mi.events)
    mi.insert(traffic.items[:INSERTS])
    base = np.flatnonzero(mi._live)
    dslots = mi.store_size + np.flatnonzero(mi.delta._live[:mi.delta.count])
    mi.delete(np.concatenate([rng.choice(base, DELETES // 2, replace=False),
                              rng.choice(dslots, DELETES // 2,
                                         replace=False)]))
    mi.compact()                 # a structural event for the tracker
    sq = traffic.queries[:BATCH]
    str_out = {}
    for engine in ("auto", "bucket"):
        mi.engine = engine
        str_out[engine] = mi.query(sq, K, width)
    mi.stats()
    mi.set_tracker(None)

    # -- the legacy shims ---------------------------------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sl = simple_lsh.build(items, torch.Generator(device=dev).manual_seed(
        SEED + 62), 32)
    rl = range_lsh.build(items, torch.Generator(device=dev).manual_seed(
        SEED + 63), 32, LEGACY_M)
    torch.cuda.synchronize()
    t_legacy = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = {"simple_lsh": simple_lsh.bucket_stats(sl),
             f"range_lsh_m{LEGACY_M}": range_lsh.bucket_stats(rl)}
    t_stats = time.perf_counter() - t0
    del sl
    t0 = time.perf_counter()
    rl_buckets = build_bucket_index(rl)
    torch.cuda.synchronize()
    t_store = time.perf_counter() - t0
    qb = qs[:BATCH]
    t0 = time.perf_counter()
    rl_out = range_lsh.query(rl, qb, K, num_probe, engine="bucket",
                             buckets=rl_buckets)
    torch.cuda.synchronize()
    t_rq = time.perf_counter() - t0
    alsh = {}
    for s_, (name, mod) in enumerate((("sign_alsh", sign_alsh),
                                      ("l2_alsh", l2_alsh))):
        lidx = mod.build(items, torch.Generator(device=dev).manual_seed(
            SEED + 64 + s_), 32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alsh[name] = (lidx, mod.query(lidx, qb, K, num_probe))
        torch.cuda.synchronize()
        print(f"legacy: {name} dense query of {BATCH} at num_probe "
              f"{num_probe}: {1e3 * (time.perf_counter() - t0):.3f} ms "
              f"[{card}]")
    mt = multi_table.build(items, torch.Generator(device=dev).manual_seed(
        SEED + 66), 16, 4, num_ranges=32)
    mt_out = multi_table.query(mt, qb, K)

    # the path ends here: its launches, before any comparison
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    shapes = dict(ops.launch_shapes)
    print(f"launches on the phase-6 path: "
          f"{ {k: launches[k] for k in OBS_KERNELS} }")
    idle = [op for op in OBS_KERNELS if launches[op] == 0]
    if idle:
        fail(f"kernels never launched on the phase-6 path: {idle}")

    # -- the tracked arms' checks -------------------------------------------
    for arm, rec in tracked.items():
        tr, bare = rec["tracker"], arms[arm]
        bare_ms = []
        for qb_, (v, i) in zip(batches, rec["outs"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bv, bi = bare.query(qb_, K, budgets=budgets)
            torch.cuda.synchronize()
            bare_ms.append(1e3 * (time.perf_counter() - t0))
            if not (torch.equal(v, bv) and torch.equal(i, bi)):
                fail(f"obs: tracked {arm} batch differs from the bare one")
        missing = set(ARM_SPANS[arm]) - set(tr.hists)
        if missing:
            fail(f"obs: {arm} recorded no span of {sorted(missing)}")
        n_q = tr.counters.get("repro.engine.queries")
        if n_q != OBS_BATCHES * BATCH:
            fail(f"obs: {arm} counted {n_q} queries, not "
                 f"{OBS_BATCHES * BATCH}")
        launched = dict(rec["launched"])
        launched["fused_query"] += launched.pop("fused_query_int8")
        counted = {op: int(tr.counters.get(
            f"repro.kernels.dispatch.{op}.cuda", 0)) for op in launched}
        refs = sorted(k for k in tr.counters if k.endswith(".ref"))
        if counted != launched or refs:
            fail(f"obs: {arm} dispatch counts {counted} != launches "
                 f"{launched} (ref dispatches {refs})")
        # p50 is a log-bucket midpoint (within 3.4%); the mean is exact
        p50 = ", ".join(f"{n.split('.')[-1]} "
                        f"{1e3 * tr.hists[n].quantile(0.5):.3f}/"
                        f"{1e3 * tr.hists[n].mean:.3f}"
                        for n in ARM_SPANS[arm])
        t_ms, b_ms = statistics.median(rec["ms"]), statistics.median(bare_ms)
        print(f"obs: {arm:10s} span p50/mean ms: {p50} [{card}]")
        print(f"obs: {arm:10s} tracked {t_ms:.3f} ms/batch vs bare "
              f"{b_ms:.3f} (ratio {t_ms / b_ms:.4f}); ids and values "
              f"equal; dispatch .cuda == launches "
              f"{ {k: v for k, v in counted.items() if v} }")
    # the fused arm's last batch as a Chrome trace
    spans = tracked["fused"]["tracker"].sinks[0].query(type="span")
    last = max(r["t0"] for r in spans if r["name"] == "repro.engine.query")
    events = chrome_trace_events([r for r in spans if r["t0"] >= last])
    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    n_pairs = validate_chrome_trace(trace)["span_pairs"]
    TRACE_DIR.mkdir(exist_ok=True)
    path = TRACE_DIR / "obs_fused_batch_trace.json"
    path.write_text(json.dumps(trace))
    print(f"obs: Chrome trace of one fused batch: {len(events)} events "
          f"({n_pairs} spans) in {path}")
    del tracked

    # -- the streaming round's checks ---------------------------------------
    round_events = mi.events[n_events:]
    mirrored = [e for e in str_tr.events
                if e["name"] != "repro.streaming.drift.snapshot"]
    if [e["name"] for e in mirrored] != [f"repro.streaming.{e['kind']}"
                                         for e in round_events]:
        fail(f"obs: streaming events {[e['name'] for e in mirrored]} do not "
             f"mirror {round_events}")
    drift = [g for g in str_tr.gauges
             if g.startswith("repro.streaming.drift.count.")]
    if not round_events or not drift or not any(
            e["name"] == "repro.streaming.drift.snapshot"
            for e in str_tr.events):
        fail("obs: the drift gauges and snapshot did not arrive")
    c = str_tr.counters
    if (c.get("repro.streaming.inserts"), c.get("repro.streaming.deletes"),
            c.get("repro.streaming.queries")) != (INSERTS, DELETES,
                                                  2 * BATCH):
        fail(f"obs: streaming counters {c}")
    for engine, (v, i) in str_out.items():
        mi.engine = engine
        if not torch.equal(i, mi.query(sq, K, width)[1]):
            fail(f"obs: tracked streaming {engine} ids differ from untracked")
    mi.engine = "auto"
    print(f"obs: streaming round: {INSERTS} inserts, {DELETES} deletes, "
          f"auto and bucket at width {width}: events "
          f"{[e['name'] for e in str_tr.events]}, {len(drift)} drift count "
          f"gauges, query span p50/mean "
          f"{1e3 * str_tr.hists['repro.streaming.query'].quantile(0.5):.3f}/"
          f"{1e3 * str_tr.hists['repro.streaming.query'].mean:.3f} ms; ids "
          f"equal untracked [{card}]")

    # -- the legacy shims' checks -------------------------------------------
    for name, (nb, big) in stats.items():
        print(f"legacy: {name} L 32 bucket_stats: {nb} occupied buckets, "
              f"largest {big} items (N {N_ITEMS}) [{card}]")
    print(f"legacy: builds {t_legacy:.3f} s, bucket_stats {t_stats:.3f} s; "
          f"RANGE-LSH m {LEGACY_M} bucket store B={rl_buckets.num_buckets} "
          f"{t_store:.3f} s, bucket query of {BATCH} at num_probe "
          f"{num_probe} {1e3 * t_rq:.3f} ms [{card}]")
    cidx = build(IndexSpec(family="simple", code_len=32, m=LEGACY_M,
                           engine="bucket"), items, params=rl.A)
    if not torch.equal(cidx.codes, rl.codes):
        fail("legacy: RANGE-LSH shim codes differ from the spec API's")
    if not torch.equal(cidx.query(qb, K, num_probe)[1], rl_out[1]):
        fail("legacy: RANGE-LSH bucket query ids differ from the spec API's")
    del cidx
    for name, (lidx, (_, li)) in alsh.items():
        params = lidx.A if name == "sign_alsh" else (lidx.a, lidx.b)
        cidx = build(IndexSpec(family=name, code_len=32), items,
                     params=params)
        if not torch.equal(cidx.query(qb, K, num_probe)[1].to(li.dtype), li):
            fail(f"legacy: {name} dense query ids differ from the spec API's")
        del cidx
    cmt = build(IndexSpec(family="simple", code_len=16, m=32, num_tables=4),
                items, params=list(mt.As))
    if not all(torch.equal(a, b) for a, b in zip(cmt.query(qb, K), mt_out)):
        fail("legacy: multi_table shim differs from ComposedMultiTable")
    print(f"legacy: RANGE-LSH bucket, SIGN-ALSH and L2-ALSH dense ids equal "
          f"the spec API's; multi_table equals ComposedMultiTable (n_cand "
          f"mean {float(mt_out[2].double().mean()):.1f})")
    del cmt, mt, alsh

    # -- the legacy directory match at the shape the path gave it -----------
    q_codes = encode_queries(rl, qb)
    bcodes, hb = rl_buckets.bucket_code, rl_buckets.hash_bits
    nb, W = bcodes.shape[0], q_codes.shape[1]
    cases = {"bucket_match_legacy": dict(
        call=lambda impl: ops.bucket_match(q_codes, bcodes, hb, impl=impl),
        bytes=4 * (BATCH * W + nb * W + BATCH * nb),
        ops=2 * BATCH * nb * W + BATCH * nb, kernel="bucket_match",
        path="obs", ceiling=(BATCH, nb),
        source="src/repro_torch/kernels/csrc/hamming.cu",
        replaces="src/repro/kernels/bucket_probe.py:70")}
    return launches, shapes, cases


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dist_slice1(ds, idx, budgets, group):
    """The distributed engine over slice 1's index (phase 2's hash
    parameters and calibration) on ``group``: both arms, the planned
    budgets at target 0.9 and ``recall_target``, ``DIST_BATCHES`` batches.
    Returns the per-arm (ids, ms) and the sharded index's shape."""
    import torch
    from repro_torch.core import distributed
    spec = dataclasses.replace(idx.spec, recall_target=None)
    sidx = distributed.build_sharded(spec, ds.items, None, group.size,
                                     params=idx.params,
                                     device=ds.items.device)
    sidx = distributed.shard_index(sidx._replace(calib=idx.calib), group)
    out = {}
    for arm in ("bucket", "dense"):
        eng = distributed.DistributedEngine(sidx, group, engine=arm)
        ids, ms = [], []
        for b in range(DIST_BATCHES):
            qb = ds.queries[b * BATCH:(b + 1) * BATCH]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, i = eng.query(qb, K, budgets=budgets)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            _, i2 = eng.query(qb, K, recall_target=RECALL_TARGET)
            ids.append((i, i2))
        out[arm] = (ids, ms)
    return out, (sidx.num_shards, sidx.rows_per_shard, sidx.num_buckets)


def serve_phase(ds, idx, budgets, arms, ops, dev, card):
    """Phase 7: LSH-decode serving of Qwen3-0.6B at full width (random
    bf16 weights from a seed) through every head of ``BatchedServer``, the
    head's recall contract, and the distributed engine over slice 1's
    index. The launch counters and a dispatch tracker are zeroed just
    before the path and read right after its last call, before any check
    or case input. Returns the path's launch counts and shapes and the
    kernel cases at the shapes the path gave them, and the exact head's
    decode-step p50 (ms)."""
    import numpy as np
    import torch
    import torch.distributed as tdist
    from repro_torch.configs.base import get_config
    from repro_torch.core import distributed, hashing
    from repro_torch.core.bucket_index import build_bucket_index
    from repro_torch.core.engine import _probe_runs, encode_queries
    from repro_torch.launch import serve
    from repro_torch.models import lm, lm_head
    from repro_torch.obs import RingBufferSink, Tracker

    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    t0 = time.perf_counter()
    params = lm.init_params(gen, cfg, device=dev)
    # vocab-padding rows are never real tokens: zero, as a checkpoint's
    # padding would be, so that no head can pick one
    params["embed"][cfg.vocab:] = 0
    unembed = lm._unembed_matrix(params, cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        params))
    print(f"serve: {cfg.name} d={cfg.d_model} layers={cfg.n_layers} "
          f"heads={cfg.n_heads}/{cfg.n_kv} head_dim={cfg.resolved_head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} (padded {cfg.padded_vocab}), "
          f"{n_params} bf16/f32 params drawn in "
          f"{time.perf_counter() - t0:.2f} s")

    def prompts(n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, cfg.vocab, (n, SERVE_PROMPT), generator=g,
                             device=dev)

    reqs = prompts(SERVE_BATCH, SEED + 71)
    cal_prompts = prompts(SERVE_CAL, SEED + 72)
    fresh_prompts = prompts(SERVE_CAL, SEED + 73)
    stream_rows = torch.randn((SERVE_INSERTS, cfg.d_model), device=dev,
                              generator=torch.Generator(device=dev)
                              .manual_seed(SEED + 74)) * 0.05
    V = cfg.padded_vocab
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                             f"{free_port()}", rank=0, world_size=1)
    nccl = distributed.ProcessShardGroup()

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    dispatch = Tracker([RingBufferSink(capacity=1 << 10)])
    ops.set_dispatch_tracker(dispatch)
    results = {}
    try:
        t0 = time.perf_counter()
        vidx = lm_head.build_vocab_index(unembed, gen)
        torch.cuda.synchronize()
        t_vocab = time.perf_counter() - t0
        sharded = {}
        for label, S in (("sharded_nccl", 1), ("sharded_4", 4)):
            t0 = time.perf_counter()
            sharded[label] = serve.build_sharded_vocab_index(
                unembed, gen, num_shards=S, true_vocab=cfg.vocab)
            torch.cuda.synchronize()
            print(f"serve: {label} index ({S} shard(s), code_len 64, 16 "
                  f"ranges) {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        streaming = serve.build_streaming_vocab_index(unembed, gen)
        torch.cuda.synchronize()
        print(f"serve: vocab index (code_len 128, 64 ranges, "
              f"{vidx.hash_bits} hash bits) {t_vocab:.3f} s; streaming "
              f"index {time.perf_counter() - t0:.2f} s")
        heads = {
            "exact": dict(),
            "lsh_dense_1024": dict(lsh_decode=True, vocab_index=vidx,
                                   num_probe=lm_head.DEFAULT_NUM_PROBE),
            "lsh_dense": dict(lsh_decode=True, vocab_index=vidx,
                              num_probe=V),
            "lsh_bucket": dict(lsh_decode=True, vocab_index=vidx,
                               num_probe=V, engine="bucket"),
            "fused": dict(lsh_decode=True, vocab_index=vidx, num_probe=V,
                          engine="fused"),
            "fused_int8": dict(lsh_decode=True, vocab_index=vidx,
                               num_probe=V, engine="fused", quantized=True),
            "sharded_nccl": dict(sharded_index=sharded["sharded_nccl"],
                                 shard_group=nccl, num_probe=V),
            "sharded_4": dict(sharded_index=sharded["sharded_4"],
                              num_probe=V),
            "streaming": dict(streaming_index=streaming, num_probe=V),
        }
        servers = {}
        for name, kw in heads.items():
            tr = Tracker([RingBufferSink(capacity=1 << 12)])
            servers[name] = serve.BatchedServer(
                cfg, params, max_seq=SERVE_MAX_SEQ, batch=SERVE_BATCH,
                tracker=tr, device=dev, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = servers[name].generate(reqs, SERVE_STEPS)
            torch.cuda.synchronize()
            results[name] = dict(tokens=toks, tracker=tr,
                                 wall=time.perf_counter() - t0)
        # catalog mutations on the streaming head, then a second call
        st_server = servers["streaming"]
        first = results["streaming"]["tokens"]
        banned = sorted({int(v) for v in first[:, :2].reshape(-1)})
        extra = [int(v) for v in torch.randperm(
            cfg.vocab, generator=torch.Generator().manual_seed(SEED + 75))
            if int(v) not in banned][:SERVE_DELETES - len(banned)]
        deleted = banned + extra
        st_server.delete_tokens(deleted)
        new_ids = st_server.insert_tokens(
            stream_rows, np.arange(SERVE_INSERTS) + 7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        after = st_server.generate(reqs, SERVE_STEPS)
        torch.cuda.synchronize()
        t_after = time.perf_counter() - t0
        # the head's recall contract: a planner fitted on held-out prefill
        # states, then checked on fresh ones
        t0 = time.perf_counter()
        cal_h = torch.cat([lm.prefill(params, cal_prompts[s:s + 64], cfg)[0]
                           for s in range(0, SERVE_CAL, 64)])
        calib = lm_head.calibrate_vocab_index(vidx, unembed, cal_h)
        torch.cuda.synchronize()
        t_cal = time.perf_counter() - t0
        vcal = vidx._replace(calib=calib)
        fresh_h = torch.cat([lm.prefill(params, fresh_prompts[s:s + 64],
                                        cfg)[0]
                             for s in range(0, SERVE_CAL, 64)])
        _, lsh_ids = lm_head.lsh_topk_tokens(vcal, fresh_h, unembed, k=1,
                                             recall_target=RECALL_TARGET)
        tr = Tracker([RingBufferSink(capacity=1 << 12)])
        servers["recall_0.9"] = serve.BatchedServer(
            cfg, params, max_seq=SERVE_MAX_SEQ, lsh_decode=True,
            vocab_index=vcal, recall_target=RECALL_TARGET, tracker=tr,
            device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = servers["recall_0.9"].generate(reqs, SERVE_STEPS)
        torch.cuda.synchronize()
        results["recall_0.9"] = dict(tokens=toks, tracker=tr,
                                     wall=time.perf_counter() - t0)
        # the distributed engine over slice 1's index
        dist_out = {}
        for label, group in (("in-process x4",
                              distributed.InProcessShardGroup(DIST_SHARDS)),
                             ("nccl x1", nccl)):
            dist_out[label] = dist_slice1(ds, idx, budgets, group)
        torch.cuda.synchronize()
    finally:
        ops.set_dispatch_tracker(None)
    launches = dict(ops.launch_counts)
    shapes = dict(ops.launch_shapes)
    print(f"launches on the phase-7 path: "
          f"{ {k: launches[k] for k in SERVE_KERNELS} }")
    idle = [op for op in SERVE_KERNELS if launches[op] == 0]
    if idle:
        fail(f"kernels never launched on the phase-7 path: {idle}")
    counted = {op: int(dispatch.counters.get(
        f"repro.kernels.dispatch.{op}.cuda", 0)) for op in ops.OPS}
    launched = {op: launches[op] for op in ops.OPS}
    launched["fused_query"] += launches["fused_query_int8"]
    refs = sorted(k for k in dispatch.counters if k.endswith(".ref"))
    if counted != launched or refs:
        fail(f"serve: dispatch counts {counted} != launches {launched} "
             f"(ref dispatches {refs})")
    print(f"serve: dispatch .cuda == launches for every op, no .ref "
          f"dispatch")

    # -- the phase's checks ------------------------------------------------
    exact = results["exact"]["tokens"]
    for name, rec in results.items():
        toks, tr = rec["tokens"], rec["tracker"]
        if toks.shape != (SERVE_BATCH, SERVE_STEPS) or bool(
                (toks < 0).any() | (toks >= cfg.padded_vocab).any()):
            fail(f"serve: {name} tokens out of shape or range")
        full = name not in ("exact", "lsh_dense_1024", "recall_0.9")
        agree = float((toks == exact).float().mean())
        if full and not torch.equal(toks, exact):
            fail(f"serve: {name} at num_probe = V differs from the exact "
                 f"head in {int((toks != exact).sum())} tokens")
        missing = [n for n in SERVE_SPANS if n not in tr.hists]
        if missing:
            fail(f"serve: {name} recorded no span {missing}")
        p50 = {n.split(".")[-1]: 1e3 * tr.hists[n].quantile(0.5)
               for n in SERVE_SPANS}
        tok_s = SERVE_BATCH * SERVE_STEPS / rec["wall"]
        print(f"serve: {name:14s} prefill {p50['prefill']:.3f} ms, "
              f"decode_step p50 {p50['decode_step']:.3f} ms, topk_head "
              f"p50 {p50['topk_head']:.3f} ms, {tok_s:.1f} tokens/s "
              f"({SERVE_BATCH} x {SERVE_STEPS} in {rec['wall']:.3f} s), "
              f"agreement with exact {agree:.4f} [{card}]")
    if any(int(v) in set(deleted) for v in after.reshape(-1)):
        fail("serve: a deleted token was generated after delete_tokens")
    print(f"serve: streaming head after {SERVE_INSERTS} inserts (ids "
          f"{int(new_ids[0])}..{int(new_ids[-1])}) and {len(deleted)} "
          f"deletes: no deleted token generated, "
          f"{SERVE_BATCH * SERVE_STEPS / t_after:.1f} tokens/s")
    _, exact_ids = lm_head.exact_topk_tokens(fresh_h, unembed, 1)
    recall = float((lsh_ids[:, 0] == exact_ids[:, 0]).float().mean())
    width = servers["recall_0.9"].num_probe
    print(f"serve: recall target {RECALL_TARGET}: planned num_probe "
          f"{width} of {V}, recall@1 {recall:.4f} on {SERVE_CAL} fresh "
          f"prefill states (calibration {t_cal:.2f} s on {SERVE_CAL})")
    if recall < SERVE_RECALL:
        fail(f"serve: recall@1 {recall:.4f} < {SERVE_RECALL}")
    for label, (out, shape) in dist_out.items():
        for arm, (ids, ms) in out.items():
            for b, (i_budget, i_target) in enumerate(ids):
                qb = ds.queries[b * BATCH:(b + 1) * BATCH]
                _, want = arms[arm].query(qb, K, budgets=budgets)
                if not (torch.equal(i_budget, want)
                        and torch.equal(i_target, want)):
                    fail(f"dist {label} {arm}: ids differ from QueryEngine "
                         f"in batch {b}")
            print(f"dist: {label} (shards, rows, buckets) {shape} {arm}: "
                  f"ids equal QueryEngine's, budgets and target 0.9, "
                  f"{statistics.median(ms):.1f} ms/batch of {BATCH} "
                  f"[{card}]")
    tdist.destroy_process_group()
    # where a step's time goes: the model's decode step (exact head) and
    # the fused head's query, one call each under the profiler
    pf_h, pf_c = lm.prefill(params, reqs, cfg)
    caches = lm.extend_cache(cfg, pf_c, SERVE_MAX_SEQ)
    profile_batch("decode step with the exact head, batch of "
                  f"{SERVE_BATCH}", lambda: servers["exact"].decode_fn(
                      params, exact[:, 0], caches, SERVE_PROMPT), top=8)
    profile_batch("fused f32 head at num_probe = V, batch of "
                  f"{SERVE_BATCH}", lambda: servers["fused"]._fused_eng.query(
                      pf_h.to(torch.float32), 1, V), top=6)
    del caches, pf_c
    print(f"serve: phase 7 path and checks {time.perf_counter() - t_phase:.1f} "
          f"s (kernel rows follow)")

    # -- the kernels' inputs at the shapes the path gave them ---------------
    d, L, W = cfg.d_model, vidx.hash_bits, vidx.codes.shape[1]
    items = unembed.T.to(torch.float32).contiguous()
    # the build's encode input: rows over their range's effective bound
    upper = vidx.upper
    upper_eff = torch.where(
        torch.bincount(vidx.range_id.long(), minlength=upper.shape[0]) > 0,
        upper, upper.max())
    xv = items / upper_eff[vidx.range_id.long()][:, None]
    tail = torch.sqrt(torch.clamp_min(1.0 - torch.sum(xv * xv, -1), 0.0))
    A, a_tail = vidx.A[:-1], vidx.A[-1]
    hidden = fresh_h[:SERVE_BATCH].to(torch.float32)
    qn = hashing.normalize(hidden)
    zeros = torch.zeros((SERVE_BATCH,), device=dev)
    q_codes = encode_queries(vidx, hidden)
    buckets = build_bucket_index(vidx)
    dir_b = buckets.num_buckets
    match = ops.bucket_match(q_codes, buckets.bucket_code, L)
    order = torch.argsort(buckets.rank[buckets.bucket_rid[None, :].long(),
                                       match.long()], dim=-1, stable=True)
    cum, starts = _probe_runs(buckets, order, V)
    runs = held_runs(cum, V)
    fused_eng = servers["fused"]._fused_eng
    f_order = torch.argsort(fused_eng.buckets.rank[
        fused_eng.buckets.bucket_rid[None, :].long(),
        ops.bucket_match(q_codes, fused_eng.buckets.bucket_code,
                         L).long()], dim=-1, stable=True)
    f_cum, f_starts = _probe_runs(fused_eng.buckets, f_order, V)
    f_runs = held_runs(f_cum, V)
    items_csr = fused_eng._fused_arrays[0]
    payload, scale = servers["fused_int8"]._fused_eng._fused_arrays[1:]
    kp = 32
    st_idx = servers["streaming"].streaming_index
    s_codes = st_idx.encode_queries(hidden)
    s_bits, s_w = st_idx.hash_bits, s_codes.shape[1]
    s_A, s_tail = st_idx.A[:-1], st_idx.A[-1]
    cap = st_idx.delta.codes.shape[0]

    def fused_check(got, want):
        return check_topk("fused_query (serve)", got[1], got[0], want[1],
                          want[0], hidden, items_csr)

    src = "src/repro_torch/kernels/csrc/"
    cases = {
        "hash_encode_vocab": dict(
            call=lambda impl: ops.hash_encode(xv, A, tail, a_tail,
                                              impl=impl),
            bytes=4 * (V * d + d * L + V + L + V * W),
            ops=2 * V * d * L + 2 * V * L, op_rate=PEAK_OPS_NO_FMA,
            device=("hash_encode_tiled",), kernel="hash_encode",
            path="serve", plain_reps=3,
            source=src + "hash_encode.cu",
            replaces="src/repro/kernels/hash_encode.py:83"),
        "hash_encode_step": dict(
            call=lambda impl: ops.hash_encode(qn, A, zeros, a_tail,
                                              impl=impl),
            bytes=4 * (SERVE_BATCH * d + d * L + SERVE_BATCH + L
                       + SERVE_BATCH * W),
            ops=2 * SERVE_BATCH * d * L + 2 * SERVE_BATCH * L,
            op_rate=PEAK_OPS_NO_FMA, device=("hash_encode_tiled",),
            kernel="hash_encode", path="serve",
            probe_of="hash_encode_vocab",
            source=src + "hash_encode.cu",
            replaces="src/repro/kernels/hash_encode.py:83"),
        # the streaming and sharded heads' encode (L 60, W 2) at the
        # streaming build's shape, on the vocab build's rows
        "hash_encode_vocab_w2": dict(
            call=lambda impl: ops.hash_encode(xv, s_A, tail, s_tail,
                                              impl=impl),
            bytes=4 * (V * d + d * s_bits + V + s_bits + V * s_w),
            ops=2 * V * d * s_bits + 2 * V * s_bits,
            op_rate=PEAK_OPS_NO_FMA, device=("hash_encode_tiled",),
            kernel="hash_encode", path="serve", plain_reps=3,
            source=src + "hash_encode.cu",
            replaces="src/repro/kernels/hash_encode.py:83"),
        "hamming_scan_vocab": dict(
            call=lambda impl: ops.hamming_scan(q_codes, vidx.codes,
                                               impl=impl),
            bytes=4 * (SERVE_BATCH * W + V * W + SERVE_BATCH * V),
            ops=2 * SERVE_BATCH * V * W, ceiling=(SERVE_BATCH, V),
            kernel="hamming_scan", path="serve",
            source=src + "hamming.cu",
            replaces="src/repro/kernels/hamming.py:46"),
        "bucket_match_vocab": dict(
            call=lambda impl: ops.bucket_match(q_codes, buckets.bucket_code,
                                               L, impl=impl),
            bytes=4 * (SERVE_BATCH * W + dir_b * W + SERVE_BATCH * dir_b),
            ops=2 * SERVE_BATCH * dir_b * W + SERVE_BATCH * dir_b,
            ceiling=(SERVE_BATCH, dir_b), kernel="bucket_match",
            path="serve", source=src + "hamming.cu",
            replaces="src/repro/kernels/bucket_probe.py:70"),
        "bucket_gather_vocab": dict(
            call=lambda impl: ops.bucket_gather(cum, starts, V, impl=impl),
            bytes=4 * (2 * runs + SERVE_BATCH * V),
            ops=2 * SERVE_BATCH * V, ceiling=(SERVE_BATCH, V),
            device=("bucket_gather_kernel",), kernel="bucket_gather",
            path="serve", source=src + "bucket_gather.cu",
            replaces="src/repro/kernels/bucket_probe.py:124"),
        "fused_query_vocab": dict(
            call=lambda impl: ops.fused_query(hidden, f_cum, f_starts,
                                              items_csr, V, 1, impl=impl),
            bytes=4 * SERVE_BATCH * d + 8 * f_runs + V * (4 * d + 4),
            ops=2 * (SERVE_BATCH * V + SERVE_BATCH * kp) * d,
            check=fused_check, kernel="fused_query", path="serve",
            source=src + "fused_query.cu",
            replaces="src/repro/kernels/fused_query.py:156", cold=True),
        "fused_query_int8_vocab": dict(
            call=lambda impl: ops.fused_query(
                hidden, f_cum, f_starts, items_csr, V, 1, payload=payload,
                scale=scale, impl=impl),
            bytes=(4 * SERVE_BATCH * d + 8 * f_runs + V * (d + 4)
                   + SERVE_BATCH * kp * 4 * d),
            ops=2 * (SERVE_BATCH * V + SERVE_BATCH * kp) * d,
            check=fused_check, kernel="fused_query_int8",
            path="serve", source=src + "fused_query.cu",
            replaces="src/repro/kernels/fused_query.py:156", cold=True),
        "delta_scan_vocab": dict(
            call=lambda impl: ops.delta_scan(s_codes, st_idx.delta.codes,
                                             st_idx.delta.live, s_bits,
                                             impl=impl),
            bytes=4 * (SERVE_BATCH * s_w + cap * s_w + SERVE_BATCH * cap)
            + cap,
            ops=2 * SERVE_BATCH * cap * s_w + 2 * SERVE_BATCH * cap,
            ceiling=(SERVE_BATCH, cap), kernel="delta_scan", path="serve",
            source=src + "hamming.cu",
            replaces="src/repro/kernels/delta_scan.py:58"),
    }
    decode_ms = 1e3 * results["exact"]["tracker"].hists[
        "repro.serve.decode_step"].quantile(0.5)
    return launches, shapes, cases, decode_ms


def model_cfg(arch, layers):
    """The published config, its depth cut to ``layers`` when given."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def model_params(cfg, seed, dev):
    """Seeded bf16 weights on the card, the vocabulary's padding rows
    zero (as a checkpoint's padding would be, so that no head picks one);
    returns (params, count of parameters)."""
    import torch
    from repro_torch.models import lm
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_params(gen, cfg, device=dev)
    params["embed"][cfg.vocab:] = 0
    if "unembed" in params:
        params["unembed"][:, cfg.vocab:] = 0
    torch.cuda.synchronize()
    return params, sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        params))


def vocab_cases(label, cfg, vidx, unembed, hidden, engines, dev,
                hamming=False):
    """The kernel cases a model's heads give at its vocabulary: the
    index build's encode (V x d x 122, the decode step's 8-row encode
    inside its row), and where asked the dense head's scan and the fused
    builds (``engines``: the fused heads' query engines) at num_probe =
    V."""
    import torch
    from repro_torch.core.engine import _probe_runs, encode_queries
    from repro_torch.kernels import ops
    from repro_torch.core import hashing
    V, d = cfg.padded_vocab, cfg.d_model
    L, W = vidx.hash_bits, vidx.codes.shape[1]
    B = hidden.shape[0]
    items = unembed.T.to(torch.float32).contiguous()
    upper = vidx.upper
    upper_eff = torch.where(
        torch.bincount(vidx.range_id.long(), minlength=upper.shape[0]) > 0,
        upper, upper.max())
    xv = items / upper_eff[vidx.range_id.long()][:, None]
    del items
    tail = torch.sqrt(torch.clamp_min(1.0 - torch.sum(xv * xv, -1), 0.0))
    A, a_tail = vidx.A[:-1], vidx.A[-1]
    qn = hashing.normalize(hidden)
    zeros = torch.zeros((B,), device=dev)
    path = f"model_{label}"
    src = "src/repro_torch/kernels/csrc/"
    cases = {
        f"hash_encode_vocab_{label}": dict(
            call=lambda impl: ops.hash_encode(xv, A, tail, a_tail,
                                              impl=impl),
            bytes=4 * (V * d + d * L + V + L + V * W),
            ops=2 * V * d * L + 2 * V * L, op_rate=PEAK_OPS_NO_FMA,
            device=("hash_encode_tiled",), kernel="hash_encode",
            path=path, plain_reps=3, source=src + "hash_encode.cu",
            replaces="src/repro/kernels/hash_encode.py:83"),
        f"hash_encode_step_{label}": dict(
            call=lambda impl: ops.hash_encode(qn, A, zeros, a_tail,
                                              impl=impl),
            bytes=4 * (B * d + d * L + B + L + B * W),
            ops=2 * B * d * L + 2 * B * L, op_rate=PEAK_OPS_NO_FMA,
            device=("hash_encode_tiled",), kernel="hash_encode", path=path,
            probe_of=f"hash_encode_vocab_{label}",
            source=src + "hash_encode.cu",
            replaces="src/repro/kernels/hash_encode.py:83"),
    }
    q_codes = encode_queries(vidx, hidden)
    if hamming:
        cases[f"hamming_scan_vocab_{label}"] = dict(
            call=lambda impl: ops.hamming_scan(q_codes, vidx.codes,
                                               impl=impl),
            bytes=4 * (B * W + V * W + B * V), ops=2 * B * V * W,
            ceiling=(B, V), kernel="hamming_scan", path=path,
            source=src + "hamming.cu",
            replaces="src/repro/kernels/hamming.py:46")
    kp = 32
    for eng in engines.values():
        order = torch.argsort(eng.buckets.rank[
            eng.buckets.bucket_rid[None, :].long(),
            ops.bucket_match(q_codes, eng.buckets.bucket_code, L).long()],
            dim=-1, stable=True)
        f_cum, f_starts = _probe_runs(eng.buckets, order, V)
        f_runs = held_runs(f_cum, V)
        items_csr, payload, scale = eng._fused_arrays
        extra = ({} if payload is None
                 else dict(payload=payload, scale=scale))
        chunk = max(1, (4 << 30) // (4 * V * d))

        def call(impl, f_cum=f_cum, f_starts=f_starts, items_csr=items_csr,
                 extra=extra):
            if impl != "ref":
                return ops.fused_query(hidden, f_cum, f_starts, items_csr,
                                       V, 1, impl=impl, **extra)
            # the plain version a few queries at a time: its (Q, V, d)
            # block stays within 4 GiB
            return in_chunks(lambda sl: ops.fused_query(
                hidden[sl], f_cum[sl], f_starts[sl], items_csr, V, 1,
                impl="ref", **extra), B, chunk)
        row_bytes = (V * (4 * d + 4) if payload is None
                     else V * (d + 4) + B * kp * 4 * d)
        kernel = "fused_query" if payload is None else "fused_query_int8"
        cases[f"{kernel}_vocab_{label}"] = dict(
            call=call, bytes=4 * B * d + 8 * f_runs + row_bytes,
            ops=2 * (B * V + B * kp) * d, kernel=kernel, path=path,
            plain_reps=3,
            check=lambda got, want, items_csr=items_csr, kernel=kernel:
            check_topk(f"{kernel} ({label})", got[1], got[0], want[1],
                       want[0], hidden, items_csr),
            source=src + "fused_query.cu",
            replaces="src/repro/kernels/fused_query.py:156", cold=True)
    return cases


def teacher_forced(params, cfg, reqs, toks):
    """prefill -> extend_cache -> decode steps fed ``toks``, and one full
    forward over the prompt and the same tokens. Returns (prefill's last
    hidden, the decode steps' hiddens (B, T, d), the full forward's
    hiddens at the same positions (B, T + 1, d), from the prompt's last)."""
    import torch
    from repro_torch.models import lm
    h0, caches = lm.prefill(params, reqs, cfg)
    caches = lm.extend_cache(cfg, caches, MODEL_MAX_SEQ)
    hs = []
    for t in range(toks.shape[1]):
        h, caches = lm.decode_step(params, toks[:, t], caches,
                                   reqs.shape[1] + t, cfg,
                                   logits_mode="none")
        hs.append(h)
    del caches
    seq = torch.cat([reqs, toks], dim=1)
    full, _, _ = lm.backbone_forward(
        params, lm._embed(params, seq, cfg),
        torch.arange(seq.shape[1], device=seq.device), cfg)
    return h0, torch.stack(hs, 1), full[:, reqs.shape[1] - 1:]


def serve_one_model(arch, layers, heads, rows, seed, ops, dev, card):
    """One config of phase 8 at full width: its weights, vocab index and
    servers, then the path (every head's ``generate``; internvl2's patch
    prefill and decode; whisper's encoder, cross K/V and decode loop)
    between zeroed and copied launch counters, then the checks. Returns
    the path's launches and shapes and its kernel cases."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import encdec, lm, lm_head
    from repro_torch.obs import RingBufferSink, Tracker

    t_model = time.perf_counter()
    cfg = model_cfg(arch, layers)
    params, n_params = model_params(cfg, seed, dev)
    unembed = lm._unembed_matrix(params, cfg)
    V = cfg.padded_vocab
    label = arch.split("_")[0]
    depth = (f"{cfg.n_layers} of {model_cfg(arch, None).n_layers} layers"
             if layers else f"{cfg.n_layers} layers")
    print(f"model: {cfg.name} d={cfg.d_model} {depth} vocab={cfg.vocab} "
          f"(padded {V}), {n_params} bf16/f32 params, drawn in "
          f"{time.perf_counter() - t_model:.2f} s; heads {', '.join(heads)}")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    reqs = torch.randint(0, cfg.vocab, (MODEL_BATCH, MODEL_PROMPT),
                         generator=g, device=dev)
    hidden_seen = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    dispatch = Tracker([RingBufferSink(capacity=1 << 10)])
    ops.set_dispatch_tracker(dispatch)
    results = {}
    try:
        t0 = time.perf_counter()
        vidx = lm_head.build_vocab_index(unembed, g)
        torch.cuda.synchronize()
        t_vocab = time.perf_counter() - t0
        kws = {"exact": dict(),
               "lsh_dense": dict(lsh_decode=True, vocab_index=vidx,
                                 num_probe=V),
               "lsh_bucket": dict(lsh_decode=True, vocab_index=vidx,
                                  num_probe=V, engine="bucket"),
               "fused": dict(lsh_decode=True, vocab_index=vidx, num_probe=V,
                             engine="fused"),
               "fused_int8": dict(lsh_decode=True, vocab_index=vidx,
                                  num_probe=V, engine="fused",
                                  quantized=True)}
        servers = {}
        for name in heads:
            tr = Tracker([RingBufferSink(capacity=1 << 12)])
            servers[name] = serve.BatchedServer(
                cfg, params, max_seq=MODEL_MAX_SEQ, batch=MODEL_BATCH,
                tracker=tr, device=dev, **kws[name])
            results[name] = dict(tracker=tr)
        if cfg.is_encoder_decoder:
            # the reference's serving path for whisper: encoder, cross
            # K/V, decode steps, the head on the hidden state
            frames = 0.1 * torch.randn(
                (MODEL_BATCH, cfg.encoder_frames, cfg.d_model),
                generator=g, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = encdec.encoder_forward(params["encoder"], frames, cfg)
            caches = encdec.init_cache(cfg, MODEL_BATCH, MODEL_MAX_SEQ,
                                       device=dev)
            caches["cross_k"], caches["cross_v"] = encdec.cross_kv(
                params["layers"], enc, cfg)
            torch.cuda.synchronize()
            t_enc = time.perf_counter() - t0
            hidden_seen.append(enc)
            tok = reqs[:, 0]
            toks = {n: [] for n in heads}
            step_ms = []
            t_loop = time.perf_counter()
            for t in range(MODEL_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h, caches = lm.decode_step(params, tok, caches, t, cfg,
                                           logits_mode="none")
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                hidden_seen.append(h)
                for n in heads:
                    toks[n].append(servers[n]._head_token(h, unembed))
                tok = toks["exact"][-1]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_loop
            for n in heads:
                results[n].update(tokens=torch.stack(toks[n], 1), wall=wall)
            last_hidden = h.to(torch.float32)
            del caches, enc, frames
        else:
            for name in heads:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = servers[name].generate(reqs, MODEL_STEPS)
                torch.cuda.synchronize()
                results[name].update(tokens=out,
                                     wall=time.perf_counter() - t0)
            if cfg.num_patches:
                # patch embeddings prepended, then decode from the padded
                # cache at positions 320+ through the exact and dense heads
                patches = torch.randn((MODEL_BATCH, cfg.num_patches,
                                       cfg.d_model), generator=g,
                                      device=dev)
                h, caches = lm.prefill(params, reqs, cfg, patches)
                caches = lm.extend_cache(
                    cfg, caches, cfg.num_patches + MODEL_PROMPT
                    + MODEL_STEPS)
                hidden_seen.append(h)
                p_toks = {n: [servers[n]._head_token(h, unembed)]
                          for n in ("exact", "lsh_dense")}
                for t in range(MODEL_STEPS - 1):
                    h, caches = lm.decode_step(
                        params, p_toks["exact"][-1], caches,
                        cfg.num_patches + MODEL_PROMPT + t, cfg,
                        logits_mode="none")
                    hidden_seen.append(h)
                    for n in p_toks:
                        p_toks[n].append(servers[n]._head_token(h, unembed))
                del caches, patches
        torch.cuda.synchronize()
    finally:
        ops.set_dispatch_tracker(None)
    launches = dict(ops.launch_counts)
    shapes = dict(ops.launch_shapes)
    want = sorted({k for n in heads for k in MODEL_KERNELS[n]})
    print(f"launches on the phase-8 {label} path: "
          f"{ {k: launches[k] for k in want} }")
    idle = [op for op in want if launches[op] == 0]
    if idle:
        fail(f"model {label}: kernels never launched on its path: {idle}")
    counted = {op: int(dispatch.counters.get(
        f"repro.kernels.dispatch.{op}.cuda", 0)) for op in ops.OPS}
    launched = {op: launches[op] for op in ops.OPS}
    launched["fused_query"] += launches["fused_query_int8"]
    refs = sorted(k for k in dispatch.counters if k.endswith(".ref"))
    if counted != launched or refs:
        fail(f"model {label}: dispatch counts {counted} != launches "
             f"{launched} (ref dispatches {refs})")

    # -- the model's checks ------------------------------------------------
    exact = results["exact"]["tokens"]
    for name, rec in results.items():
        toks = rec["tokens"]
        if toks.shape != (MODEL_BATCH, MODEL_STEPS) or bool(
                (toks < 0).any() | (toks >= cfg.vocab).any()):
            fail(f"model {label}: {name} tokens out of shape or range")
        if name != "exact" and not torch.equal(toks, exact):
            fail(f"model {label}: {name} at num_probe = V differs from the "
                 f"exact head in {int((toks != exact).sum())} tokens")
        tr = rec["tracker"]
        p50 = {n.split(".")[-1]: 1e3 * tr.hists[n].quantile(0.5)
               for n in SERVE_SPANS if n in tr.hists}
        if cfg.is_encoder_decoder:
            p50.update(prefill=1e3 * t_enc,
                       decode_step=statistics.median(step_ms))
        tok_s = MODEL_BATCH * MODEL_STEPS / rec["wall"]
        print(f"model: {label} {name:10s} prefill {p50['prefill']:.3f} ms, "
              f"decode_step p50 {p50['decode_step']:.3f} ms, topk_head p50 "
              f"{p50['topk_head']:.3f} ms, {tok_s:.1f} tokens/s "
              f"({MODEL_BATCH} x {MODEL_STEPS} in {rec['wall']:.3f} s) "
              f"[{card}]")
    if cfg.num_patches:
        if not torch.equal(torch.stack(p_toks["lsh_dense"], 1),
                           torch.stack(p_toks["exact"], 1)):
            fail(f"model {label}: the dense head after the patch prefill "
                 f"differs from the exact head")
        print(f"model: {label} prefill with {cfg.num_patches} patches, "
              f"{MODEL_STEPS - 1} steps from position "
              f"{cfg.num_patches + MODEL_PROMPT}: dense head at V == exact")
    if not cfg.is_encoder_decoder:
        # decode continues prefill: teacher-forced on the exact tokens
        h0, h_dec, h_full = teacher_forced(params, cfg, reqs,
                                           exact[:, :MODEL_STEPS - 1])
        hidden_seen += [h0, h_dec, h_full]
        last_hidden = h0.to(torch.float32)
        if cfg.moe is None:
            # in bf16 the roundings of the decode's and the forward's
            # products (other shapes, other cuBLAS kernels) compound
            # through 24-62 random-weight layers: measured, no limit. The
            # check runs on f32 copies of the same weights
            bf16_err = float((h_dec.float() - h_full[:, 1:].float())
                             .abs().max())
            p32 = torch.utils._pytree.tree_map(lambda t: t.float(), params)
            f0, f_dec, f_full = teacher_forced(p32, cfg, reqs,
                                               exact[:, :MODEL_STEPS - 1])
            del p32
            err = float((f_dec - f_full[:, 1:]).abs().max())
            ok = torch.allclose(f_dec, f_full[:, 1:], atol=MODEL_TOL,
                                rtol=MODEL_TOL) and \
                torch.allclose(f0, f_full[:, 0], atol=MODEL_TOL,
                               rtol=MODEL_TOL)
            if not ok:
                fail(f"model {label}: f32 decode hidden states differ from "
                     f"a full forward (max |diff| {err})")
            print(f"model: {label} decode == full forward at positions "
                  f"{MODEL_PROMPT - 1}..{MODEL_PROMPT + MODEL_STEPS - 2} "
                  f"within {MODEL_TOL} on f32 weights (max |diff| "
                  f"{err:.2e}); bf16 max |diff| {bf16_err:.4f} (no limit)")
    if not all(bool(torch.isfinite(h).all()) for h in hidden_seen):
        fail(f"model {label}: a hidden state is not finite")
    print(f"model: {label} vocab index {t_vocab:.3f} s; path and checks "
          f"{time.perf_counter() - t_model:.1f} s")

    # -- the kernels' inputs at the shapes the path gave them -------------
    # (the model's layers are freed first: only the vocabulary stays)
    engines = {n: servers[n]._fused_eng for n in rows if n in FUSED_HEADS}
    del params, servers, hidden_seen
    cases = vocab_cases(label, cfg, vidx, unembed, last_hidden, engines,
                        dev, hamming="lsh_dense" in rows)
    return launches, shapes, cases


def jamba_blocks(seed, dev, card):
    """Jamba at full width, blocks only (the model's ~796 GB of bf16
    weights fit no 1 or 4 cards): one Mamba layer (prefill 64 tokens, 16
    decode steps, held against one forward over all 80) and one MoE layer
    (a prefill batch and a decode group: finite, aux >= 1)."""
    import torch
    from repro_torch.models import moe, ssm
    cfg = model_cfg(JAMBA_ARCH, None)
    g = torch.Generator(device=dev).manual_seed(seed)
    t_phase = time.perf_counter()
    p = ssm.ssm_init(g, cfg)
    n = sum(t.numel() for t in p.values())
    S = JAMBA_PREFILL + JAMBA_DECODE
    x = torch.randn((MODEL_BATCH, S, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, cache = ssm.ssm_forward(p, x[:, :JAMBA_PREFILL], cfg)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    outs, step_ms = [], []
    for t in range(JAMBA_PREFILL, S):
        t0 = time.perf_counter()
        o, cache = ssm.ssm_decode(p, x[:, t], cache, cfg)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        outs.append(o)
    full, fcache = ssm.ssm_forward(p, x, cfg)
    dec = torch.stack(outs, 1)
    if not (torch.isfinite(dec).all() and torch.isfinite(out_p).all()
            and torch.isfinite(cache.h).all()):
        fail("jamba: a Mamba output or state is not finite")
    err = float((dec.float() - full[:, JAMBA_PREFILL:].float()).abs().max())
    herr = float((cache.h - fcache.h).abs().max())
    if not (torch.allclose(dec.float(), full[:, JAMBA_PREFILL:].float(),
                           atol=MODEL_TOL, rtol=MODEL_TOL)
            and torch.allclose(out_p.float(), full[:, :JAMBA_PREFILL]
                               .float(), atol=MODEL_TOL, rtol=MODEL_TOL)
            and torch.allclose(cache.h, fcache.h, atol=MODEL_TOL,
                               rtol=MODEL_TOL)
            and torch.equal(cache.conv, fcache.conv)):
        fail(f"jamba: Mamba prefill + decode != one forward over {S} "
             f"tokens (outputs {err}, state {herr})")
    print(f"model: jamba Mamba layer d={cfg.d_model} d_inner="
          f"{ssm._dims(cfg)[0]} N={cfg.ssm.d_state}, {n} params: prefill "
          f"{JAMBA_PREFILL} tokens {1e3 * t_pre:.3f} ms, decode step p50 "
          f"{statistics.median(step_ms):.3f} ms, == one forward over {S} "
          f"(max |diff| outputs {err:.4f}, state {herr:.2e}) [{card}]")
    del p, x, cache, fcache, full, dec, outs
    torch.cuda.empty_cache()
    p = moe.moe_init(g, cfg)
    n = sum(t.numel() for t in p.values())
    x = torch.randn((MODEL_BATCH, JAMBA_PREFILL, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, aux = moe.moe_forward(p, x, cfg)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_d, aux_d = moe.moe_forward(p, x[None, :, -1], cfg)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    for what, o, a in (("prefill", out, aux), ("decode group", out_d,
                                               aux_d)):
        if not (bool(torch.isfinite(o).all()) and float(a) >= 1.0):
            fail(f"jamba: MoE {what} not finite or aux {float(a)} < 1")
    print(f"model: jamba MoE layer {cfg.moe.num_experts} experts top-"
          f"{cfg.moe.top_k} d_ff {cfg.moe.d_ff}, {n} params: prefill "
          f"{MODEL_BATCH} x {JAMBA_PREFILL} {1e3 * t_pre:.3f} ms (aux "
          f"{float(aux):.4f}), decode group of {MODEL_BATCH} "
          f"{1e3 * t_dec:.3f} ms (aux {float(aux_d):.4f}); blocks "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")


def model_phase(ops, dev, card, compare, paths):
    """Phase 8: every config of ``MODEL_RUNS`` through its heads, each
    model's path between zeroed and copied launch counters, then its
    checks and its kernel rows (``compare``), the model freed before the
    next; then jamba's blocks."""
    import gc

    import torch
    t_phase = time.perf_counter()
    seen = set()
    for j, (arch, layers, heads, rows) in enumerate(MODEL_RUNS):
        launches, shapes, cases = serve_one_model(
            arch, layers, heads, rows, SEED + 80 + 10 * j, ops, dev, card)
        label = arch.split("_")[0]
        paths[f"model_{label}"] = (launches, shapes)
        seen |= {k for k, v in launches.items() if v}
        compare(cases)
        del cases
        gc.collect()
        torch.cuda.empty_cache()
    idle = [op for op in ("hash_encode", "hamming_scan", "bucket_match",
                          "bucket_gather", "fused_query", "fused_query_int8")
            if op not in seen]
    if idle:
        fail(f"kernels never launched on the phase-8 paths: {idle}")
    jamba_blocks(SEED + 150, dev, card)
    torch.cuda.empty_cache()
    print(f"model: phase 8 {time.perf_counter() - t_phase:.1f} s")


# -- phase 9: training at full width -----------------------------------------


def step_split(prof, label, card) -> None:
    """The profiled train step in three parts. The autograd engine's
    events bound the backward (the recompute of each checkpointed period
    and loss chunk included): the forward runs from the step's first host
    event to the engine's first, the optimizer from the engine's last to
    the step's last (the closing synchronise included). Each part: its
    host span and the device busy time inside that span."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events()
              if not e.name.startswith("ProfilerStep")]
    host = [e.time_range for e in events if e.device_type == DeviceType.CPU]
    kernels = [e.time_range for e in events
               if e.device_type == DeviceType.CUDA and not is_range(e)]
    engine = [e.time_range for e in events if e.device_type ==
              DeviceType.CPU and e.name.startswith("autograd::engine::")]
    if not host or not engine or not kernels:
        print(f"train: {label}: split not measured (the profiler recorded "
              f"{len(engine)} autograd engine and {len(kernels)} device "
              f"events)")
        return
    t0, t1 = min(r.start for r in host), max(r.end for r in host)
    b0, b1 = min(r.start for r in engine), max(r.end for r in engine)

    def busy(lo, hi):
        return sum(max(0, min(r.end, hi) - max(r.start, lo))
                   for r in kernels)

    parts = {"forward": (t0, b0), "backward": (b0, b1),
             "optimizer": (b1, t1)}
    print(f"train: {label}: profiled step split " + ", ".join(
        f"{k} {(hi - lo) / 1e3:.1f} ms host span, {busy(lo, hi) / 1e3:.1f} "
        f"ms device busy" for k, (lo, hi) in parts.items())
        + f" (device busy in all {busy(t0, t1) / 1e3:.1f} of "
        f"{sum(r.end - r.start for r in kernels) / 1e3:.1f} ms) [{card}]")


def equal_bits(got, want, label) -> int:
    """Fatal unless every leaf of ``got`` has the dtype and device of the
    same path's leaf in ``want`` and the same bits; returns the count."""
    import torch
    from repro_torch.tree import flatten_with_paths
    want = dict(flatten_with_paths(want))
    n = 0
    for k, a in flatten_with_paths(got):
        b = want.pop(k)
        if a.dtype != b.dtype or a.device != b.device or not torch.equal(
                a.reshape(-1).view(torch.uint8),
                b.reshape(-1).view(torch.uint8)):
            fail(f"{label}: restored leaf {k} differs from the saved one")
        n += 1
    if want:
        fail(f"{label}: leaves not restored: {sorted(want)}")
    return n


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(path) for f in fs)


def checkpoint_round_trip(state, label, card) -> None:
    """A direct ``CheckpointManager.save`` and ``restore`` of ``state``
    under build/, each timed (the restore ends in a synchronise); fatal
    unless the restored state equals ``state`` bit for bit. The directory
    is removed."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    build = SRC.parent / "build"
    build.mkdir(exist_ok=True)
    path = tempfile.mkdtemp(prefix=f"ckpt_{label}_", dir=build)
    try:
        free = shutil.disk_usage(path).free
        mgr = CheckpointManager(path)
        t = time.perf_counter()
        mgr.save(0, state)
        t_write = time.perf_counter() - t
        size = dir_bytes(path)
        t = time.perf_counter()
        restored = mgr.restore(0, state)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t
        n = equal_bits(restored, state, f"train {label}")
        del restored
    finally:
        shutil.rmtree(path, ignore_errors=True)
    print(f"train: {label}: checkpoint {size / 1e9:.2f} GB ({free / 1e9:.0f} "
          f"GB free before), write {t_write:.1f} s, restore {t_restore:.1f} "
          f"s, {n} leaves equal the saved state bit for bit [{card}]")


def train_model(arch, batch_size, seq, seed, dev, card, *, layers=None,
                checkpoint=True, falling=False):
    """``TRAIN_TIMED`` steps of ``make_train_step`` on a fresh state of
    ``arch`` at full width, its depth cut to ``layers`` blocks when given
    (1,500 seeded frames for the encoder-decoder): host-clock step times
    ending in a synchronise, peak memory, one profiled step (its
    device-busy share and its forward, backward and optimizer split), and
    with ``checkpoint`` a timed checkpoint write and restore. Fatal unless
    every metric is finite, every param and gradient lives on the card,
    (MoE) aux is at least 1 a MoE layer and, with ``falling``, the loss on
    a held-out batch (the one after the timed steps) falls across them."""
    import math

    import torch
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.tree import leaves

    cfg = model_cfg(arch, layers)
    hp = train.TrainHParams(**TRAIN_HP)
    label = arch.split("_")[0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()      # earlier phases' tensors
    gen = torch.Generator(device=dev).manual_seed(seed)
    state = train.init_state(gen, cfg, device=dev)
    n_params = sum(p.numel() for p in leaves(state.params))
    corpus = SyntheticCorpus(cfg.vocab, seq, seed=seed, device=dev)

    def batch_at(s):
        b = dict(corpus.sample(s, 0, batch_size)._asdict())
        if cfg.is_encoder_decoder:
            b["frames"] = torch.randn(
                (batch_size, cfg.encoder_frames, cfg.d_model),
                generator=gen, device=dev)
        return b

    step_fn = train.make_train_step(cfg, hp)
    if falling:
        with torch.no_grad():
            held_before = float(lm.train_loss(
                state.params, batch_at(TRAIN_TIMED), cfg,
                aux_weight=hp.aux_weight)[0])
    ms, metrics = [], []
    for s in range(TRAIN_TIMED):
        b = batch_at(s)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step_fn(state, b, s)
        m = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        metrics.append(m)
        print(f"train: {label} step {s}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in m.items()) + f"; {ms[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated() - base
    for m in metrics:
        if not all(math.isfinite(m[k]) for k in ("loss", "ce", "aux",
                                                  "gnorm")):
            fail(f"train {label}: a metric is not finite: {m}")
    if cfg.moe is not None:
        period = len(cfg.layer_pattern)
        n_moe = cfg.n_layers // period * sum(
            cfg.is_moe_layer(i) for i in range(period))
        per_layer = [m["aux"] / n_moe for m in metrics]
        print(f"train: {label}: aux a MoE layer ({n_moe} of them) "
              + ", ".join(f"{v:.4f}" for v in per_layer))
        if min(per_layer) < 1.0:
            fail(f"train {label}: MoE aux < 1 a layer: {per_layer}")
    nxt = TRAIN_TIMED
    held, _, grads = train.loss_and_grads(state.params, batch_at(nxt), cfg,
                                          hp)
    if falling:
        first, last = held_before, float(held)
        print(f"train: {label}: loss on a held-out batch {first:.6g} before "
              f"the steps, {last:.6g} after (margin {first - last:.6g})")
        if not last < first:
            fail(f"train {label}: the held-out loss after the steps "
                 f"({last}) is not below the one before ({first})")
    where = {t.device.type for t in leaves(state)}
    gdev = {g.device.type for g in leaves(grads)}
    del grads
    if where != {"cuda"} or gdev != {"cuda"}:
        fail(f"train {label}: state on {where}, gradients on {gdev}")
    p50 = statistics.median(ms[1:])
    tokens = batch_size * seq
    print(f"train: {label}: {n_params} params, {cfg.n_layers} layers, "
          f"batch {batch_size} x {seq}; step p50 {p50:.1f} ms (first "
          f"{ms[0]:.1f}), {1e3 * tokens / p50:.0f} tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB earlier "
          f"phases hold [{card}]")
    prof = profile_batch(f"train step {label}",
                         lambda: step_fn(state, batch_at(nxt), nxt))
    step_split(prof, label, card)
    del prof
    torch.cuda.empty_cache()
    if checkpoint:
        checkpoint_round_trip(state, label, card)
    del state
    return p50


def sequential_scan(a, b, h0, chunk):
    """The plain version of ``ssm._ssm_scan_chunked``: one step a token,
    ``h_t = a_t * h_{t-1} + b_t``, in time order (the chunk sets nothing
    here)."""
    import torch
    hs, h = [], h0
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, 1), h


def mamba_block_train(seed, dev, card):
    """Jamba's Mamba block (``ssm.ssm_forward``) at full width, forward
    and backward: the gradients of a seeded cotangent with respect to the
    input and every weight, on f32 copies of seeded weights, B
    ``MAMBA_BATCH`` x S ``MAMBA_SEQ``. Through the chunked scan (timed
    after one warm-up call, peak memory), then once more with
    ``sequential_scan`` in its place (the plain version, on no main path):
    the output, the final state and every gradient within ``MAMBA_TOL``
    of the plain version's largest magnitude. A whole jamba layer cannot
    train on one card: its MoE's f32 AdamW moments alone are ~77 GB."""
    from unittest import mock

    import torch
    from repro_torch.models import ssm
    cfg = model_cfg(JAMBA_ARCH, None)
    d_inner, N = ssm._dims(cfg)[:2]
    g = torch.Generator(device=dev).manual_seed(seed)
    p = {k: v.float().requires_grad_()
         for k, v in ssm.ssm_init(g, cfg).items()}
    shape = (MAMBA_BATCH, MAMBA_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=g, device=dev).requires_grad_()
    cot = torch.randn(shape, generator=g, device=dev)
    names = ["output", "final state", "grad x"] + [f"grad {k}" for k in p]

    def run():
        out, cache = ssm.ssm_forward(p, x, cfg)
        grads = torch.autograd.grad(out, [x] + list(p.values()), cot)
        return [out.detach(), cache.h.detach(), *grads]

    def timed_run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t)

    t_first = timed_run()[1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, ms = timed_run()
    peak = torch.cuda.max_memory_allocated() - base
    with mock.patch.object(ssm, "_ssm_scan_chunked", sequential_scan):
        want, plain_ms = timed_run()
    worst = 0.0
    for name, a, b in zip(names, got, want):
        if not bool(torch.isfinite(a).all()):
            fail(f"train: jamba Mamba block: {name} not finite")
        rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
        if rel > MAMBA_TOL:
            fail(f"train: jamba Mamba block: {name} differs from the "
                 f"sequential loop's by {rel:.3e} of its largest magnitude "
                 f"(> {MAMBA_TOL})")
    moe = cfg.moe
    moments = 2 * 4 * 3 * cfg.d_model * moe.d_ff * moe.num_experts
    print(f"train: jamba Mamba block d {cfg.d_model} d_inner {d_inner} N "
          f"{N} chunk 16, batch {MAMBA_BATCH} x {MAMBA_SEQ}, f32 weights: "
          f"forward + backward {ms:.1f} ms (first {t_first:.1f} ms), peak "
          f"memory {peak / 2**30:.2f} GiB; the sequential loop {plain_ms:.1f}"
          f" ms; output, final state and {len(names) - 2} gradients within "
          f"{worst:.3e} of the loop's largest magnitudes (tolerance "
          f"{MAMBA_TOL}); a whole layer cannot train on one card: its MoE's "
          f"f32 AdamW moments alone are {moments / 1e9:.1f} GB [{card}]")


def train_phase(dev, card):
    """Phase 9: Qwen3-0.6B through ``run_training`` with a checkpoint and
    a resume; the restored step is held bit for bit against the digests
    the trainer's save wrote. Then each of ``TRAIN_RUNS`` through
    ``train_model``. Returns each run's step p50 (ms) by arch."""
    import math
    import shutil
    import tempfile
    import zlib

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    from repro_torch.tree import flatten_with_paths

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    hp = train.TrainHParams(**TRAIN_HP)
    build = SRC.parent / "build"
    build.mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_", dir=build)
    losses = {}

    def log(s, m):
        losses[s] = m
        print(f"train: run_training step {s}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in m.items()))

    kw = dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, ckpt_dir=ckpt,
              ckpt_every=TRAIN_STEPS, log_every=1, seed=SEED + 190,
              on_metrics=log, device=dev)
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # earlier phases' tensors
        t = time.perf_counter()
        train.run_training(cfg, hp, steps=TRAIN_STEPS, **kw)
        t_run = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base
        mgr = CheckpointManager(ckpt)
        if mgr.all_steps() != [TRAIN_STEPS]:
            fail(f"train: checkpoints {mgr.all_steps()}, not step "
                 f"{TRAIN_STEPS} alone")
        digests = mgr.manifest(TRAIN_STEPS)["leaves"]
        size = dir_bytes(ckpt)
        # a template of other values: what comes back is the file's
        template = train.init_state(
            torch.Generator(device=dev).manual_seed(SEED + 189), cfg,
            device=dev)
        t = time.perf_counter()
        restored = mgr.restore(TRAIN_STEPS, template)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t
        n_leaves = 0
        for (k, a), (_, b) in zip(flatten_with_paths(restored),
                                  flatten_with_paths(template)):
            raw = a.detach().reshape(-1).view(torch.uint8).cpu().numpy()
            if (a.dtype != b.dtype or a.device != b.device
                    or zlib.crc32(raw.tobytes()) != digests.pop(k)["crc32"]):
                fail(f"train: restored leaf {k} differs from the one "
                     f"run_training saved")
            n_leaves += 1
        if digests:
            fail(f"train: saved leaves not restored: {sorted(digests)}")
        print(f"train: {TRAIN_ARCH} run_training {TRAIN_STEPS} steps "
              f"{t_run:.1f} s (init, steps and the checkpoint's write), peak "
              f"memory {peak / 2**30:.2f} GiB above the earlier phases'; "
              f"checkpoint of step {TRAIN_STEPS}: {size / 1e9:.2f} GB, "
              f"restore {t_restore:.1f} s, {n_leaves} restored leaves match "
              f"the crc32 of each leaf run_training saved [{card}]")
        del restored, template
        torch.cuda.empty_cache()
        first = len(losses)
        t = time.perf_counter()
        train.run_training(cfg, hp, steps=TRAIN_RESUME, **kw)
        print(f"train: resumed run to step {TRAIN_RESUME} "
              f"{time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    resumed = sorted(losses)[first:]
    if resumed[:1] != [TRAIN_STEPS]:
        fail(f"train: the resumed run started at {resumed[:1]}, not "
             f"{TRAIN_STEPS}")
    for s, m in losses.items():
        if not all(math.isfinite(m[k]) for k in ("loss", "ce", "aux",
                                                  "gnorm")):
            fail(f"train: step {s} metrics not finite: {m}")
    last = max(losses)
    print(f"train: loss step 0 {losses[0]['loss']:.6g}, step {last} "
          f"{losses[last]['loss']:.6g} (margin "
          f"{losses[0]['loss'] - losses[last]['loss']:.6g}), highest "
          f"{max(m['loss'] for m in losses.values()):.6g}")
    if not losses[last]["loss"] < losses[0]["loss"]:
        fail(f"train: loss at step {last} ({losses[last]['loss']}) is not "
             f"below step 0's ({losses[0]['loss']})")
    torch.cuda.empty_cache()
    step_ms = {}
    for j, (arch, batch_size, seq) in enumerate(TRAIN_RUNS):
        step_ms[arch] = train_model(arch, batch_size, seq, SEED + 191 + j,
                                    dev, card)
        torch.cuda.empty_cache()
    t = time.perf_counter()
    arch, batch_size, seq, layers = XLSTM_TRAIN
    train_model(arch, batch_size, seq, SEED + 195, dev, card, layers=layers,
                checkpoint=False, falling=True)
    torch.cuda.empty_cache()
    print(f"train: xlstm {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    mamba_block_train(SEED + 196, dev, card)
    torch.cuda.empty_cache()
    print(f"train: jamba Mamba block {time.perf_counter() - t:.1f} s")
    print(f"train: phase 9 {time.perf_counter() - t_phase:.1f} s")
    return step_ms


# -- phase 10: ALS embeddings through RANGE-LSH -------------------------------


def als_phase(ops, dev, card):
    """Phase 10: the paper's own application. ALS factors of synthetic
    Netflix-sized ratings, a RANGE-LSH index over the item factors
    calibrated on held-out users, the other users' queries through every
    arm, the launch counters and a dispatch tracker zeroed just before
    the path and read right after it. Returns the path's launches and
    shapes and the kernel cases at its shapes."""
    import torch
    from repro_torch.core import planner
    from repro_torch.core.engine import (QueryEngine, _directory_order,
                                         _planned_runs, engine_for)
    from repro_torch.core.index import IndexSpec, build
    from repro_torch.data import als
    from repro_torch.obs import RingBufferSink, Tracker

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 200)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    dispatch = Tracker([RingBufferSink(capacity=1 << 10)])
    ops.set_dispatch_tracker(dispatch)
    try:
        t = time.perf_counter()
        ratings, weights = als.synthetic_ratings(
            gen, ALS_USERS, ALS_ITEMS, true_rank=ALS_TRUE_RANK,
            density=ALS_DENSITY)
        start = als.als_factorize(ratings, weights, ALS_RANK, gen, iters=0)
        torch.cuda.synchronize()
        print(f"als: ratings {ALS_USERS} x {ALS_ITEMS} ({int(weights.sum())} "
              f"observed) and a rank-{ALS_RANK} start "
              f"{time.perf_counter() - t:.2f} s")
        users, items = start.users, start.items
        losses, secs = [], []
        for _ in range(ALS_SWEEPS):
            t = time.perf_counter()
            st = als.als_factorize(ratings, weights, ALS_RANK,
                                   init=(users, items), iters=1)
            users, items = st.users, st.items
            losses.append(float(st.loss))
            secs.append(time.perf_counter() - t)
        del ratings, weights
        spec = IndexSpec(family="simple", code_len=32, m=32,
                         scheme="percentile", engine="fused",
                         recall_target=RECALL_TARGET)
        t = time.perf_counter()
        idx = build(dataclasses.replace(spec, recall_target=None), items,
                    gen, device=dev)
        idx = idx._replace(spec=spec, calib=planner.calibrate(
            idx, users[:ALS_CAL]))
        fused = engine_for(idx, engine="fused")
        torch.cuda.synchronize()
        t_index = time.perf_counter() - t
        plan = planner.resolve_budgets(idx.calib, RECALL_TARGET, k=K)
        budgets = plan.budgets
        arms = {
            "fused": None,
            "fused_int8": QueryEngine(idx, engine="fused", quantized=True,
                                      buckets=fused.buckets, device=dev),
            "bucket": QueryEngine(idx, engine="bucket",
                                  buckets=fused.buckets, device=dev),
            "dense": QueryEngine(idx, engine="dense", buckets=fused.buckets,
                                 device=dev),
        }
        queries = users[ALS_CAL:ALS_CAL + ALS_QUERIES]
        ms = {a: [] for a in arms}
        outs = {a: [] for a in arms}
        cands, truth = [], []
        for s in range(0, ALS_QUERIES, BATCH):
            qb = queries[s:s + BATCH]
            for arm, eng in arms.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = (idx.query(qb, k=K) if eng is None
                       else eng.query(qb, K, budgets=budgets))
                torch.cuda.synchronize()
                ms[arm].append(1e3 * (time.perf_counter() - t))
                outs[arm].append(out)
            cands.append((arms["bucket"].candidates(qb, budgets=budgets),
                          arms["dense"].candidates(qb, budgets=budgets)))
            truth.append(ops.mips_topk(qb, items, K)[1])
        torch.cuda.synchronize()
    finally:
        ops.set_dispatch_tracker(None)
    launches = dict(ops.launch_counts)
    shapes = dict(ops.launch_shapes)
    want = ALS_KERNELS
    print(f"launches on the phase-10 path: "
          f"{ {k: launches[k] for k in want} }")
    idle = [op for op in want if launches[op] == 0]
    if idle:
        fail(f"als: kernels never launched on its path: {idle}")
    counted = {op: int(dispatch.counters.get(
        f"repro.kernels.dispatch.{op}.cuda", 0)) for op in ops.OPS}
    launched = {op: launches[op] for op in ops.OPS}
    launched["fused_query"] += launches["fused_query_int8"]
    refs = sorted(k for k in dispatch.counters if k.endswith(".ref"))
    if counted != launched or refs:
        fail(f"als: dispatch counts {counted} != launches {launched} (ref "
             f"dispatches {refs})")

    # -- the checks ---------------------------------------------------------
    print("als: loss by sweep " + ", ".join(f"{v:.6g}" for v in losses)
          + "; seconds by sweep " + ", ".join(f"{v:.2f}" for v in secs)
          + f" [{card}]")
    if not losses[-1] < losses[0]:
        fail(f"als: loss did not fall from sweep 1 ({losses[0]}) to sweep "
             f"{ALS_SWEEPS} ({losses[-1]})")
    norms = torch.linalg.vector_norm(items, dim=1)
    print(f"als: item norms max {float(norms.max()):.4f}, median "
          f"{float(norms.median()):.4f} (max/median "
          f"{float(norms.max() / norms.median()):.2f}); index and "
          f"calibration {t_index:.2f} s; plan width {plan.num_probe} of "
          f"{ALS_ITEMS}, predicted {plan.predicted_recall:.4f}")
    truth_n = sum(t_.numel() for t_ in truth)
    tie_diffs = 0
    for b_, (cb, cd) in enumerate(cands):
        if not torch.equal(cb, cd):
            fail(f"als: batch {b_}: bucket and dense candidate ids differ")
        qb = queries[b_ * BATCH:(b_ + 1) * BATCH]
        fv, fi = outs["fused"][b_]
        sv, si = outs["bucket"][b_]
        tie_diffs += check_topk("als fused vs bucket", fi, fv, si, sv, qb,
                                items)[1]
    for arm in arms:
        hits = sum(int((ids[:, :, None] == t_[:, None, :]).any(1).sum())
                   for (_, ids), t_ in zip(outs[arm], truth))
        rec = hits / truth_n
        print(f"als: {arm:10s} recall@{K} {rec:.4f} median "
              f"{statistics.median(ms[arm]):.3f} ms/batch of {BATCH}, width "
              f"{plan.num_probe} [{card}]")
        if rec < ALS_RECALL:
            fail(f"als: {arm} recall@{K} {rec:.4f} < {ALS_RECALL}")
    print(f"als: fused vs bucket ids differ in {tie_diffs} tied slots")

    # -- kernel cases at the path's shapes -----------------------------------
    qb = queries[:BATCH]
    fam = idx.family
    x = idx.items / idx.upper_eff[idx.range_id][:, None]
    tail = torch.sqrt(torch.clamp_min(1.0 - torch.sum(x * x, -1), 0.0))
    A, a_tail = idx.params[:-1], idx.params[-1]
    q_codes = fam.encode_queries(idx.params, qb)
    order = _directory_order(fused.buckets, q_codes, fused._match_fn)
    cum, starts = _planned_runs(fused.buckets, order, budgets)
    total = plan.num_probe
    items_csr, _, _ = fused._fused_arrays
    items_csr8, payload, scale = arms["fused_int8"]._fused_arrays
    n, d = x.shape
    L, W = idx.hash_bits, idx.codes.shape[1]
    runs = held_runs(cum, total)
    live = (torch.arange(total, device=dev)[None] < cum[:, -1:])
    slots = int(live.sum())
    probed = ops.bucket_gather(cum, starts, total, impl="ref")
    probed_rows = int(torch.unique(probed[live]).numel())
    kp = max(K, min(max(4 * K, 32), total))
    _, sp = ops.fused_query(qb, cum, starts, items_csr, total, kp,
                            kprime=kp, impl="ref")
    surv = int((sp >= 0).sum())
    _, sp = ops.fused_query(qb, cum, starts, items_csr8, total, kp,
                            kprime=kp, payload=payload, scale=scale,
                            impl="ref")
    surv8 = int((sp >= 0).sum())
    surv8_rows = int(torch.unique(sp[sp >= 0]).numel())
    del sp

    def topk_check(name, rows):
        return lambda got, want: check_topk(name, got[1], got[0], want[1],
                                            want[0], qb, rows)

    src = "src/repro_torch/kernels/csrc/"
    cases = {
        "hash_encode_als": dict(
            call=lambda impl: ops.hash_encode(x, A, tail, a_tail, impl=impl),
            bytes=4 * (n * d + d * L + n + L + n * W),
            ops=2 * n * d * L + 2 * n * L, op_rate=PEAK_OPS_NO_FMA,
            device=("hash_encode",), kernel="hash_encode", path="als",
            source=src + "hash_encode.cu",
            replaces="src/repro/kernels/hash_encode.py:83"),
        "fused_query_als": dict(
            call=lambda impl: ops.fused_query(qb, cum, starts, items_csr,
                                              total, K, impl=impl),
            bytes=(4 * BATCH * d + 8 * runs + 8 * BATCH * K
                   + probed_rows * (4 * d + 4)),
            ops=2 * (slots + surv) * d, kernel="fused_query", path="als",
            check=topk_check("fused_query (als)", items_csr),
            source=src + "fused_query.cu",
            replaces="src/repro/kernels/fused_query.py:156", cold=True),
        "fused_query_int8_als": dict(
            call=lambda impl: ops.fused_query(
                qb, cum, starts, items_csr8, total, K, payload=payload,
                scale=scale, impl=impl),
            bytes=(4 * BATCH * d + 8 * runs + 8 * BATCH * K
                   + probed_rows * (d + 4) + surv8_rows * 4 * d),
            ops=2 * (slots + surv8) * d, kernel="fused_query_int8",
            path="als", check=topk_check("fused_query_int8 (als)",
                                         items_csr8),
            source=src + "fused_query.cu",
            replaces="src/repro/kernels/fused_query.py:156", cold=True),
        # the dense arm's scan of every item code
        "hamming_scan_als": dict(
            call=lambda impl: ops.hamming_scan(q_codes, idx.codes,
                                               impl=impl),
            bytes=4 * (BATCH * W + n * W + BATCH * n),
            ops=2 * BATCH * n * W, ceiling=(BATCH, n),
            kernel="hamming_scan", path="als",
            source=src + "hamming.cu",
            replaces="src/repro/kernels/hamming.py:46"),
        # the bucket arm's gather of the planned probes
        "bucket_gather_als": dict(
            call=lambda impl: ops.bucket_gather(cum, starts, total,
                                                impl=impl),
            bytes=4 * (2 * runs + BATCH * total),
            ops=2 * slots, ceiling=(BATCH, total),
            device=("bucket_gather_kernel",), kernel="bucket_gather",
            path="als", source=src + "bucket_gather.cu",
            replaces="src/repro/kernels/bucket_probe.py:124"),
        # the recall truth itself
        "mips_topk_als": dict(
            call=lambda impl: ops.mips_topk(qb, items, K, impl=impl),
            bytes=4 * (BATCH * d + n * d + 2 * BATCH * K),
            ops=2 * BATCH * n * d, kernel="mips_topk", path="als",
            library=lambda: torch.topk(qb @ items.T, K),
            check=topk_check("mips_topk (als)", items),
            source=src + "mips_topk.cu",
            replaces="src/repro/kernels/mips_topk.py:93", cold=True),
    }
    print(f"als: phase 10 {time.perf_counter() - t_phase:.1f} s")
    return launches, shapes, cases


# -- phase 11: the analysis layer --------------------------------------------


def count_flops(kind, cfg, shape, counted, est) -> float:
    """Prints the FLOPs ``FlopCounterMode`` counted against the analytic
    model's matmul and attention terms at the same shape, with the terms
    the two count differently; returns counted / analytic."""
    from repro_torch.parallel import analytic
    B, S = shape.global_batch, shape.seq_len
    head = 2.0 * cfg.d_model * cfg.padded_vocab * B * S
    layers = 2.0 * (est["matmul_active"] - est["embed"]) * B * S
    attn = analytic._attention_flops(cfg, B, S, "prefill")["impl"]
    model = est["matmul_flops"] + est["attn_flops"]
    ratio = counted / model
    print(f"analysis: {kind} {cfg.name} {B} x {S}: counted {counted:.6e} "
          f"FLOPs, analytic matmul {est['matmul_flops']:.6e} + attention "
          f"{est['attn_flops']:.6e} = {model:.6e}, counted / analytic "
          f"{ratio:.4f}; a forward pass's terms: layers' matmuls "
          f"{layers:.6e}, the head over every token {head:.6e}, attention "
          f"{attn:.6e}")
    return ratio


def analysis_phase(ops, dev, card, paths, step_ms, decode_ms):
    """Phase 11: the analysis layer on the card. Kernelcheck K1-K5 over
    the registry (probes, plans, ptxas, cold timings against each cost's
    bound) and K1-K3 over every launch shape of phases 2-10, between
    zeroed and read launch counters; the FLOPs ``FlopCounterMode`` counts
    in one Qwen3-0.6B prefill and one train step at 8 x 512 against the
    analytic model; the roofline of phases 9 and 7's measured steps; the
    dry run's parameter counts and estimates of all 32 cells on meta
    parameters, allocating nothing on the card. Returns the path's
    launches and shapes."""
    import torch
    from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeConfig,
                                          get_config, shape_cells)
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.launch import dryrun, train
    from repro_torch.models import lm
    from repro_torch.obs.cost import flop_counter_cost
    from repro_torch.parallel import analytic
    from repro_torch.parallel.roofline import (card_peaks,
                                               measured_fraction, roofline)
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    name = torch.cuda.get_device_name(dev)
    pk = card_peaks(name)
    print(f"analysis: peaks of {name}: bf16 {pk.bf16_flops:.3e} FLOP/s, "
          f"f32 {pk.f32_flops:.3e}, HBM {pk.hbm_bytes:.3e} B/s (data sheet,"
          f" {pk.power_w:.0f} W) [{card}]")

    # -- kernelcheck, between zeroed and read launch counters
    launched = sorted({k for _, shapes in paths.values() for k in shapes})
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    report = registry_checks(dev, "phase 11", launched, card)
    torch.cuda.synchronize()
    launches, shapes = dict(ops.launch_counts), dict(ops.launch_shapes)
    idle = [k for k in ops.KERNELS if launches[k] == 0]
    if idle:
        fail(f"analysis: kernels kernelcheck never launched: {idle}")
    rows = [r for v in report["kernels"].values() for r in v["classes"]]
    print(f"analysis: kernelcheck {time.perf_counter() - t:.1f} s, "
          f"{len(rows)} rows, {report['launch_shapes']} launch shapes of "
          f"phases 2-10 planned, launches {launches}, highest share of the "
          f"bound {100 * max(r['ops_share'] for r in rows):.2f}% "
          f"(operations)")

    # -- FLOPs counted against the analytic model (Qwen3-0.6B, 8 x 512)
    t = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    pre = ShapeConfig("smoke_prefill", TRAIN_SEQ, TRAIN_BATCH, "prefill")
    trn = ShapeConfig("smoke_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    params, _ = model_params(cfg, SEED + 211, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 212)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                         generator=gen, device=dev)
    with torch.no_grad():
        counted = flop_counter_cost(lm.prefill, params, toks, cfg)["flops"]
    r_pre = count_flops("prefill", cfg, pre, counted,
                        analytic.estimate(cfg, pre, params, 1))
    del params
    torch.cuda.empty_cache()
    state = train.init_state(gen, cfg, device=dev)
    batch = dict(SyntheticCorpus(cfg.vocab, TRAIN_SEQ, seed=SEED + 213,
                                 device=dev).sample(0, 0, TRAIN_BATCH)
                 ._asdict())
    step = train.make_train_step(cfg, train.TrainHParams(**TRAIN_HP))
    counted = flop_counter_cost(step, state, batch, 0)["flops"]
    r_trn = count_flops("train step", cfg, trn, counted,
                        analytic.estimate(cfg, trn, state.params, 1))
    del state, batch
    torch.cuda.empty_cache()
    print(f"analysis: counted / analytic: prefill {r_pre:.4f}, train step "
          f"{r_trn:.4f} ({time.perf_counter() - t:.1f} s)")

    # -- roofline of the measured steps of phases 9 and 7
    runs = [(arch, ShapeConfig("train", seq, b, "train"), step_ms[arch])
            for arch, b, seq in TRAIN_RUNS]
    runs.append((SERVE_ARCH, ShapeConfig("decode", SERVE_MAX_SEQ,
                                         SERVE_BATCH, "decode"), decode_ms))
    for arch, shape, ms in runs:
        mcfg = get_config(arch)
        est = analytic.estimate(mcfg, shape, dryrun._abstract_params(mcfg),
                                1)
        r = roofline(est["flops"], est["hbm_bytes_per_device"], 0.0, 1,
                     est["model_flops"], card=name)
        bound_ms = 1e3 * max(r["compute_s"], r["memory_s"])
        mfu = measured_fraction(est["model_flops"], ms / 1e3, card=name)
        print(f"analysis: roofline {arch} {shape.kind} {shape.global_batch}"
              f" x {shape.seq_len}: compute {1e3 * r['compute_s']:.4f} ms, "
              f"memory {1e3 * r['memory_s']:.4f} ms, bottleneck "
              f"{r['bottleneck']}, roofline_fraction "
              f"{r['roofline_fraction']:.4f}; measured step p50 {ms:.3f} ms:"
              f" bound / measured {bound_ms / ms:.5f}, model FLOPs at "
              f"{100 * mfu:.3f}% of the bf16 peak [{card}]")

    # -- the dry run's cells on meta parameters: nothing on the card
    t = time.perf_counter()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    n = 0
    for arch in ARCH_IDS:
        mcfg = get_config(arch)
        params = dryrun._abstract_params(mcfg)
        if not all(x.is_meta for x in leaves(params)):
            fail(f"analysis: {arch}'s abstract params left the meta device")
        pc = dryrun.param_counts(mcfg, params)
        for cell in shape_cells(arch):
            est = analytic.estimate(mcfg, SHAPES[cell], params, 1)
            specs = leaves(dryrun.input_specs(arch, cell))
            if not all(x.is_meta for x in specs):
                fail(f"analysis: {arch} {cell} inputs left the meta device")
            n += 1
            print(f"analysis: dryrun {arch} {cell}: params "
                  f"{pc['total']:.0f} (active {pc['active']:.0f}, experts "
                  f"{pc['expert']:.0f}), flops {est['flops']:.6e}, "
                  f"model_flops {est['model_flops']:.6e}, hbm bytes "
                  f"{est['hbm_bytes_per_device']:.6e}, {len(specs)} input "
                  f"tensors")
        del params
    after = torch.cuda.memory_allocated(dev)
    if n != 32 or after != before:
        fail(f"analysis: {n} dry-run cells, card memory {before} -> {after}"
             f" bytes")
    print(f"analysis: dryrun {n} cells {time.perf_counter() - t:.2f} s, "
          f"card memory allocated {before} -> {after} bytes")
    print(f"analysis: phase 11 {time.perf_counter() - t_phase:.1f} s")
    return launches, shapes


# -- phase 12: the mesh -------------------------------------------------------


def start_dryrun_cells(out_dir):
    """The dry run's ``DRYRUN_CELLS`` on the pod mesh, each in its own
    process (``python -m repro_torch.launch.dryrun``; no card: a fake
    256-rank group on meta tensors), started together. Returns {(arch,
    shape): process}."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    procs = {}
    for arch, shape in DRYRUN_CELLS:
        procs[arch, shape] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "pod", "--out",
             str(out_dir)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    return procs


def print_cell(rec, card):
    """One dry-run record's line: ok, per-device argument bytes against
    the card's memory, collectives by op, wire bytes, roofline terms."""
    mem = rec.get("memory_analysis") or {}
    arg = mem.get("argument_bytes")
    r = rec["roofline"]
    c = rec["collectives"]
    share = "" if arg is None else \
        f" ({100 * arg / rec['card_bytes']:.3f}% of the card's)"
    print(f"mesh: dryrun {rec['arch']} {rec['shape']} {rec['mesh']} "
          f"({rec['chips']} chips): ok {rec['ok']}, run "
          f"{rec.get('run_s')} s, argument bytes a device {arg}{share}, "
          f"output bytes {mem.get('output_bytes')}, collectives "
          f"{rec.get('collective_counts')}, wire bytes a device "
          f"{c['total_wire_bytes']:.6e}, roofline compute "
          f"{r['compute_s']:.6e} s, memory {r['memory_s']:.6e} s, "
          f"collective {r['collective_s']:.6e} s, bottleneck "
          f"{r['bottleneck']}, fraction {r['roofline_fraction']:.4f} "
          f"[{rec['card']}; {card}]")


def collect_dryrun_cells(procs, out_dir, card):
    """Waits for :func:`start_dryrun_cells`' processes and prints each
    record; fatal if a cell failed."""
    import torch
    cap = torch.cuda.get_device_properties(0).total_memory
    for (arch, cell), proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"mesh: dry-run cell {arch} {cell} ran past "
                 f"{DRYRUN_TIMEOUT} s")
        path = out_dir / f"{arch}__{cell}__pod.json"
        if proc.returncode != 0 or not path.exists():
            fail(f"mesh: dry-run cell {arch} {cell} exited "
                 f"{proc.returncode}: {out[-1500:]}")
        rec = json.loads(path.read_text())
        if not rec.get("ok"):
            fail(f"mesh: dry-run cell {arch} {cell}: {rec.get('error')}")
        rec["card_bytes"] = cap
        print_cell(rec, card)


def mesh_train(cfg, mesh, dev, card):
    """(a): three steps of Qwen3-0.6B at full width, 8 x 512, meshless
    and on the 1 x 1 mesh from one seeded state: equal losses, states
    equal bit for bit afterwards."""
    import torch
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.launch import train
    from repro_torch.tree import tree_map
    hp = train.TrainHParams(**TRAIN_HP)
    plain = train.init_state(torch.Generator(device=dev).manual_seed(
        SEED + 301), cfg, device=dev)
    placed = train.shard_state(tree_map(torch.clone, plain), cfg, mesh)
    meshless = train.make_train_step(cfg, hp)
    meshed = train.make_train_step(cfg, hp, mesh=mesh)
    corpus = SyntheticCorpus(cfg.vocab, TRAIN_SEQ, seed=SEED + 302,
                             device=dev)
    times = {"meshless": [], "mesh": []}
    for step in range(MESH_TRAIN_STEPS):
        batch = dict(corpus.sample(step, 0, TRAIN_BATCH)._asdict())
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain, want = meshless(plain, dict(batch), step)
        torch.cuda.synchronize()
        times["meshless"].append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        placed, got = meshed(placed, dict(batch), step)
        torch.cuda.synchronize()
        times["mesh"].append(1e3 * (time.perf_counter() - t))
        if not torch.equal(got["loss"], want["loss"]):
            fail(f"mesh: train step {step}: loss {float(got['loss'])} on "
                 f"the mesh, {float(want['loss'])} without")
        print(f"mesh: train step {step}: loss {float(want['loss']):.6f} "
              f"both, gnorm {float(want['gnorm']):.6f} / "
              f"{float(got['gnorm']):.6f}, ms meshless "
              f"{times['meshless'][-1]:.1f}, mesh {times['mesh'][-1]:.1f} "
              f"[{card}]")
    n = equal_bits(train.unshard(placed), plain, "mesh: train state")
    print(f"mesh: train: {n} state leaves equal bit for bit after "
          f"{MESH_TRAIN_STEPS} steps; step p50 meshless "
          f"{statistics.median(times['meshless']):.1f} ms, mesh "
          f"{statistics.median(times['mesh']):.1f} ms (first step "
          f"{times['mesh'][0]:.1f} ms: DTensor's sharding rules warm up) "
          f"[{card}]")


def mesh_serve(cfg, mesh, dev, card):
    """(b): 8 requests of 64 prompt tokens, 16 greedy tokens each,
    through ``make_prefill``/``make_decode_step`` meshless and with the
    mesh: the tokens must be equal."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    params, _ = model_params(cfg, SEED + 311, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 312)
    prompts = torch.randint(0, cfg.vocab, (MESH_REQUESTS, MESH_PROMPT),
                            generator=gen, device=dev)
    out, ms = {}, {}
    for label, kw in (("meshless", {}), ("mesh", {"mesh": mesh})):
        h, caches = serve.make_prefill(cfg, **kw)(params, prompts)
        caches = lm.extend_cache(cfg, caches, MESH_PROMPT + MESH_TOKENS)
        step = serve.make_decode_step(cfg, **kw)
        nxt = prompts[:, -1]
        toks, times = [], []
        for pos in range(MESH_PROMPT, MESH_PROMPT + MESH_TOKENS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = step(params, nxt, caches, pos)
            nxt = logits[:, :cfg.vocab].argmax(-1)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
            toks.append(nxt)
        out[label], ms[label] = torch.stack(toks, 1), times
    if not torch.equal(out["mesh"], out["meshless"]):
        bad = int((out["mesh"] != out["meshless"]).sum())
        fail(f"mesh: {bad} of {out['mesh'].numel()} greedy tokens differ "
             f"on the mesh")
    print(f"mesh: decode: {MESH_REQUESTS} x {MESH_TOKENS} greedy tokens "
          f"equal on the mesh; step p50 meshless "
          f"{statistics.median(ms['meshless']):.1f} ms, mesh "
          f"{statistics.median(ms['mesh']):.1f} ms (first mesh step "
          f"{ms['mesh'][0]:.1f} ms) [{card}]")
    del params


def seq_sharded_case(dev, card):
    """(c): the sequence-sharded combine over 4 in-process shards at
    Qwen3's decode layer shape against ``decode_attention``, f32."""
    import torch
    from repro_torch.core.distributed import InProcessShardGroup
    from repro_torch.models import attention as attn
    gen = torch.Generator(device=dev).manual_seed(SEED + 321)
    q = torch.randn((SEQ_B, SEQ_H, SEQ_HD), generator=gen, device=dev)
    k = torch.randn((SEQ_B, SEQ_CACHE, SEQ_KV, SEQ_HD), generator=gen,
                    device=dev)
    v = torch.randn((SEQ_B, SEQ_CACHE, SEQ_KV, SEQ_HD), generator=gen,
                    device=dev)
    ks, vs = torch.chunk(k, SEQ_SHARDS, 1), torch.chunk(v, SEQ_SHARDS, 1)
    group = InProcessShardGroup(SEQ_SHARDS)

    def sharded():
        return attn.decode_attention_seq_sharded(q, ks, vs, SEQ_POS, group)

    def whole():
        return attn.decode_attention(q, k, v, SEQ_POS)

    got, want = sharded(), whole()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=SEQ_ATOL, rtol=SEQ_RTOL):
        fail(f"mesh: the sequence-sharded combine differs from "
             f"decode_attention by {err}")
    print(f"mesh: decode_attention_seq_sharded B {SEQ_B}, cache "
          f"{SEQ_CACHE}, KV {SEQ_KV}, hd {SEQ_HD}, H {SEQ_H} over "
          f"{SEQ_SHARDS} in-process shards, write slot {SEQ_POS}: max err "
          f"{err:.3e} (atol {SEQ_ATOL}, rtol {SEQ_RTOL}); {timed(sharded):.4f}"
          f" ms, decode_attention {timed(whole):.4f} ms [{card}]")
    del q, k, v, ks, vs


def elastic_case(dev, card):
    """(e): ``elastic_recover`` on the survivors' 1 x 1 slice restores a
    reduced Qwen3 state from its checkpoint bit for bit."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.launch import runtime, train
    cfg = get_config(MESH_ARCH).reduced()
    state = train.init_state(torch.Generator(device=dev).manual_seed(
        SEED + 331), cfg, device=dev)
    template = train.init_state(torch.Generator(device=dev).manual_seed(
        SEED + 332), cfg, device=dev)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    where = tempfile.mkdtemp(dir=build)
    try:
        CheckpointManager(where).save(7, state)
        t = time.perf_counter()
        mesh, step, got = runtime.elastic_recover(
            CheckpointManager(where), template, surviving_slices=1,
            slice_shape=(1, 1))
        secs = time.perf_counter() - t
        if step != 7:
            fail(f"mesh: elastic_recover restored step {step}, not 7")
        n = equal_bits(got, state, "mesh: elastic_recover")
        print(f"mesh: elastic_recover: mesh {tuple(mesh.mesh_dim_names)} "
              f"{tuple(mesh.shape)}, step {step}, {n} leaves equal bit "
              f"for bit, {secs:.2f} s [{card}]")
    finally:
        shutil.rmtree(where, ignore_errors=True)


def mesh_phase(ops, dev, card):
    """Phase 12: the mesh on the card. The dry run's ``DRYRUN_CELLS``
    (Qwen3's three, xlstm's train_4k) start in their own processes; then (a) train and (b) serve Qwen3-0.6B at full
    width on a 1 x 1 mesh of an NCCL world of one against the meshless
    steps, (c) the sequence-sharded combine, (d) the MIPS cell on the pod
    mesh on the card and the cells' records, (e) ``elastic_recover``.
    The launch counters are zeroed just before and read right after;
    every kernel of the MIPS cell's path must have launched. Returns the
    path's launches and shapes."""
    import tempfile

    import torch
    import torch.distributed as tdist
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    out_dir = TRACE_DIR / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = start_dryrun_cells(out_dir)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rdv = tempfile.mkdtemp()
    tdist.init_process_group("nccl", init_method=f"file://{rdv}/rdv",
                             rank=0, world_size=1)
    try:
        mesh = make_local_mesh()
        cfg = get_config(MESH_ARCH)
        t = time.perf_counter()
        mesh_train(cfg, mesh, dev, card)
        torch.cuda.empty_cache()
        print(f"mesh: (a) {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        mesh_serve(cfg, mesh, dev, card)
        torch.cuda.empty_cache()
        print(f"mesh: (b) {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        seq_sharded_case(dev, card)
        torch.cuda.empty_cache()
        print(f"mesh: (c) {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        rec = dryrun.run_mips_cell("pod", str(out_dir), device=dev,
                                   check_plain=True)
        if not rec.get("ok"):
            fail(f"mesh: the MIPS cell: {rec.get('error')}")
        print(f"mesh: dryrun MIPS pod ({rec['chips']} chips, "
              f"{rec['shards']} item x {rec['query_shards']} query shards "
              f"in process): {rec['num_buckets']} buckets (the reference "
              f"assumed {2_000_000 // 4}), build {rec['build_s']} s, query "
              f"{rec['run_s']} s, plain ids equal "
              f"{rec['plain_ids_equal']}, max err "
              f"{rec['plain_max_abs_err']:.3e}, collectives "
              f"{rec['collective_counts']}, wire bytes a device "
              f"{rec['collectives']['total_wire_bytes']:.6e}, cost "
              f"counters {rec['cost_counters']}, roofline {rec['roofline']}"
              f" [{card}]")
        print(f"mesh: (d) the MIPS cell {time.perf_counter() - t:.1f} s")
        torch.cuda.empty_cache()
        t = time.perf_counter()
        elastic_case(dev, card)
        print(f"mesh: (e) {time.perf_counter() - t:.1f} s")
        torch.cuda.synchronize()
        launches, shapes = dict(ops.launch_counts), dict(ops.launch_shapes)
    finally:
        tdist.destroy_process_group()
    idle = [k for k in MESH_KERNELS if launches[k] == 0]
    print(f"launches on the phase-12 path: "
          f"{ {k: launches[k] for k in ops.KERNELS} }")
    if idle:
        fail(f"kernels never launched on the phase-12 path: {idle}")
    t = time.perf_counter()
    collect_dryrun_cells(procs, out_dir, card)
    print(f"mesh: (d) the dry-run cells' wait {time.perf_counter() - t:.1f}"
          f" s")
    print(f"mesh: phase 12 {time.perf_counter() - t_phase:.1f} s")
    return launches, shapes


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.analysis import kernelcheck
    from repro_torch.core import hashing, planner, topk
    from repro_torch.core.engine import (QueryEngine, _directory_order,
                                         _planned_runs, engine_for)
    from repro_torch.core.index import IndexSpec, build
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import _build, ops
    from repro_torch.parallel.roofline import card_peaks

    # every reference product in this script runs in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device and build --------------------------------------------------
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    t = time.perf_counter()
    _build.build_all()
    print(f"build: kernels {time.perf_counter() - t:.2f} s")
    for name, log in _build.build_log.items():
        for func, used, spill in ptxas_report(log):
            print(f"  ptxas {name}: {func}: {used}; {spill}")

    # -- 2. main path ---------------------------------------------------------
    ds = make_dataset("imagenet", SEED, n=N_ITEMS, d=DIM,
                      num_queries=NUM_QUERIES)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    spec = IndexSpec(family="simple", code_len=32, m=32, scheme="percentile",
                     engine="fused", recall_target=RECALL_TARGET)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    t = time.perf_counter()
    idx = build(dataclasses.replace(spec, recall_target=None), ds.items, gen)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    t = time.perf_counter()
    idx = idx._replace(spec=spec, calib=planner.calibrate(idx,
                                                          generator=gen))
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t
    print(f"build: N={N_ITEMS} d={DIM} hash_bits={idx.hash_bits} "
          f"W={idx.codes.shape[1]} index {t_build:.3f} s, calibration "
          f"({planner.DEFAULT_CAL_QUERIES} queries) {t_cal:.3f} s")
    t = time.perf_counter()
    fused = engine_for(idx, engine="fused")       # what idx.query serves
    torch.cuda.synchronize()
    buckets = fused.buckets
    print(f"build: bucket store B={buckets.num_buckets} "
          f"{time.perf_counter() - t:.3f} s")
    plan = planner.resolve_budgets(idx.calib, RECALL_TARGET, k=K)
    budgets = plan.budgets
    print(f"plan: target {RECALL_TARGET} width {plan.num_probe} predicted "
          f"{plan.predicted_recall:.4f}")
    arms = {
        "fused": None,
        "fused_int8": QueryEngine(idx, engine="fused", quantized=True,
                                  buckets=buckets),
        "bucket": QueryEngine(idx, engine="bucket", buckets=buckets),
        "dense": QueryEngine(idx, engine="dense", buckets=buckets),
    }
    ms = {a: [] for a in arms}
    hits = {a: 0 for a in arms}
    truth_n = 0
    tie_diffs = 0
    for s in range(0, NUM_QUERIES, BATCH):
        qb = ds.queries[s:s + BATCH]
        out = {}
        for arm, eng in arms.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            if eng is None:
                out[arm] = idx.query(qb, k=K)     # the recall-target default
            else:
                out[arm] = eng.query(qb, K, budgets=budgets)
            torch.cuda.synchronize()
            ms[arm].append(1e3 * (time.perf_counter() - t))
        cb = arms["bucket"].candidates(qb, budgets=budgets)
        cd = arms["dense"].candidates(qb, budgets=budgets)
        if not torch.equal(cb, cd):
            fail(f"batch {s // BATCH}: bucket and dense candidate ids "
                 f"differ")
        fv, fi = out["fused"]
        sv, si = out["bucket"]
        tie_diffs += check_topk("fused vs staged", fi, fv, si, sv, qb,
                                ds.items)[1]
        _, truth = topk.exact_mips(qb, ds.items, K)
        truth_n += truth.numel()
        for arm, (_, ids) in out.items():
            hits[arm] += int((ids[:, :, None] == truth[:, None, :])
                             .any(1).sum())
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    shapes = dict(ops.launch_shapes)
    print(f"launches on the main path: "
          f"{ {k: launches[k] for k in SLICE1_KERNELS} }")
    idle = [op for op in SLICE1_KERNELS if launches[op] == 0]
    if idle:
        fail(f"kernels never launched on the main path: {idle}")
    for arm in arms:
        rec = hits[arm] / truth_n
        print(f"query: {arm:10s} recall@{K} {rec:.4f} median "
              f"{statistics.median(ms[arm]):.3f} ms/batch of {BATCH} "
              f"(first {ms[arm][0]:.3f} ms), width {plan.num_probe}")
        if rec < RECALL_TARGET - 0.05:
            fail(f"{arm} recall@{K} {rec:.4f} < {RECALL_TARGET - 0.05}")
    print(f"query: fused vs staged ids differ in {tie_diffs} tied slots")
    profile_batch(f"fused batch of {BATCH}",
                  lambda: idx.query(ds.queries[:BATCH], k=K))

    # -- 3. streaming ---------------------------------------------------------
    stream_launches, stream_shapes, st, mindex = streaming_phase(idx, ops,
                                                                 dev)

    # -- 4. kernels against their plain versions ------------------------------
    registry_checks(dev, "phase 4", launched=[
        k for sh in (shapes, stream_shapes) for k in sh])
    qb = ds.queries[:BATCH]
    fam = idx.family
    x = idx.items / idx.upper_eff[idx.range_id][:, None]
    tail = torch.sqrt(torch.clamp_min(1.0 - torch.sum(x * x, -1), 0.0))
    A, a_tail = idx.params[:-1], idx.params[-1]
    q_codes = fam.encode_queries(idx.params, qb)
    order = _directory_order(buckets, q_codes, fused._match_fn)
    total = plan.num_probe                        # budgets are clipped
    cum, starts = _planned_runs(buckets, order, budgets)
    items_csr, _, _ = fused._fused_arrays
    payload, scale = arms["fused_int8"]._fused_arrays[1:]
    n, d = x.shape
    n8 = n - n % 8
    L, W = idx.hash_bits, idx.codes.shape[1]
    kp = max(K, min(max(4 * K, 32), total))
    # what this batch's probes need: the runs that hold slots, the live
    # slots, the distinct rows they touch, and the k' survivors of each
    # phase 1 (their distinct f32 rows for the int8 rescore)
    runs = held_runs(cum, total)
    live = (torch.arange(total, device=dev)[None] < cum[:, -1:])
    slots = int(live.sum())
    probed = ops.bucket_gather(cum, starts, total, impl="ref")
    probed_rows = int(torch.unique(probed[live]).numel())

    def survivors(**extra):
        _, sp = ops.fused_query(qb, cum, starts, items_csr, total, kp,
                                kprime=kp, impl="ref", **extra)
        return int((sp >= 0).sum()), int(torch.unique(sp[sp >= 0]).numel())
    surv, _ = survivors()
    surv8, surv8_rows = survivors(payload=payload, scale=scale)
    fused_io = 4 * BATCH * d + 8 * runs + 8 * BATCH * K
    qn = hashing.normalize(qb)
    q_zeros = torch.zeros((BATCH,), device=dev)
    cases = {
        # each term one multiply and one add, rounded apart (no FMA)
        "hash_encode": dict(
            call=lambda impl: ops.hash_encode(x, A, tail, a_tail, impl=impl),
            bytes=4 * (n * d + d * L + n + L + n * W),
            ops=2 * n * d * L + 2 * n * L, op_rate=PEAK_OPS_NO_FMA,
            device=("hash_encode_kernel",),
            source="src/repro_torch/kernels/csrc/hash_encode.cu",
            replaces="src/repro/kernels/hash_encode.py:83"),
        # a query batch's encode, the shape of 97 of the path's launches
        "hash_encode_query": dict(
            call=lambda impl: ops.hash_encode(qn, A, q_zeros, a_tail,
                                              impl=impl),
            bytes=4 * (BATCH * d + d * L + BATCH + L + BATCH * W),
            ops=2 * BATCH * d * L + 2 * BATCH * L, op_rate=PEAK_OPS_NO_FMA,
            device=("hash_encode_kernel",), kernel="hash_encode",
            probe_of="hash_encode",
            source="src/repro_torch/kernels/csrc/hash_encode.cu",
            replaces="src/repro/kernels/hash_encode.py:83"),
        "hamming_scan": dict(
            call=lambda impl: ops.hamming_scan(q_codes, idx.codes,
                                               impl=impl),
            bytes=4 * (BATCH * W + n * W + BATCH * n),
            ops=2 * BATCH * n * W, ceiling=(BATCH, n),
            source="src/repro_torch/kernels/csrc/hamming.cu",
            replaces="src/repro/kernels/hamming.py:46"),
        # every output row sector-aligned: the odd-N gap, if any, shows
        "hamming_scan_aligned": dict(
            call=lambda impl: ops.hamming_scan(q_codes, idx.codes[:n8],
                                               impl=impl),
            bytes=4 * (BATCH * W + n8 * W + BATCH * n8),
            ops=2 * BATCH * n8 * W, ceiling=(BATCH, n8),
            kernel="hamming_scan", probe_of="hamming_scan",
            source="src/repro_torch/kernels/csrc/hamming.cu",
            replaces="src/repro/kernels/hamming.py:46"),
        "bucket_gather": dict(
            call=lambda impl: ops.bucket_gather(cum, starts, total,
                                                impl=impl),
            bytes=4 * (2 * runs + BATCH * total),
            ops=2 * slots, ceiling=(BATCH, total),
            device=("bucket_gather_kernel",),
            source="src/repro_torch/kernels/csrc/bucket_gather.cu",
            replaces="src/repro/kernels/bucket_probe.py:124"),
        # f32 phase 1: the payload is the rescore rows, with unit scales
        "fused_query": dict(
            call=lambda impl: ops.fused_query(qb, cum, starts, items_csr,
                                              total, K, impl=impl),
            bytes=fused_io + probed_rows * (4 * d + 4),
            ops=2 * (slots + surv) * d,
            source="src/repro_torch/kernels/csrc/fused_query.cu",
            replaces="src/repro/kernels/fused_query.py:156", cold=True),
        "fused_query_int8": dict(
            call=lambda impl: ops.fused_query(
                qb, cum, starts, items_csr, total, K, payload=payload,
                scale=scale, impl=impl),
            bytes=fused_io + probed_rows * (d + 4) + surv8_rows * 4 * d,
            ops=2 * (slots + surv8) * d,
            source="src/repro_torch/kernels/csrc/fused_query.cu",
            replaces="src/repro/kernels/fused_query.py:156", cold=True),
        "planned_runs": planned_runs_case(order, buckets, budgets, dev,
                                          plain_reps=3),
    }
    # the streaming path's kernels, at the shapes of its last state
    sq, hb = st["q_codes"], st["hash_bits"]
    sb, sc = st["bucket_code"].shape[0], st["csr_codes"].shape[0]
    cap = st["d_codes"].shape[0]
    nl = st["live_vecs"].shape[0]
    for name, db in (("bucket_match", st["bucket_code"]),
                     ("bucket_match_dense", st["csr_codes"])):
        rows_n = db.shape[0]
        cases[name] = dict(
            call=lambda impl, db=db: ops.bucket_match(sq, db, hb, impl=impl),
            bytes=4 * (BATCH * W + rows_n * W + BATCH * rows_n),
            ops=2 * BATCH * rows_n * W + BATCH * rows_n,
            kernel="bucket_match", ceiling=(BATCH, rows_n),
            source="src/repro_torch/kernels/csrc/hamming.cu",
            replaces="src/repro/kernels/bucket_probe.py:70")
    # the streaming bucket arm's gather: about one slot a run, P odd
    g_cum, g_starts = st["gather_cum"], st["gather_starts"]
    gp = st["probe_base"]
    g_runs = held_runs(g_cum, gp)
    g_slots = int(torch.clamp(g_cum[:, -1], max=gp).sum())
    cases["bucket_gather_stream"] = dict(
        call=lambda impl: ops.bucket_gather(g_cum, g_starts, gp, impl=impl),
        bytes=4 * (2 * g_runs + BATCH * gp),
        ops=2 * g_slots, ceiling=(BATCH, gp), kernel="bucket_gather",
        device=("bucket_gather_kernel",), stream=True,
        source="src/repro_torch/kernels/csrc/bucket_gather.cu",
        replaces="src/repro/kernels/bucket_probe.py:124")
    cases["delta_scan"] = dict(
        call=lambda impl: ops.delta_scan(sq, st["d_codes"], st["d_live"], hb,
                                         impl=impl),
        bytes=4 * (BATCH * W + cap * W + BATCH * cap) + cap,
        ops=2 * BATCH * cap * W + 2 * BATCH * cap, ceiling=(BATCH, cap),
        source="src/repro_torch/kernels/csrc/hamming.cu",
        replaces="src/repro/kernels/delta_scan.py:58")

    def library_topk():
        # one product and one top-k: two PyTorch calls, TF32 off
        return torch.topk(st["queries"] @ st["live_vecs"].T, K)
    cases["mips_topk"] = dict(
        call=lambda impl: ops.mips_topk(st["queries"], st["live_vecs"], K,
                                        impl=impl),
        bytes=4 * (BATCH * d + nl * d + 2 * BATCH * K),
        ops=2 * BATCH * nl * d, library=library_topk,
        source="src/repro_torch/kernels/csrc/mips_topk.cu",
        replaces="src/repro/kernels/mips_topk.py:93", cold=True)
    # yardsticks: one PyTorch call for part of a kernel's function (the
    # run index alone, the projection alone), not a library pair
    for label, c_, p_ in (("bucket_gather", cum, total),
                          ("bucket_gather_stream", g_cum, gp)):
        slot = torch.arange(p_, dtype=torch.int32, device=dev).expand(
            BATCH, -1).contiguous()
        body = c_[:, 1:].contiguous()
        y_ms = timed(lambda: torch.searchsorted(body, slot, right=True))
        print(f"yardstick: {label}: torch.searchsorted(cum[:, 1:], p, "
              f"right=True) {y_ms:.4f} ms at {tuple(slot.shape)}")
        del slot, body
    for label, xx in (("hash_encode", x), ("hash_encode_query", qn)):
        y_ms = timed(lambda: xx @ A)
        print(f"yardstick: {label}: x @ A (TF32 off) {y_ms:.4f} ms at "
              f"{tuple(xx.shape)} x {tuple(A.shape)}")
    print(f"kernel: streaming shapes: directory B={sb}, CSR rows {sc}, "
          f"delta capacity {cap}, live items {nl}")
    print(f"kernel: main-path batch: {slots} live probe slots over "
          f"{probed_rows} distinct rows, {runs} runs, k'={kp}; streaming "
          f"gather: {g_slots} live of {BATCH} x {gp} slots, {g_runs} runs "
          f"of {g_cum.shape[1] - 1} a query")
    rows = []
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    paths = {"main": (launches, shapes),
             "stream": (stream_launches, stream_shapes)}
    peaks = card_peaks(torch.cuda.get_device_name(dev))

    def k5_bound(kernel, shape, k, ms, path, row):
        """K5 at a path's launch shape: the kernel's cost's shares of the
        cold time go into ``row``; any finding is fatal."""
        b, found = kernelcheck.path_bound(kernel, shape, k, ms, peaks,
                                          f"at the {path} path's shape", dev)
        row["cost_share"] = {key: b[key] for key in (
            "flops", "hbm_bytes", "bound_ms", "ops_share", "bytes_share")}
        b_ms = 1e3 * b["hbm_bytes"] / peaks.hbm_bytes
        bshare = (f"fits L2 ({100 * b_ms / ms:.2f}% of the time at the "
                  f"memory rate)" if b["bytes_share"] is None
                  else f"{100 * b['bytes_share']:.2f}%")
        print(f"kernelcheck: K5 {kernel} at the {path} path's shape "
              f"{tuple(shape)}, k {k}: kernel cost {b['flops']:.6e} FLOPs, "
              f"{b['hbm_bytes']:.6e} bytes, bound {b['bound_ms']:.4f} ms "
              f"against cold {ms:.4f} ms: share of the bound: operations "
              f"{100 * b['ops_share']:.2f}%, bytes {bshare} [{smi}]")
        for f in found:
            print(f.format())
        if found:
            fail(f"{kernel}: K5 at the {path} path's shape: {len(found)} "
                 f"finding(s)")

    def compare(cases):
        """Each case's kernel against its plain version, timed and
        bounded; appends the rows. A row timed cold also holds the op's
        kernel cost to K5 at this shape (``k5_bound``)."""
        for name, c in cases.items():
            got, want = c["call"]("cuda"), c["call"]("ref")
            torch.cuda.synchronize()
            kernel = c.get("kernel", name)
            shape = ops.last_shape[kernel]
            k_out = got[0].shape[1] if isinstance(got, tuple) else 0
            if "check" in c:
                err, swaps = c["check"](got, want)
            elif name.startswith("fused_query"):
                err, swaps = check_topk(name, got[1], got[0], want[1],
                                        want[0], qb, items_csr)
            elif name == "mips_topk":
                err, swaps = check_topk(name, got[1], got[0], want[1],
                                        want[0], st["queries"],
                                        st["live_vecs"])
            else:
                if not torch.equal(got, want):
                    fail(f"{name}: kernel != plain version at the path's "
                         f"shape ({int((got != want).sum())} entries "
                         f"differ)")
                err, swaps = 0.0, 0
            del got, want
            k_ms = timed(lambda: c["call"]("cuda"))
            p_ms = timed(lambda: c["call"]("ref"),
                         reps=c.get("plain_reps", 10), warmup=1)
            lib_ms = timed(c["library"]) if "library" in c else None
            cold_ms = (kernelcheck.cold_ms(lambda: c["call"]("cuda"),
                                           flush) if c.get("cold") else None)
            ceil_ms = dev_ms = None
            if "ceiling" in c:
                fill = torch.empty(c["ceiling"], dtype=torch.int32,
                                   device=dev)
                ceil_ms = timed(lambda: fill.fill_(7))
                del fill
            profiled_row = "ceiling" in c or "device" in c
            if profiled_row:
                dev_ms = device_ms(lambda: c["call"]("cuda"),
                                   names=c.get("device", ("_kernel",)))
            t_bytes = c["bytes"] / PEAK_BYTES
            t_ops = c["ops"] / c.get("op_rate", PEAK_OPS)
            path = c.get("path") or ("stream" if c.get(
                "stream", kernel in ("bucket_match", "delta_scan",
                                     "mips_topk")) else "main")
            runs, path_shapes = paths[path]
            at_shape = path_shapes.get((kernel, shape), 0)
            row = {
                "name": name, "route": "cuda", "source": c["source"],
                "replaces": c["replaces"], "launches": at_shape,
                "launches_all": runs[kernel], "path": path,
                "kernel": kernel, "shape": list(shape),
                "max_abs_err": err, "ms": k_ms, "ms_cold": cold_ms,
                "device_ms": dev_ms, "ceiling_ms": ceil_ms,
                "plain_ms": p_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms, "parity": "ok"}
            if "op_rate" in c:
                row["op_rate"] = "no FMA: each multiply and add alone"
            if cold_ms is not None:
                k5_bound(kernel, shape, k_out, cold_ms, path, row)
            if "probe_of" in c:       # a probe shape goes inside its row
                owner = next(r for r in rows if r["name"] == c["probe_of"])
                owner[name] = {k: row[k] for k in (
                    "shape", "launches", "max_abs_err", "ms", "device_ms",
                    "ceiling_ms", "plain_ms", "bound_ms")}
            else:
                rows.append(row)
            lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
            lib += "" if cold_ms is None else f", cold {cold_ms:.4f} ms"
            lib += "" if ceil_ms is None else f", fill_ {ceil_ms:.4f} ms"
            lib += ("" if not profiled_row else ", device " + (
                "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"))
            by = row["bound_by"] + (" (no FMA)" if "op_rate" in c and
                                     row["bound_by"] == "operations" else "")
            print(f"kernel: {name} {k_ms:.4f} ms, plain {p_ms:.4f} ms{lib}, "
                  f"bound {row['bound_ms']:.4f} ms ({by}), "
                  f"{c['bytes']} bytes, {c['ops']} ops, max err {err}, "
                  f"tied swaps {swaps}, launches {at_shape} at {shape} "
                  f"({runs[kernel]} on its path) [{smi}]")

    compare(cases)
    # device time of each launch of the redesigned kernels
    redesigned = ("hash_encode", "hamming_scan", "bucket_gather",
                  "bucket_gather_stream", "delta_scan", "fused_query",
                  "fused_query_int8", "mips_topk")
    profile_batch("one call each of " + ", ".join(redesigned),
                  lambda: [cases[n]["call"]("cuda") for n in redesigned],
                  top=12)
    del cases, st
    cell_launches, cell_shapes, cell_cases = served_cell_phase(ops, dev, smi)
    paths["cell"] = (cell_launches, cell_shapes)
    compare(cell_cases)
    del cell_cases

    # -- 5. ALSH families, adaptive, multi-table, Fig. 2 ----------------------
    alsh_launches, alsh_shapes, alsh_cases = alsh_phase(
        ds, idx, arms["bucket"], ops, dev, smi)
    paths["alsh"] = (alsh_launches, alsh_shapes)
    compare(alsh_cases)
    del alsh_cases

    # -- 6. observability and the legacy shims --------------------------------
    obs_launches, obs_shapes, obs_cases = obs_phase(
        ds, idx, {**arms, "fused": fused}, budgets, mindex, ops, dev, smi)
    paths["obs"] = (obs_launches, obs_shapes)
    compare(obs_cases)
    del obs_cases

    # -- 7. LSH-decode serving at Qwen3-0.6B's width; distributed -------------
    serve_launches, serve_shapes, serve_cases, decode_ms = serve_phase(
        ds, idx, budgets, {a: arms[a] for a in ("bucket", "dense")}, ops,
        dev, smi)
    paths["serve"] = (serve_launches, serve_shapes)
    t_rows = time.perf_counter()
    compare(serve_cases)
    print(f"serve: phase 7 kernel rows {time.perf_counter() - t_rows:.1f} s")
    del serve_cases
    torch.cuda.empty_cache()

    # -- 8. every other config through the LSH vocabulary head ----------------
    model_phase(ops, dev, smi, compare, paths)
    torch.cuda.empty_cache()

    # -- 9. training at full width --------------------------------------------
    step_ms = train_phase(dev, smi)
    torch.cuda.empty_cache()

    # -- 10. ALS embeddings through RANGE-LSH ---------------------------------
    als_launches, als_shapes, als_cases = als_phase(ops, dev, smi)
    paths["als"] = (als_launches, als_shapes)
    compare(als_cases)
    del als_cases
    torch.cuda.empty_cache()

    # -- 11. the analysis layer -----------------------------------------------
    paths["analysis"] = analysis_phase(ops, dev, smi, paths, step_ms,
                                       decode_ms)
    torch.cuda.empty_cache()

    # -- 12. the mesh ---------------------------------------------------------
    paths["mesh"] = mesh_phase(ops, dev, smi)
    for row in rows:
        row["launches_by_path"] = {p_: runs_[row["kernel"]]
                                   for p_, (runs_, _) in paths.items()}
    print(f"chip_smoke: phases 1-12 {time.perf_counter() - t_start:.1f} s "
          f"[{smi}]")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
