#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one card, ``nvcc`` and
``nvidia-smi``; it builds the port's CUDA kernels from
``src/repro_torch/csrc`` and imports nothing of JAX or of the JAX package.
Phases, each printing one JSON line (any failure raises and the script
exits nonzero with no result line):

1. ``device``    the card, its count, name and power limit;
2. ``build``     one ``nvcc`` per source, started together;
3. ``parity``    each kernel against its plain PyTorch version on the card,
                 at the main path's shapes (build and merge kernels bit for
                 bit, estimators within float32 summation tolerance); the
                 hash/rank kernel's spread route, which single vectors
                 take, at n = 256, 30000 and 100000, on Fig. 10's vector,
                 an all-zero row and an unaligned row, against the batched
                 route on one row, and over a garbage histogram; B9's
                 first k rows of an m-row call against a k-row call and
                 its exact sums of small integers against the plain
                 version, bit for bit; B7's first k of 256 pairs against a
                 k-pair call, batched and broadcast, bit for bit; B2 on
                 the combined build's union positions at (512, 2^18)
                 (integer-valued keys, almost all equal) against
                 torch.kthvalue and the plain descent, bit for bit; B5's
                 moments mode at (64, 1024, 4) x (4096, 1024, 4) within
                 tolerance and bit-equal launch to launch, and at the
                 correlation matrix's (4096, 1024, 4) self-join (the
                 tiles on and above the diagonal, mirrored) bit-equal to
                 the join with a copy of the corpus on the B side, to
                 the 64-row launch on its first rows and to its own
                 transpose with x and y swapped;
4. ``main_path`` ``SketchIndex`` at its published widths (m=256,
                 n_buckets=512, slots=4, seed=11): 4032 vectors over
                 n=65536 with 2000 nonzeros each through ``add_many`` in
                 512-row blocks, 64 sparse ``add`` calls (D=4096), 256
                 planted near-duplicate queries (top-1 must be the
                 source), the quickstart's asserts, one ``all_pairs``
                 checked against ``query`` rows and exact squared norms,
                 four (128, 128) ``estimate_tile_rows`` tiles bit-equal to
                 their blocks of it, ``estimate_all_pairs`` on 64 rows
                 (kernel against the per-pair join);
5. ``threshold_path`` the same 4096 x 65536 corpus through
                 ``sketch_corpus(method="threshold", backend="kernel")`` in
                 512-row blocks, each bit-equal to the build on the
                 kernels' plain versions; mean size within 2% of m; every
                 row's self-estimate within 8/sqrt(m); the partitioned
                 build (P=4) against the one-shot build; the quickstart;
6. ``merge_path`` two more indexes ingest the corpus split by coordinate
                 at n/2 and ``merge_from`` folds one into the other: bit-equal
                 blocks, queries and ``all_pairs`` to the main path's index
                 on every row where neither partition dropped an entry;
7. ``matrix_path`` ``MatrixSketchStore(256, dim=16)`` at the widths of
                 ``benchmarks/matrix_product.py`` (n=65536 rows, d=16,
                 m=256, 512 buckets x 4 slots, seed 11; lognormal-scaled
                 Gaussian rows on support windows that overlap by 0.25):
                 1024 ``add``s, 64 queries by the partners of stored
                 matrices (each answer against the exact per-pair join on
                 every drop-free stored sketch, the partner's error
                 against the Frobenius guarantee), one ``products`` batch of
                 256 pairs against per-pair ``product``, the partitioned
                 build (P=4) against the one-shot build, the card's row
                 weight against the CPU's, the bucket-drop share;
8. ``join_size_path`` ``benchmarks/fig10_joinsize.py`` at its full
                 widths: Zipf (z=2) key-frequency tables of 500000 rows a
                 side over 30000 keys (overlap 0.3), 50 trials at a budget
                 of m=400; the TPC-H-like and Twitter-like panels with JL,
                 CS, TS/PS weighted and uniform; the served panel
                 (``SketchIndex(m=400, n_buckets=1024, head_h=16,
                 dp=DPParams(epsilon=4.0))``, plain / bias_aware /
                 private); the bias-aware CountSketch tail (h=16, 3
                 tables); Fig. 10's four gates, the tail within 0.5 of the
                 truth, the ledger (4.0 a release epoch, a cached release
                 free) and the release bit-equal to one made from CPU
                 copies with the same rng;
9. ``join_corr_path`` join correlation: ``benchmarks/fig6_join_corr.py``
                 at its full widths (60 correlated pairs, n=100000, 20000
                 nonzeros, overlap 0.1, a budget of 400 doubles: JL and CS
                 through the three-part linear estimator, PS/TS uniform
                 through ``empirical_correlation``, PS/TS weighted through
                 ``combined_sketch_corpus(backend="kernel")``, the legacy
                 builders' errors beside; each build bit-equal to its
                 plain version; gates ``weighted_best`` and
                 ``beats_linear``); a discovery corpus of 4096 columns
                 (``examples/join_correlation_discovery.py``'s generator,
                 64 groups of a query and 63 columns at planted rhos, over
                 2^18 keys, m=512) sketched in 512-row blocks (each
                 bit-equal to its plain build), its 4096 x 4096
                 ``correlation_matrix`` on B5's moments mode (1024
                 buckets x 4 slots; on the query rows the moments
                 within rtol 2e-5 of each pair's own scale of the
                 per-pair join on drop-free pairs, the correlation within
                 1e-4 where it is
                 conditioned; planted-pair error below 0.08; the top column at |rho| 0.75 for 60 of 64
                 queries); ``SketchedTableStore`` on one group against the
                 same store on CPU copies, and on the example's six
                 columns; the combined merge of two coordinate halves
                 against the CPU's merge;
10. ``discovery_path`` bound-pruned top-k discovery over one index
                 (``DiscoveryEngine``, ``SketchIndex.top_pairs`` /
                 ``top_k_for_query``: the corpus compacted once an index
                 change, the visited tile pairs in batches, one launch of
                 B5's tile-list join a batch) at
                 ``benchmarks/topk_discovery.py``'s FULL widths: 8192
                 Zipf(1.5)-scaled Gaussian columns over n = 16384 with 12
                 planted pairs (its generator, rng seed 8192), m = 256,
                 256 buckets x 2 slots, tiles of 64, k = 10, built through
                 ``add_many`` in 512-row blocks; ``top_pairs`` in both
                 modes bit-equal to ``all_pairs()`` plus the reference
                 tests' tie-broken sort, a launch reduction of at least 5x,
                 the peak working set at most 40 D m bytes and under the
                 dense matrix's, the Chebyshev ceiling launching no more
                 tiles (its recall printed); the same scans on the main
                 path's index (flat norms: most of its 2080 tile pairs
                 launch); on both, ``top_k_for_query`` bit-equal to one
                 one-row B5 launch plus the sort and equal by names
                 (estimates within rtol) to ``query(top_k=10)``; a copy
                 of the skewed index (``index_from_arrays``) appends 512
                 low-norm rows and its next scan refreshes only trailing
                 tiles and still equals ``all_pairs()`` plus the sort;
                 each scan launches the tile-list join once a batch of
                 its schedule, computes every visited tile pair and at
                 most 2 x visited + the first batch - 2 tiles, and no
                 plain B5 tile; its batches, tiles and device peak
                 (``torch.cuda.max_memory_allocated``) are printed beside
                 the reckoned peak bytes;
    ``join_tiles`` B5's tile-list join on both discovery corpora's scan
                 layouts: 133 tile pairs in one launch (the skewed
                 corpus's heaviest first), each tile bit-equal to
                 ``estimate_tile_rows``, every groups setting (1 to 16)
                 bit-equal, and within tolerance of the plain version;
11. ``sharded_path`` sharded serving (``ShardedSketchIndex`` in 4
                 shards, ``ShardedDiscoveryEngine``'s guarded fan-out in
                 worker threads on the card's stream,
                 ``partitioned_sketch_corpus_sharded``): the discovery
                 path's skewed corpus round-robin over 4 shards, its
                 ``top_pairs`` (plain, absolute, Chebyshev) and
                 ``all_pairs()`` bit-equal to the global index's (exact
                 ties aside for Chebyshev), ``top_k_for_query`` for 16
                 planted queries bit-equal to the global scan and equal
                 by names (within rtol) to ``query(top_k=10)``, one
                 cross-shard B5 tile against its plain route and the
                 global matrix's block; the main path's rows in 4 shards
                 (no tile prunes): ``top_pairs``, ``all_pairs`` and 64
                 queries bit-equal to the global index's; faults on the
                 skewed index: shard 1 raising ``ConnectionError`` under
                 ``RetryPolicy(attempts=2)`` (degraded, coverage as
                 reckoned from the shard sizes, every surviving true
                 top-10 pair found, its tasks tried twice), a
                 ``TimeoutError`` tried once, shard 0 killed (never
                 called) and revived (coverage 1.0); the partitioned
                 build as a one-rank NCCL group over a 512 x 65536 block
                 (priority bit-equal to the one-shot build, threshold
                 idx bit-equal and tau within rtol 1e-5);
12. ``resilience_path`` fault-tolerant serving and observability
                 (``repro_torch.obs`` enabled for the path, reset after):
                 ``ResilientSketchIndex`` over 4 coordinate shards at the
                 main path's widths (its 4096 vectors densified in
                 512-row blocks, its 256 planted queries) with 0, 1 and 2
                 shards down: coverage equal to the surviving share of
                 each query's energy (rtol 1e-6), at most delta = 0.05 of
                 the estimates beyond their widened bound; the degraded
                 4096 x 4096 ``all_pairs`` bit-equal to the surviving
                 shards' own sum and its bound held; strict mode
                 refusing, all shards down raising, a hung shard marked
                 down and counted; ``benchmarks/degraded_serving.py``'s
                 FULL_POINT sweep (max error over bound <= 1, coverage
                 monotone); ``DurableSketchIndex`` on the main path's data
                 (7 blocks, a snapshot, the last 448 rows, 64 sparse adds,
                 a torn journal tail) recovered bit-equal (blocks, row
                 summaries, 256 queries, ``top_pairs(10)``), again past a
                 quarantined snapshot, its time beside a rebuild's; the
                 reference's >= 3x recovery-over-rebuild gate at the
                 benchmark's recovery point; a durable index merging
                 three coordinate partitions' indexes, recovered through
                 B6 bit-equal; ``ResilientMatrixStore`` at the matrix
                 path's widths over 4 row shards (products of 256 pairs
                 and 64 queries, healthy and with a shard down: the
                 surviving shards' sum, the Frobenius bound held, healthy
                 within rtol of the CPU run); a canary inside its budget
                 healthy and outside it with 2 shards down; the
                 Prometheus text's counts equal to what the path did and
                 one Chrome trace event a finished span;
13. ``timing``   end-to-end and per-kernel CUDA-event times with each
                 kernel's bound, the per-step split of ``add_many``,
                 ``query``, ``all_pairs``, ``merge_from`` and the store's
                 ``query``, B5's compaction and join apart, and the
                 device-only times of the small kernels (raw launches in a
                 CUDA graph) beside their wrappers' times; B4 at both of
                 its shapes (4096 x 512 x 4, and the join panel's 2 x
                 1024 x 4) against its two bounds (the full stream, and the
                 bytes the query's work needs), B1 (l2 and uniform) and
                 B3 at the join path's (1, 30000), B3 at n = 100000, both
                 at n = 256 (the one-block floor), B1's two routes on one
                 row on each side of its boundary (n = 2^17, 2^18), B7 at
                 the store query's shape and at the products call's (256
                 batched pairs), B9 at (30000, 400) and (65536, 256) with
                 its column loop's instructions a term read from
                 ``cuobjdump -sass``, torch.kthvalue at B2's one-vector
                 shapes beside B2; the combined builds a 512-row block
                 (kernel, plain and legacy routes, threshold),
                 ``correlation_matrix`` at D = 4096 step by step, B5's
                 moments mode device-only against its bound, the square
                 self-join and the 64-row query launch apart, with the
                 join's blocks and warps an SM and shared memory a block
                 (``launch_shape``), B2 at the
                 union positions' shape, the table store's ``add_column``
                 and ``top_correlated``; discovery: each scan's wall time
                 (p50 of 5) with the share of it the tiles' device time
                 explains, B5's tile launch at (64, 64, 256, 2) and (64,
                 64, 512, 4) through ``estimate_tile_rows``, with its copy
                 to the host and device-only, beside its bound, and the
                 tile-list join at both shapes on the first 1, 8, 132 and
                 528 pairs of the scan order (device ms a launch and a
                 tile, the batch's wall time through ``scan_tile_batch``,
                 the bound), the heaviest tile at each groups setting and
                 the plain version at 132 pairs; one scan of each corpus
                 under ``torch.profiler`` (its kernels' device time
                 against its wall time);
                 ``top_k_for_query`` and ``query`` p50, ``all_pairs`` plus
                 the sort at D = 8192; sharded beside global on the same
                 rows (``top_pairs`` p50 with the fan-out in 8 threads
                 and in 1, ``top_k_for_query`` p50, tiles launched and
                 pruned, peak bytes, ``all_pairs``, and the flat scan in
                 8 threads and in 1);
14. ``train_path`` (runs right after ``build``, before ``parity``, on
                 the empty card) the training slice at gemma2-2b's widths
                 (d_model 2304, 8 / 4 heads of 256, d_ff 9216, vocab
                 256000, GeGLU, softcaps 50 / 30, window 4096, tied
                 embeddings, bfloat16), depth cut to 2 (one local and
                 one global attention group), SHAPES["train_4k"]'s
                 sequence of 4096, 2 sequences a step, random init:
                 4 dense ``train_loop`` steps on one fixed
                 ``SyntheticLM`` batch (lr 3e-3, no warmup, the
                 ``StepWatchdog`` on; the first loss within 0.5 of
                 ln(256000), every loss finite, the last below the
                 first), a ``Checkpointer`` round trip of the params and
                 AdamW state (bit-equal); SketchDP on a one-rank NCCL
                 group (``make_sketchdp_grad_fn``, error feedback,
                 m = n // 20; 3 threshold steps and 1 priority step;
                 losses finite, the last below the first, the residual
                 the flat gradient less the rank's own sketch; each
                 step's split by CUDA events: forward + backward,
                 flatten, sketch, gather, densify, optimizer); B3, B2
                 and B1 launched on the path; telemetry over 4
                 one-sequence microbatches (``sketch_grads`` at m = 2^16:
                 a pair's estimate within its Chebyshev half-width of the
                 exact inner product, ``gradient_noise_scale`` finite and
                 >= 0 with its gauges set); the reduced config with
                 m >= n equal to the dense gradient (rtol 3e-3, atol
                 2e-4).  Then, outside the path's count, B3, B1 and B2 at
                 the flat gradient's shape (1, n) against their plain
                 versions (B2 also against torch.kthvalue) and the kernel
                 route's threshold and priority sketches of the first
                 SketchDP step's flat gradient against the plain
                 versions, each kernel's device ms beside its bytes bound;
15. ``families_path`` (right after ``train_path``, before ``parity``) every
                 other model family at its published widths, the train
                 path's sequence, batch, seed and lr, bfloat16, random
                 init, each on a freed card: qwen2-moe-a2.7b (MoE, depth
                 2), mamba2-370m (SSD, full depth 48, chunk 256),
                 recurrentgemma-2b (RG-LRU, depth 5: one rglru / rglru /
                 attn_local period and the 2-layer tail), whisper-small
                 (encoder-decoder, full 12 + 12, frames (2, 1024, 768))
                 and phi-3-vision-4.2b (VLM, depth 2, 256 image
                 embeddings), 3 ``train_loop`` steps each on one fixed
                 batch (the first loss within 0.5 of ln V + 0.02^2 d / 2,
                 the init's random readout; every loss and every step's
                 gradient finite, the last loss below the
                 first, the MoE aux loss finite and > 0; step ms, tokens/s,
                 peak bytes; a fourth step's split, forward + backward
                 and AdamW, and one forward + backward under
                 ``torch.profiler``); SketchDP (threshold, m = n // 20,
                 one-rank NCCL group, error feedback) on mamba2-370m, the
                 first step (its collectives set up the group) and a
                 measured one (their splits; the residual the flat
                 gradient less the rank's own sketch; B3 and B2
                 launched); each family's reduced
                 config in float32 on the card against the CPU from the
                 same weights (loss within 1e-5, gradients within 1e-4 of
                 their scale);
16. ``serve_path`` (right after ``families_path``) LM serving through
                 ``prefill_fn`` / ``decode_fn`` / ``serve.Engine``, each
                 model freed before the next: (A) each of the ten reduced
                 configs in float32 (``wq`` / ``wk`` times 1/4) on the
                 card against the CPU from the same weights, a prefill of
                 48 tokens and 8 decode steps, the logits within 1e-5 of
                 their largest magnitude; (B) cache consistency at the
                 published widths of gemma2-2b, qwen2-moe-a2.7b,
                 mamba2-370m, recurrentgemma-2b, whisper-small and
                 phi-3-vision-4.2b (depths as the families path cuts
                 them, gemma2-2b as the train path), float32, B = 2,
                 decoder ``wq`` / ``wk`` times 1/4 (scores O(1)): the
                 last logits of ``prefill(t[:S])`` against
                 ``prefill(t[:S0], max_len=S)`` plus 16 decodes, rtol =
                 atol = 2e-2 (the reference's own), S0 = 4608 for
                 gemma2-2b and 2560 for recurrentgemma-2b (their local
                 rings wrap in prefill and in decode), 1024 otherwise;
                 qwen2-moe-a2.7b's capacity factor raised to E / k so
                 that nothing drops, mamba2-370m's full prefill at the
                 chunk that divides S (the SSD does not depend on it);
                 (C) the six at full published depth in bfloat16, random
                 init: ``Engine(batch_size=4, max_len=2048)`` serves 8
                 requests of seeded lengths in 8-1000, 32 new tokens each
                 (two waves), a second engine gives the same greedy
                 tokens, a temperature-1.0 wave repeats under one seed;
                 parameter and cache bytes, prefill ms, decode ms a step,
                 tokens/s, peak bytes and one traced decode step a
                 family; ``python -m repro_torch.launch.serve --arch
                 gemma2-2b`` once, on the card by default;
17. ``mesh_path`` (right after ``serve_path``) the LM sharding surface:
                 gemma2-2b at the train path's widths, depth and batch
                 (2 x 4096 tokens, bfloat16) placed by
                 ``param_shardings`` on a one-rank (1, 1) ("data",
                 "model") NCCL ``DeviceMesh``; one AdamW step on the
                 DTensors against the plain step on the same weights and
                 batch (loss, parameters and moments within a relative
                 1e-6; bit-equality reported), 3 timed steps of each
                 with their peak bytes beside the train path's dense
                 step, a SketchDP step over the mesh's data axis at
                 m = n / 20 (B3 and B2 launched), a sharded checkpoint of
                 the DTensor step restored onto the plain tree bit-equal;
18. ``dryrun_path`` ``python -m repro_torch.launch.dryrun`` in three
                 processes started together, on the card (fake tensors):
                 gemma2-2b ``train_4k`` on the (16, 16) mesh (depth 26 →
                 8), command-r-plus-104b ``decode_32k`` on (16, 16) (full
                 depth; ``serve_2d``, fsdp), qwen3-moe-235b-a22b
                 ``train_4k`` on (2, 16, 16) (depth 94 → 2), at published
                 widths: status ok, roofline terms > 0, 0 < useful-FLOPs
                 ratio <= 1, counted FLOPs >= 0.99 x model FLOPs,
                 parameter bytes a device x ranks >= the config's; each
                 cell's summary line, wall seconds and ``MemTracker``
                 peak beside the card's memory;
19. ``kernels``  one line per the port's kernel table.

Each path (4-12, 14-17) zeroes every kernel's launch counter (and the
tile-list join's tile count) before it runs and reads them after; each of
its kernels must have launched.  Each path's line gives its wall time
(``seconds``).

The last lines are ``nvidia-smi``'s name and power limit and then
``{"ok": true, "device": {...}}``.
"""
import collections
import contextlib
import dataclasses
import gc
import importlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12        # CUDA cores, outside the tensor cores
RTOL = 2e-5                   # estimates: float32 sums in another order

M, N_BUCKETS, SLOTS, SEED = 256, 512, 4, 11
N, NNZ, D_BATCH, D_SPARSE, BLOCK_ROWS = 65536, 2000, 4032, 64, 512
N_QUERIES = 256
CAP = 320                     # payload_capacity(256): threshold capacity
PARTITIONS = 4
# the matrix store: benchmarks/matrix_product.py's HEADLINE n and
# ACC_POINT d, m and overlap
MAT_N, MAT_D, MAT_M, MAT_OVERLAP = 1 << 16, 16, 256, 0.25
MAT_C, MAT_QUERIES, MAT_PAIRS = 1024, 64, 256
# the join-size path: benchmarks/fig10_joinsize.py's full run (its rng
# seed 7 draws the same tables) and its served panel's index and DP
JOIN_KEYS, JOIN_ROWS, JOIN_TRIALS, JOIN_M = 30_000, 500_000, 50, 400
JOIN_OVERLAP, JOIN_Z, JOIN_BUCKETS, JOIN_HEAD = 0.3, 2.0, 1024, 16
JOIN_EPS, JOIN_CLAMP, JOIN_P_FLOOR, CS_TAIL_REPS = 4.0, 1.0, 0.05, 3
MERGE_EPS = 1.0
# H100 SXM published int32 rate, non-tensor (NVIDIA H100 Tensor Core GPU
# Architecture white paper): 64 lanes an SM a clock, an IMAD as 2 ops
INT32_OPS_PER_S = 33.5e12
JL_INT_OPS = 10   # a term's index add, mix32's 8 operations, the sign bit
CS_TOL = 1e-5     # B8: rtol = atol (the reference's kernel test)
JL_TOL = 1e-4     # B9: rtol, and atol times max(1, max |out|)
# calls a wrapper time of B7 and B9 averages (host-bound, so it spreads)
WRAPPER_ITERS = 300
# the join-correlation path: benchmarks/fig6_join_corr.py's full run (its
# rng seed 3 draws the same pairs), and examples/join_correlation_
# discovery.py's generator (rng seed 1, the same first six columns) grown
# to 64 groups of 64 columns over its universe, m and store seed
CORR_N, CORR_NNZ, CORR_OVERLAP = 100_000, 20_000, 0.1
CORR_PAIRS, CORR_M = 60, 400
DISC_GROUPS, DISC_GROUP, DISC_KEYS = 64, 64, 200_000
DISC_UNIVERSE, DISC_M, DISC_SEED = 1 << 18, 512, 7
DISC_BUCKETS, DISC_SLOTS = 1024, 4
DISC_RHOS = (0.75, -0.55, 0.05, -0.2, 0.4)
EXAMPLE_NAMES = ("taxi_trips", "temperature", "precipitation", "pressure",
                 "wind", "humidity")
# a moments cell (b, a)'s channels from cell (a, b)'s: (n, sum_y, sum_x,
# xy, sum_y2, sum_x2)
MOMENT_SWAP = (0, 2, 1, 3, 5, 4)
CORR_GATE_RTOL = 1e-4      # kernel matrix vs the per-pair join
CORR_COND = 1e-2           # ... where both centered second moments are at
                           # least this share of the raw ones
PLANTED_ERR_GATE = 0.08    # mean |estimate - exact| on the planted pairs
TOP1_GATE = 60             # of 64 queries: the top column has |rho| 0.75
# the discovery path: benchmarks/topk_discovery.py's FULL point (its rng
# seed D draws the same corpus) and its gates
TOPK_D, TOPK_N, TOPK_M, TOPK_BUCKETS, TOPK_SLOTS = 8192, 16384, 256, 256, 2
TOPK_TILE, TOPK_K, TOPK_ZIPF, TOPK_PLANTED = 64, 10, 1.5, 12
TOPK_MIN_REDUCTION = 5.0   # tile pairs over tile launches
TOPK_BYTES_PER_SAMPLE = 40  # peak scan bytes over D m
TOPK_TAIL_SCALE = 1e-7     # appended rows, below every column's scale
TOPK_REPS, TOPK_QUERIES = 5, 20
# the sharded path: the discovery corpus and the main path's index in 4
# shards; planted queries of the skewed corpus, queries of the flat one
SHARDS, SHARD_QUERIES, FLAT_QUERIES = 4, 16, 64
# the resilience path: 4 coordinate (row) shards at the main path's (the
# matrix path's) widths; benchmarks/degraded_serving.py's FULL_POINT
# sweep (D, n, m, P), its losses and queries, and its recovery gate at
# FULL_RECOVERY_POINT (D, n, m) in 8 batches, the snapshot after 7
RES_SHARDS, RES_DELTA = 4, 0.05
DEG_POINT, DEG_QUERIES = (256, 1 << 15, 128, 8), 8
DEG_LOSSES = (0.0, 0.125, 0.25, 0.375, 0.5)
REC_POINT, REC_BATCHES, REC_SPEEDUP, REC_REPS = (512, 1 << 15, 128), 8, 3.0, 7
# the train path: gemma2-2b at its published widths, depth cut to 2 (one
# local and one global attention group), SHAPES["train_4k"]'s sequence,
# 2 sequences a step, random init; SketchDP at m = n // 20 (the
# reference's own convergence test); telemetry at m = 2^16 over 4
# one-sequence microbatches
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEED, TRAIN_LR = 2, 2, 0, 3e-3
TRAIN_DENSE_STEPS, TRAIN_MICRO, TRAIN_TELEM_M = 4, 4, 1 << 16
# the families path: each other family at its published widths (depth as
# below), the train path's sequence, batch, seed and lr, 3 steps a family
FAMILIES = (("qwen2-moe-a2.7b", 2), ("mamba2-370m", 48),
            ("recurrentgemma-2b", 5), ("whisper-small", 12),
            ("phi-3-vision-4.2b", 2))
FAMILY_STEPS = 3
# the serve path: (arch, depth for gate B, its S0); gate B decodes
# SERVE_TAIL tokens; gate C serves SERVE_REQUESTS requests at full depth
SERVE_FAMILIES = (("gemma2-2b", TRAIN_LAYERS, 4608),
                  ("qwen2-moe-a2.7b", 2, 1024), ("mamba2-370m", 48, 1024),
                  ("recurrentgemma-2b", 5, 2560), ("whisper-small", 12, 1024),
                  ("phi-3-vision-4.2b", 2, 1024))
SERVE_TAIL, SERVE_TOL = 16, 2e-2
SERVE_BATCH, SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_NEW = 4, 2048, 8, 32
# the mesh path: the train path's model, batch and seed on a one-rank
# (1, 1) ("data", "model") NCCL mesh; MESH_STEPS timed steps of each kind
MESH_STEPS = 3
# the dry run path: (arch, shape, mesh, config overrides); each cell at
# its published widths on a fake group of 256 / 512 ranks, the depth cut
# where the trace on the host would take minutes
DRYRUN_CELLS = (("gemma2-2b", "train_4k", "single", ("n_layers=8",)),
                ("command-r-plus-104b", "decode_32k", "single", ()),
                ("qwen3-moe-235b-a22b", "train_4k", "multi",
                 ("n_layers=2",)))
DRYRUN_TIMEOUT = 900


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_abs_err(got, ref) -> float:
    g, r = got.double(), ref.double()
    fin = torch.isfinite(r)
    check(bool(torch.equal(torch.isfinite(g), fin)), "finite masks differ")
    check(bool(torch.equal(g[~fin], r[~fin])), "non-finite values differ")
    return float((g[fin] - r[fin]).abs().max()) if bool(fin.any()) else 0.0


def assert_bits(got, ref, what: str) -> float:
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{what}: {got.dtype} {tuple(got.shape)} vs "
          f"{ref.dtype} {tuple(ref.shape)}")
    view = torch.int32 if got.element_size() == 4 else got.dtype
    ok = torch.equal(got.contiguous().view(view), ref.contiguous().view(view))
    check(ok, f"{what}: kernel and plain version differ in bits")
    return 0.0


def assert_close(got, ref, what: str) -> float:
    err = max_abs_err(got, ref)
    r = ref.double()
    fin = torch.isfinite(r)
    scale = max(1.0, float(r[fin].abs().max())) if bool(fin.any()) else 1.0
    ok = bool(((got.double() - r).abs()[fin]
               <= 2e-5 * scale + RTOL * r.abs()[fin]).all())
    check(ok, f"{what}: max abs err {err} beyond rtol={RTOL}, "
          f"atol={2e-5 * scale}")
    return err


def moment_scales(e: dict) -> dict:
    """Each pair's own scale for the six Eq. (9) channels, from the
    reference's moments in float64: a channel's sum of |terms|, or its
    Cauchy-Schwarz bound (sum |x|/p <= sqrt(n sum_x2), sum |x y|/p <=
    sqrt(sum_x2 sum_y2)).  A float32 sum in another order moves a
    channel by a share of it."""
    d = {k: v.double().abs() for k, v in e.items()}
    return {"n": d["n"], "sum_x2": d["sum_x2"], "sum_y2": d["sum_y2"],
            "sum_x": (d["n"] * d["sum_x2"]).sqrt(),
            "sum_y": (d["n"] * d["sum_y2"]).sqrt(),
            "xy": (d["sum_x2"] * d["sum_y2"]).sqrt()}


def assert_moments(got: dict, ref: dict, mask, what: str) -> float:
    """The six moment channels on the pairs of ``mask``, each pair held
    to ``RTOL`` times its own scale (:func:`moment_scales`): a pair with
    few matches is held as tightly as one with many.  -> the largest
    error as a share of its pair's scale."""
    scales = moment_scales(ref)
    worst = 0.0
    for k in ref:
        diff = (got[k].double() - ref[k].double()).abs()[mask]
        sc = scales[k][mask]
        check(bool((diff <= RTOL * sc).all()),
              f"{what}: moment {k} beyond rtol={RTOL} of its pair's scale "
              f"(max abs err {float(diff.max())})")
        rel = diff / torch.where(sc > 0, sc, torch.ones_like(sc))
        worst = max(worst, float(rel.max()) if rel.numel() else 0.0)
    return worst


def assert_tol(got, ref, rtol: float, atol: float, what: str) -> float:
    """``|got - ref| <= atol + rtol |ref|`` everywhere; the max abs error."""
    err = max_abs_err(got, ref)
    r = ref.double()
    ok = bool(((got.double() - r).abs() <= atol + rtol * r.abs()).all())
    check(ok, f"{what}: max abs err {err} beyond rtol={rtol}, atol={atol}")
    return err


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def step_ms(fn):
    """Host clock around one step, the device synchronised before and
    after: (its output, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def make_data(rng):
    """The main path's vectors as (indices, values), U(-1, 1) on 2000
    random coordinates of 65536 (as ``examples/serve_sketch_index.py``)."""
    total = D_BATCH + D_SPARSE
    idx = np.empty((total, NNZ), np.int64)
    for d in range(total):
        idx[d] = np.sort(rng.choice(N, NNZ, replace=False))
    val = rng.uniform(-1, 1, (total, NNZ)).astype(np.float32)
    return idx, val


def dense_rows(idx, val, rows) -> np.ndarray:
    out = np.zeros((len(rows), N), np.float32)
    np.put_along_axis(out, idx[list(rows)], val[list(rows)], axis=1)
    return out


def matrix_pair(c: int, dev):
    """Stored matrix ``c`` and its query partner, made on the card from
    seed 1000 + c as ``benchmarks/matrix_product.py::_pair``: N(0, 1)
    entries, lognormal(0, 1) row scales, A on the first 62.5% of the rows
    and B on the last 62.5% (they overlap on 25%)."""
    gen = torch.Generator(device=dev).manual_seed(1000 + c)
    lead = (1.0 - MAT_OVERLAP) / 2.0
    out = []
    for _ in range(2):
        X = torch.randn((MAT_N, MAT_D), generator=gen, device=dev)
        X *= torch.exp(torch.randn((MAT_N, 1), generator=gen, device=dev))
        out.append(X)
    out[0][int((lead + MAT_OVERLAP) * MAT_N):] = 0.0
    out[1][: int(lead * MAT_N)] = 0.0
    return out


def discovery_columns():
    """The discovery corpus as (keys, values) columns and each column's
    planted rho (NaN for a query): ``examples/join_correlation_
    discovery.py``'s generator, DISC_GROUPS groups of DISC_GROUP columns.
    Column 0 of a group is a query (5000 keys of [0, 200000), values
    N(100, 25)); columns 1..63 share 3000 of its keys, add 2000 of their
    own and carry the example's values at its rhos in turn.  The first
    six columns are the example's."""
    rng = np.random.default_rng(1)
    cols, rho = [], []
    for _ in range(DISC_GROUPS):
        q_keys = rng.choice(DISC_KEYS, 5000, replace=False)
        q_vals = rng.normal(100, 25, len(q_keys))
        cols.append((q_keys, q_vals))
        rho.append(np.nan)
        order = np.argsort(q_keys)
        for c in range(1, DISC_GROUP):
            r = DISC_RHOS[(c - 1) % len(DISC_RHOS)]
            shared = rng.choice(q_keys, 3000, replace=False)
            own = rng.choice(DISC_KEYS, 2000, replace=False)
            keys = np.concatenate([shared, own])
            base = q_vals[order][np.searchsorted(q_keys[order], shared)]
            z = rng.standard_normal(len(keys))
            vals = np.concatenate([r * (base - 100) / 25, np.zeros(2000)]) \
                + np.sqrt(max(1 - r ** 2, 0)) * z
            cols.append((keys, vals))
            rho.append(r)
    return cols, np.array(rho)


def topk_corpus() -> np.ndarray:
    """``benchmarks/topk_discovery.py::_corpus`` at its FULL point:
    (8192, 16384) N(0, 1) float32 rows scaled by 8 d^-1.5 (d = 1..D), row
    2i + 1 (i < 12) 0.9 times row 2i plus noise at its own scale."""
    rng = np.random.default_rng(TOPK_D)
    scales = (np.arange(1, TOPK_D + 1, dtype=np.float32)
              ** -TOPK_ZIPF) * 8.0
    X = rng.standard_normal((TOPK_D, TOPK_N), dtype=np.float32) \
        * scales[:, None]
    for i in range(TOPK_PLANTED):
        a, b = 2 * i, 2 * i + 1
        X[b] = 0.9 * X[a] + \
            0.3 * scales[b] * rng.standard_normal(TOPK_N).astype(np.float32)
    return X


def recovery_point(directory: str, dev):
    """``benchmarks/degraded_serving.py``'s FULL_RECOVERY_POINT as a
    crashed durable index in ``directory``: REC_POINT's (D, n) standard
    normal rows ingested through ``add_many`` in REC_BATCHES batches, a
    snapshot after the last but one, the journal closed.  Returns the
    names, the rows and the index's keyword arguments (a rebuild is one
    ``SketchIndex(**kw).add_many(names, rows)``)."""
    from repro_torch.serve import DurableSketchIndex
    D, n, m = REC_POINT
    V = np.random.default_rng(23).standard_normal((D, n)).astype(np.float32)
    names = [f"v{d}" for d in range(D)]
    batch = D // REC_BATCHES
    kw = dict(m=m, n_buckets=2 * m, seed=SEED, device=dev)
    dur = DurableSketchIndex(directory, **kw)
    for bi, lo in enumerate(range(0, D, batch)):
        dur.add_many(names[lo:lo + batch], V[lo:lo + batch])
        if bi == REC_BATCHES - 2:
            dur.snapshot()
    dur.journal.close()
    return names, V, kw


def true_top_pairs(est: np.ndarray, names, k: int,
                   absolute: bool = False) -> list:
    """The top k pairs i < j of a (D, D) estimate matrix in the order of
    ``tests/test_discovery.py::_true_pairs`` (descending score, ties by
    ascending (i, j)), without sorting all pairs: argpartition's k
    largest and every pair tied with the k-th, then the sort."""
    D = est.shape[0]
    score = np.abs(est) if absolute else est.copy()
    score[np.tri(D, dtype=bool)] = -np.inf
    flat = score.ravel()
    kth = flat[np.argpartition(-flat, k - 1)[:k]].min()
    cand = np.flatnonzero(flat >= kth)
    i, j = np.divmod(cand, D)
    order = np.lexsort((j, i, -flat[cand]))[:k]
    return [(names[i[o]], names[j[o]], float(est[i[o], j[o]]))
            for o in order]


def true_top_rows(est: np.ndarray, names, k: int) -> list:
    """The top k of one query's estimates, ties by ascending row."""
    order = np.lexsort((np.arange(est.size), -est))[:k]
    return [(names[i], float(est[i])) for i in order]


def same_ranking(got: list, want: list, what: str) -> float:
    """Two top-k lists of ``(name, estimate)`` from two estimator forms:
    estimates within ``RTOL`` position by position, names equal except a
    swap between estimates within that tolerance of each other.  -> the
    max abs difference."""
    g = torch.as_tensor([e for _, e in got], dtype=torch.float64)
    w = torch.as_tensor([e for _, e in want], dtype=torch.float64)
    err = assert_close(g, w, what)
    tol = 2e-5 * max(1.0, float(w.abs().max())) + RTOL * w.abs()
    by_name = dict(got)
    for i, (name, est) in enumerate(want):
        check(got[i][0] == name or (name in by_name and abs(
            by_name[name] - est) <= float(tol[i])),
            f"{what}: {name} at {i} is not in the scan's answer within "
            f"rtol={RTOL}")
    return err


def planted_exact(A: torch.Tensor) -> torch.Tensor:
    """Exact post-join Pearson correlation, in float64, of each group's
    query row with its 63 columns in a (groups x 64, n) block of column
    vectors -> (groups, 63)."""
    G = A.shape[0] // DISC_GROUP
    X = A.reshape(G, DISC_GROUP, -1).double()
    x, y = X[:, :1], X[:, 1:]
    mask = (x != 0) & (y != 0)
    w = mask.double()
    cnt = w.sum(dim=2)
    mx = (w * x).sum(dim=2) / cnt
    my = (w * y).sum(dim=2) / cnt
    dx, dy = (x - mx[..., None]) * w, (y - my[..., None]) * w
    return (dx * dy).sum(dim=2) / torch.sqrt(
        (dx * dx).sum(dim=2) * (dy * dy).sum(dim=2))


def linear_corr(sketch, est, a, b, m: int, seed) -> float:
    """Fig. 6's linear-sketch correlation: the budget split over sketches
    of a, a^2 and 1[a != 0] (m // 3 each), the six inner products, Eq. 9
    (``benchmarks/fig6_join_corr.py::_linear_corr``)."""
    third = max(m // 3, 8)
    parts = {tag: (sketch(va, third, seed), sketch(vb, third, seed))
             for tag, (va, vb) in {
                 "v": (a, b), "sq": (a * a, b * b),
                 "one": ((a != 0).float(), (b != 0).float())}.items()}

    def ip(ta, tb):
        return float(est(parts[ta][0], parts[tb][1]))

    n_est, sx, sy, xy = ip("one", "one"), ip("v", "one"), ip("one", "v"), \
        ip("v", "v")
    sx2, sy2 = ip("sq", "one"), ip("one", "sq")
    num = n_est * xy - sx * sy
    vx = max(n_est * sx2 - sx ** 2, 1e-9)
    vy = max(n_est * sy2 - sy ** 2, 1e-9)
    return float(np.clip(num / np.sqrt(vx * vy), -1, 1))


def samples_for_budget(m_doubles: int) -> int:
    """Sampling methods store (32-bit id, 64-bit value) pairs: 1.5 doubles
    a sample, so a budget of m doubles buys m / 1.5 samples
    (``benchmarks/common.py``)."""
    return max(int(m_doubles / 1.5), 4)


def drop_share(m: int, n_buckets: int, slots: int) -> float:
    """Chance that a sketch of m entries drops one in n_buckets x slots:
    bucket loads ~ Poisson(m / n_buckets), each must hold at most S."""
    lam = m / n_buckets
    fits = sum(math.exp(-lam) * lam ** j / math.factorial(j)
               for j in range(slots + 1))
    return 1.0 - fits ** n_buckets


def b4_needed_bytes(q_idx, c_idx) -> int:
    """Bytes one query against a (C, B, S) corpus needs read and written:
    the 32-byte sectors of corpus ids that hold a bucket the query
    occupies, the 32-byte sectors of corpus values of matched slots, the
    query whole (ids, values, tau), and per row its tau and its output."""
    C, B, S = c_idx.shape
    dev = c_idx.device
    bks = torch.nonzero((q_idx != 0x7FFFFFFF).any(dim=1)).flatten()
    start = (torch.arange(C, device=dev)[:, None] * B + bks[None, :]) * S * 4
    span = torch.arange((S * 4 + 31) // 32 + 1, device=dev)
    sec = start[..., None] // 32 + span
    sec = sec[sec <= ((start + S * 4 - 1) // 32)[..., None]]
    match = ((q_idx[None, :, :, None] == c_idx[:, :, None, :])
             & (q_idx != 0x7FFFFFFF)[None, :, :, None]).any(dim=2)
    val_sec = torch.nonzero(match.flatten()).flatten() * 4 // 32
    n_sectors = torch.unique(sec).numel() + torch.unique(val_sec).numel()
    return 32 * n_sectors + B * S * 8 + 4 + C * 8


def run_path(kernels, fn):
    """Zero every launch counter (and the tile-list join's tile count),
    run one path, read the counters; the path's output gets its wall
    seconds under ``"seconds"``."""
    for k in kernels:
        k.launches = 0
        if hasattr(k, "tiles"):
            k.tiles = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in kernels}
    counts.update({f"{k.__name__}.tiles": k.tiles for k in kernels
                   if hasattr(k, "tiles")})
    return out, counts


def schedule_batches(n_tiles: int, first: int, cap: int) -> int:
    """Batches of the discovery scans' schedule (``first`` pairs, then
    twice the last up to ``cap``) that cover ``n_tiles`` tile pairs: a
    scan's batches, the last perhaps cut short at the k-th score."""
    batches = total = 0
    size = first
    while total < n_tiles:
        total += size
        batches += 1
        size = min(2 * size, cap)
    return batches


def graph_ms(launch, reps: int = 50, replays: int = 5) -> float:
    """Device time of one raw kernel launch: ``reps`` launches (preallocated
    outputs, no wrapper) captured back to back into a CUDA graph, replayed
    under CUDA events, so the host's launch overhead is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            launch()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def sass_loop(lib_path, nvcc: str) -> dict:
    """The opcodes of the JL kernel's column loop, read from ``cuobjdump
    -sass`` of the built library: the backward branch whose body holds the
    most FADDs (one FADD a term), with its instructions a term."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]+)\*/\s+([^;]*);", sass)]

    def opcode(text):
        return re.sub(r"^@!?U?P[T0-9]+\s+", "", text).split()[0].split(".")[0]

    best = None
    for addr, text in ins:
        hit = re.search(r"\bBRA\s+0x([0-9a-f]+)", text)
        if not hit or int(hit[1], 16) >= addr:
            continue
        ops = [opcode(t) for a, t in ins if int(hit[1], 16) <= a <= addr]
        if best is None or ops.count("FADD") > best.count("FADD"):
            best = ops
    check(best is not None and best.count("FADD") > 0,
          "no column loop found in the JL kernel's SASS")
    terms = best.count("FADD")
    return {"loop_instructions": len(best), "terms_a_trip": terms,
            "instructions_a_term": len(best) / terms,
            "by_opcode": dict(collections.Counter(best).most_common())}


def quiet(fn, *args, **kw):
    """Call ``fn`` with its printed lines kept off this script's output."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def nccl_group(tag: str):
    """A one-rank NCCL group through a ``file://`` rendezvous under
    ``build/`` (as ``sharded_path``'s)."""
    import torch.distributed as dist
    from datetime import timedelta
    rdv = os.path.join(ROOT, "build", f"nccl_{tag}.{os.getpid()}")
    os.makedirs(os.path.dirname(rdv), exist_ok=True)
    if os.path.exists(rdv):
        os.remove(rdv)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0,
                            world_size=1, timeout=timedelta(seconds=120))
    return rdv


def sketchdp_step(grad_fn, hook, opt, params, opt_state, batch, ef,
                  step, split, keep=None):
    """One SketchDP step with CUDA events at each stage (``hook`` is
    the grad function's ``on_stage`` slot) and after the optimizer;
    ``keep`` gets a copy of the flat gradient plus the residual in, and
    the rank's own sketch."""
    evs = [("start", torch.cuda.Event(enable_timing=True))]
    evs[0][1].record()

    def mark(stage, tensors):
        if keep is not None and stage == "flatten":
            keep["flat_in"] = tensors["flat"].clone()
        if keep is not None and stage == "sketch":
            keep["sketch"] = (tensors["idx"], tensors["val"],
                              tensors["tau"])
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        evs.append((stage, ev))

    hook["fn"] = mark
    t0 = time.perf_counter()
    loss, grads, ef = grad_fn(params, batch, ef, step)
    params, opt_state, _ = opt.update(grads, opt_state, params)
    del grads
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    evs.append(("optimizer", ev))
    torch.cuda.synchronize()
    split.append({"step_ms": (time.perf_counter() - t0) * 1e3,
                  **{b[0]: a[1].elapsed_time(b[1])
                     for a, b in zip(evs, evs[1:])}})
    return float(loss), params, opt_state, ef


def trace_scan(fn, host: bool = True) -> dict:
    """One call (after a warm one) under ``torch.profiler``: its wall
    ms there, the summed device time of its kernels and their share
    of the wall time, and the ops with the most device and (``host``)
    the most host time (the profiler's own overhead is in the wall
    time).  Without ``host`` only the device is traced: a training
    step's ~10^5 host ops take the profiler tens of seconds to sum."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host
                                      else [])
    with profile(activities=acts) as prof:
        _, wall = step_ms(fn)
    evs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels_ = [e for e in evs if str(e.device_type).endswith("CUDA")]
    busy = sum(dev_us(e) for e in kernels_) / 1e3
    out = {
        "wall_ms_profiled": wall, "device_kernel_ms": busy,
        "device_busy_share": busy / wall if wall else 0.0,
        "kernel_launches": sum(e.count for e in kernels_),
        "kernels": {e.key: {"ms": dev_us(e) / 1e3, "calls": e.count}
                    for e in sorted(kernels_, key=dev_us)[::-1][:6]}}
    if host:
        out["host_ops"] = {
            e.key: {"self_cpu_ms": e.self_cpu_time_total / 1e3,
                    "calls": e.count}
            for e in sorted(evs, key=lambda e:
                            e.self_cpu_time_total)[::-1][:8]}
    return out


def family_batch(cfg, seq: int, batch: int, seed: int, dev) -> dict:
    """One fixed ``SyntheticLM`` batch with the frontend stubs
    (``frames``, ``image_embeds``: seeded N(0, 0.02^2)) where the config
    has them."""
    from repro_torch.data import SyntheticLM, frontend_stubs
    out = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed,
                      device=dev).batch_at(0)
    out.update(frontend_stubs(cfg, batch, seq, seed=seed, device=dev))
    return out


def train_family(cfg, seq: int, dev, keep_params: bool = False) -> dict:
    """``FAMILY_STEPS`` ``train_loop`` steps of ``cfg`` on one fixed batch
    of ``TRAIN_BATCH`` sequences (AdamW at ``TRAIN_LR``, no warmup, no
    decay) on a freed card, with the gates: the first loss within 0.5 of
    the init's ln V + 0.02^2 d_model / 2, every loss finite, every step's
    gradient finite (its global norm is), the last loss below the first,
    and for an MoE the load-balancing loss finite and > 0.  Then a fourth
    step's split (forward + backward and AdamW, CUDA events) and one
    forward + backward under ``torch.profiler`` (:func:`trace_scan`, the
    device only).  -> the family's line (and its parameters and batch
    under ``"_keep"`` when asked)."""
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models import param_leaves as lm_leaves
    from repro_torch.train import (adamw, make_train_step, train_loop,
                                   value_and_grad)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, TRAIN_SEED, device=dev)
    out = {"config": cfg.name, "family": cfg.family,
           "n_layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "seq_len": seq, "batch": TRAIN_BATCH,
           "tokens_per_step": TRAIN_BATCH * seq, "dtype": cfg.dtype,
           "params": sum(x.numel() for _, x in lm_leaves(params))}
    fixed = family_batch(cfg, seq, TRAIN_BATCH, TRAIN_SEED, dev)
    opt = adamw(TRAIN_LR, weight_decay=0.0)
    params, opt_state, hist = train_loop(
        cfg, params, opt.init(params), iter(lambda: fixed, None),
        make_train_step(cfg, opt), n_steps=FAMILY_STEPS, log_every=1,
        log_fn=lambda *_: None)
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    aux = [h["aux_loss"] for h in hist]
    lnv = math.log(cfg.vocab_size)
    # the init's first loss: a unit-RMS hidden state read out by N(0,
    # 0.02^2) embedding (or head) columns gives N(0, 0.02^2 d) logits,
    # whose cross-entropy over V classes is ln V + 0.02^2 d / 2
    want = lnv + 0.02 ** 2 * cfg.d_model / 2
    check(all(math.isfinite(v) for v in losses),
          f"{cfg.name}: losses not finite: {losses}")
    check(all(math.isfinite(v) for v in norms),
          f"{cfg.name}: a gradient leaf not finite (global norms {norms})")
    check(abs(losses[0] - want) < 0.5,
          f"{cfg.name}: first loss {losses[0]} not within 0.5 of ln(V) + "
          f"0.02^2 d / 2 = {want}")
    check(losses[-1] < losses[0],
          f"{cfg.name}: loss did not fall: {losses}")
    if cfg.n_experts:
        check(all(math.isfinite(v) and v > 0 for v in aux),
              f"{cfg.name}: aux_loss {aux}")
    # a fourth step's split by CUDA events (forward + backward, AdamW),
    # then one forward + backward under torch.profiler
    lfn = lambda p, b: loss_fn(cfg, p, b)  # noqa: E731
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    evs[0].record()
    _, grads = value_and_grad(lfn, params, fixed)
    evs[1].record()
    params, opt_state, _ = opt.update(grads, opt_state, params)
    evs[2].record()
    torch.cuda.synchronize()
    del grads, opt_state
    split = {"forward_backward_ms": evs[0].elapsed_time(evs[1]),
             "optimizer_ms": evs[1].elapsed_time(evs[2])}
    split["trace_forward_backward"] = trace_scan(
        lambda: value_and_grad(lfn, params, fixed), host=False)
    step_ms = [h["step_time_s"] * 1e3 for h in hist]
    med = float(np.median(step_ms[1:]))
    out.update(split=split, losses=losses, ln_vocab=lnv,
               first_loss_expected=want,
               first_loss_over_ln_vocab=losses[0] - lnv, grad_norms=norms,
               aux_losses=aux,
               step_ms=step_ms, step_ms_median=med,
               tokens_per_s=out["tokens_per_step"] * 1e3 / med,
               peak_bytes=torch.cuda.max_memory_allocated())
    if keep_params:
        out["_keep"] = (params, fixed)
    return out


def reduced_card_vs_cpu(arch: str, dev) -> dict:
    """``arch``'s reduced config in float32 on the card and on the CPU
    from the same weights (``init_params`` on the CPU, each attention
    group's ``wq`` / ``wk`` times 1/4 as the CPU parity tests take them:
    the scores O(1)) and the same batch (2 x 64, the stubs): the loss
    within 1e-5 max(1, |loss|) and each gradient leaf within 1e-4 of the
    CPU leaf's largest magnitude.  -> the errors."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models import param_leaves as lm_leaves
    from repro_torch.models.tree import tree_map
    from repro_torch.train import value_and_grad
    cfg = get_config(arch).reduced()
    params = init_params(cfg, TRAIN_SEED, device="cpu")
    for g in params["groups"].values():
        if "wq" in g:
            g["wq"] = g["wq"] * 0.25
            g["wk"] = g["wk"] * 0.25
    batch = family_batch(cfg, 64, 2, TRAIN_SEED, "cpu")
    lfn = lambda p, b: loss_fn(cfg, p, b)  # noqa: E731
    (c_loss, c_met), c_grads = value_and_grad(lfn, params, batch)
    (g_loss, g_met), g_grads = value_and_grad(
        lfn, tree_map(lambda x: x.to(dev), params),
        {k: v.to(dev) for k, v in batch.items()})
    loss_err = abs(float(g_loss) - float(c_loss))
    check(loss_err <= 1e-5 * max(1.0, abs(float(c_loss))),
          f"{cfg.name}: card loss {float(g_loss)} vs CPU {float(c_loss)}")
    worst, worst_path = 0.0, None
    for (path, c), (_, g) in zip(lm_leaves(c_grads), lm_leaves(g_grads)):
        scale = max(float(c.abs().max()), 1e-30)
        e = float((g.cpu() - c).abs().max()) / scale
        check(math.isfinite(e) and e <= 1e-4,
              f"{cfg.name}: gradient {'/'.join(path)} {e} of its scale "
              "from the CPU's")
        if e >= worst:
            worst, worst_path = e, "/".join(path)
    return {"config": cfg.name, "loss": float(c_loss),
            "loss_abs_err": loss_err,
            "aux_loss": [float(c_met["aux_loss"]),
                         float(g_met["aux_loss"])],
            "grad_max_rel_err": worst, "grad_worst_leaf": worst_path}


@contextlib.contextmanager
def expandable_segments():
    """The CUDA caching allocator's expandable segments for the block, fixed
    segments again after it (the cache emptied).  The two training paths
    run in it: they hold most of the card in a few 8 GB blocks (the fp32
    logits chunk and its backward), and on fixed segments the train
    path's SketchDP backward runs out of memory with 28 GiB reserved but
    free."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def families_path(dev, seq: int) -> dict:
    """Each family of ``FAMILIES`` at its published widths on sequences of
    ``seq`` (:func:`train_family`), SketchDP on mamba2-370m, and each
    family's reduced config on the card against the CPU
    (:func:`reduced_card_vs_cpu`), on :func:`expandable_segments`."""
    with expandable_segments():
        return _families(dev, seq)


def _families(dev, seq: int) -> dict:
    import torch.distributed as dist
    from repro_torch.configs import get_config as lm_config
    from repro_torch.core import INVALID_IDX
    from repro_torch.distributed import (compression_ratio, init_ef_state,
                                         make_sketchdp_grad_fn)
    from repro_torch.distributed.grad_compress import densify_mean, step_seed
    from repro_torch.kernels.sketch_build import build_threshold_corpus
    from repro_torch.models import loss_fn
    from repro_torch.models import param_leaves as lm_leaves
    from repro_torch.train import adamw
    out = {"families": []}
    for arch, depth in FAMILIES:
        cfg = dataclasses.replace(lm_config(arch), n_layers=depth)
        fam = train_family(cfg, seq, dev,
                           keep_params=arch == "mamba2-370m")
        out["families"].append(fam)
        if "_keep" not in fam:
            continue
        # SketchDP on the trained model: threshold, m = n // 20, a
        # one-rank NCCL group, error feedback; the first step (the
        # group's first collectives) and the measured one
        params, fixed = fam.pop("_keep")
        n = sum(x.numel() for _, x in lm_leaves(params))
        m = n // 20
        opt = adamw(TRAIN_LR, weight_decay=0.0)
        opt_state = opt.init(params)
        hook, keep, split, dp_losses = {}, {}, [], []
        rdv = nccl_group("families")
        try:
            fn = make_sketchdp_grad_fn(
                lambda p, b: loss_fn(cfg, p, b), m, method="threshold",
                on_stage=lambda st, t: hook["fn"](st, t))
            ef = init_ef_state(params)
            for i in range(2):
                loss, params, opt_state, ef = sketchdp_step(
                    fn, hook, opt, params, opt_state, fixed, ef, i,
                    split, keep if i == 0 else None)
                dp_losses.append(loss)
                if i:
                    continue
                idx, val, tau = keep.pop("sketch")
                sent = densify_mean(idx[None], val[None], tau[None], n)
                res_err = float((ef - (keep["flat_in"] - sent))
                                .abs().max())
                del sent
                # the rank's sketch (B3 and B2) against the plain
                # threshold build of the same flat gradient
                ps = build_threshold_corpus(keep["flat_in"][None], m,
                                            step_seed(0), device=dev,
                                            use_kernel=False)
                assert_bits(idx, ps.idx[0], f"{cfg.name} SketchDP idx")
                assert_bits(val, ps.val[0], f"{cfg.name} SketchDP val")
                tau_err = abs(float(tau) / float(ps.tau[0]) - 1)
                check(tau_err <= 1e-6, f"{cfg.name} SketchDP tau {float(tau)}"
                      f" vs plain {float(ps.tau[0])}")
                scale = float(keep.pop("flat_in").abs().max())
                size = int((idx != INVALID_IDX).sum())
                del idx, val, tau, ps
        finally:
            dist.destroy_process_group()
            if os.path.exists(rdv):
                os.remove(rdv)
        check(all(math.isfinite(v) for v in dp_losses),
              f"{cfg.name} SketchDP losses {dp_losses}")
        check(res_err <= 1e-6 * scale,
              f"{cfg.name}: residual != flat - sent: {res_err} "
              f"(scale {scale})")
        out["sketchdp"] = {
            "config": cfg.name, "n": n, "m": m, "method": "threshold",
            "losses": dp_losses, "sketch_size": size,
            "first_step_split_ms": split[0], "split_ms": split[1],
            "compression_ratio": compression_ratio(params, m),
            "residual_max_abs_err": res_err, "residual_scale": scale,
            "tau_rel_err_vs_plain": tau_err}
        del params, opt_state, fixed, ef, fn
    torch.cuda.empty_cache()
    out["reduced_card_vs_cpu"] = [reduced_card_vs_cpu(arch, dev)
                                  for arch, _ in FAMILIES]
    return out


def tree_bytes(tree) -> int:
    from repro_torch.models import param_leaves as lm_leaves
    return sum(x.numel() * x.element_size() for _, x in lm_leaves(tree))


def scale_scores(params, by: float = 0.25) -> dict:
    """Each decoder attention's ``wq`` and ``wk`` (self and cross) times
    ``by``, in place: the reference's init draws them at std
    1/sqrt(n_heads), which saturates the scores, and prefill and decode
    then drift apart with depth and length in both packages (whisper-small
    at 12 + 12: 3e-3 at 272 tokens on the CPU in the reference; 0.23 at
    1040 tokens on the card, run A28)."""
    for blocks in (params["groups"], params.get("tail", {})):
        for g in blocks.values():
            for att in (g, g.get("cross", {})):
                if "wq" in att:
                    att["wq"].mul_(by)
                    att["wk"].mul_(by)
    return params


def serve_reduced_card_vs_cpu(arch: str, dev) -> dict:
    """Gate A: ``arch``'s reduced config in float32 (:func:`scale_scores`),
    a prefill of 48 tokens (horizon
    56) and 8 decode steps on the card and on the CPU from the same
    weights: each step's logits within 1e-5 of their largest magnitude.
    -> the worst error over that magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.data import frontend_stubs
    from repro_torch.models import decode_fn, init_params, prefill_fn
    from repro_torch.models.tree import tree_map
    cfg = get_config(arch).reduced()
    params = scale_scores(init_params(cfg, TRAIN_SEED, device="cpu"))
    tokens = torch.as_tensor(np.random.default_rng(TRAIN_SEED).integers(
        0, cfg.vocab_size, (2, 56)).astype(np.int32))
    stubs = frontend_stubs(cfg, 2, 48, seed=TRAIN_SEED, device="cpu")
    runs = []
    for d in ("cpu", dev):
        p = tree_map(lambda x: x.to(d), params)
        logits, state = prefill_fn(cfg, max_len=56)(
            p, {"tokens": tokens[:, :48].to(d),
                **{k: v.to(d) for k, v in stubs.items()}})
        out = [logits.cpu()]
        step = decode_fn(cfg)
        for t in range(48, 56):
            logits, state = step(p, state, tokens[:, t:t + 1].to(d))
            out.append(logits.cpu())
        runs.append(out)
    worst = 0.0
    for i, (c, g) in enumerate(zip(*runs)):
        e = float((g - c).abs().max()) / float(c.abs().max())
        check(e <= 1e-5, f"{cfg.name}: step {i} logits {e} of their scale "
              "from the CPU's")
        worst = max(worst, e)
    return {"config": cfg.name, "steps": len(runs[0]),
            "logits_max_err_over_scale": worst}


def serve_cache_consistency(arch: str, depth: int, s0: int, dev) -> dict:
    """Gate B: ``arch`` at its published widths, ``depth`` layers, float32,
    B = 2: the last logits of ``prefill(t[:S])`` against
    ``prefill(t[:S0], max_len=S)`` followed by decodes of ``t[S0:S]``
    (S = S0 + SERVE_TAIL), rtol = atol = SERVE_TOL, on random weights
    with the scores scaled down (:func:`scale_scores`).  An MoE runs at the
    capacity factor E / k, where every expert's capacity is at least the
    tokens routed together, so nothing drops; an SSD's full prefill runs
    at the chunk that divides S (its output does not depend on the
    chunk), the split one at the published chunk."""
    from repro_torch.configs import get_config as lm_config
    from repro_torch.data import frontend_stubs
    from repro_torch.models import decode_fn, init_params, prefill_fn
    from repro_torch.models.moe import capacity
    free_card()
    cfg = dataclasses.replace(lm_config(arch), n_layers=depth,
                              dtype="float32")
    S = s0 + SERVE_TAIL
    out = {"config": cfg.name, "n_layers": depth, "batch": 2, "S0": s0,
           "S": S, "dtype": cfg.dtype}
    if cfg.n_experts:
        cf = cfg.n_experts / cfg.top_k
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
        caps = {t: capacity(t, cfg.top_k, cfg.n_experts, cf)
                for t in (2 * S, 2 * s0, 2)}
        check(all(c >= t for t, c in caps.items()),
              f"{cfg.name}: capacities {caps} below the routed tokens")
        out["moe"] = {"capacity_factor": cf, "capacity_by_tokens": caps,
                      "drops_possible": False}
    if cfg.window:
        out["window"] = cfg.window
        out["local_ring_wraps_in_prefill"] = s0 > cfg.window
    full_cfg = cfg
    if cfg.ssm_state and S % cfg.ssm_chunk:
        full_cfg = dataclasses.replace(cfg,
                                       ssm_chunk=math.gcd(cfg.ssm_chunk, S))
        out["full_prefill_ssm_chunk"] = full_cfg.ssm_chunk
    params = scale_scores(init_params(cfg, TRAIN_SEED, device=dev))
    tokens = torch.as_tensor(np.random.default_rng(TRAIN_SEED + 1).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32), device=dev)
    stubs = frontend_stubs(cfg, 2, S, seed=TRAIN_SEED, device=dev)
    full, _ = prefill_fn(full_cfg)(params, {"tokens": tokens, **stubs})
    _, state = prefill_fn(cfg, max_len=S)(
        params, {"tokens": tokens[:, :s0], **stubs})
    step = decode_fn(cfg)
    for t in range(s0, S):
        logits, state = step(params, state, tokens[:, t:t + 1])
    err = assert_tol(logits, full, SERVE_TOL, SERVE_TOL,
                     f"{cfg.name} prefill + {SERVE_TAIL} decodes")
    out.update(max_abs_err=err,
               max_err_over_scale=err / float(full.abs().max()),
               logits_scale=float(full.abs().max()))
    del params, state, full, logits
    return out


def free_card() -> None:
    """Collect what the last model left (an engine timed by
    :func:`_timed_engine` is in a reference cycle) and empty the
    allocator's cache."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _timed_engine(eng, log: dict):
    """Wrap ``eng``'s prefill, decode step and wave with host clocks (the
    device synchronised around each) into ``log``."""
    prefill, decode, wave = eng._prefill, eng._decode, eng.generate_wave

    def timed_prefill(params, batch):
        (logits, state), ms = step_ms(lambda: prefill(params, batch))
        log["prefill"].append({"tokens": list(batch["tokens"].shape),
                               "ms": ms})
        log["cache_bytes"] = tree_bytes(state)
        return logits, state

    def timed_decode(params, state, tok):
        out, ms = step_ms(lambda: decode(params, state, tok))
        log["decode_ms"].append(ms)
        return out

    def timed_wave(requests):
        before = [len(r.output) for r in requests[:eng.batch]]
        done, ms = step_ms(lambda: wave(requests))
        emitted = sum(len(r.output) for r in done) - sum(before)
        log["waves"].append({"requests": len(done), "ms": ms,
                             "tokens": emitted,
                             "tokens_per_s": emitted * 1e3 / ms})
        return done

    eng._prefill, eng._decode, eng.generate_wave = (
        timed_prefill, timed_decode, timed_wave)


def serve_family(arch: str, dev) -> dict:
    """Gate C: ``arch`` at full published depth in bfloat16, random init,
    on a freed card: an engine of SERVE_BATCH x SERVE_MAX_LEN serves
    SERVE_REQUESTS requests of seeded lengths in 8-1000 (two waves), each
    gets SERVE_NEW tokens below the vocabulary; a second engine on the
    same weights gives the same greedy tokens; a temperature-1.0 wave
    repeats under one seed.  Then a warm prefill of the first wave's shape
    and one decode step under ``torch.profiler`` (:func:`trace_scan`, the
    device only).  The peak bytes are counted from after the weights are
    made (``init_params`` draws each leaf in float32 first).  -> the
    family's line."""
    from repro_torch.configs import get_config as lm_config
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, Request
    free_card()
    cfg = lm_config(arch)
    params = init_params(cfg, TRAIN_SEED, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(TRAIN_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in rng.integers(8, 1001, SERVE_REQUESTS)]

    def requests(k=SERVE_REQUESTS):
        return [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW)
                for i, p in enumerate(prompts[:k])]

    def engine(**kw):
        return Engine(cfg, params, batch_size=SERVE_BATCH,
                      max_len=SERVE_MAX_LEN, device=dev, **kw)

    log = {"prefill": [], "decode_ms": [], "waves": []}
    eng = engine()
    _timed_engine(eng, log)
    done = eng.serve(requests())
    outs = [r.output for r in done]
    check(len(outs) == SERVE_REQUESTS and all(
        len(o) == SERVE_NEW and all(0 <= t < cfg.vocab_size for t in o)
        for o in outs), f"{cfg.name}: outputs {outs}")
    again = [r.output for r in engine().serve(requests())]
    check(again == outs, f"{cfg.name}: a second engine's greedy tokens "
          "differ")
    sampled = [[r.output for r in engine(temperature=1.0, seed=TRAIN_SEED)
                .serve(requests(SERVE_BATCH))] for _ in range(2)]
    check(sampled[0] == sampled[1], f"{cfg.name}: temperature-1.0 wave "
          "did not repeat under one seed")
    check(all(0 <= t < cfg.vocab_size for o in sampled[0] for t in o),
          f"{cfg.name}: a sampled token beyond the vocabulary")
    # a warm prefill of the first wave's shape, and one decode step traced
    batch = {"tokens": torch.zeros(tuple(log["prefill"][0]["tokens"]),
                                   dtype=torch.int32, device=dev)}
    if cfg.vision_tokens:
        batch["image_embeds"] = torch.zeros(
            (SERVE_BATCH, cfg.vision_tokens, cfg.d_model), device=dev)
    if cfg.is_encdec:
        batch["frames"] = torch.zeros(
            (SERVE_BATCH, max(batch["tokens"].shape[1] // cfg.enc_ratio, 1),
             cfg.d_model), device=dev)
    logits, state = eng._prefill(params, batch)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    decode = eng._decode
    traced = trace_scan(lambda: decode(params, state, tok), host=False)
    dec = log["decode_ms"][:-2]                 # the waves' own steps
    emitted = sum(w["tokens"] for w in log["waves"])
    out = {"config": cfg.name, "family": cfg.family,
           "n_layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "dtype": cfg.dtype, "batch": SERVE_BATCH,
           "max_len": SERVE_MAX_LEN,
           "prompt_lengths": [len(p) for p in prompts],
           "param_bytes": tree_bytes(params),
           "cache_bytes": log["cache_bytes"],
           "prefill": log["prefill"][:len(log["waves"])],
           "prefill_warm": log["prefill"][-1],
           "decode_steps": len(dec),
           "decode_ms_median": float(np.median(dec)),
           "decode_ms_min": float(np.min(dec)),
           "waves": log["waves"],
           "tokens_per_s": emitted * 1e3 / sum(w["ms"]
                                               for w in log["waves"]),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "trace_decode_step": traced,
           "greedy_outputs_head": [o[:8] for o in outs[:2]]}
    del params, eng, state, logits
    return out


def serve_path(dev) -> dict:
    """LM serving on the card: gates A (:func:`serve_reduced_card_vs_cpu`
    on the ten reduced configs), B (:func:`serve_cache_consistency`) and
    C (:func:`serve_family`) on the six families of ``SERVE_FAMILIES``,
    and ``python -m repro_torch.launch.serve --arch gemma2-2b`` as a
    subprocess on the card by default."""
    from repro_torch.configs import ARCH_IDS as LM_ARCHS
    out = {"reduced_card_vs_cpu": [serve_reduced_card_vs_cpu(a, dev)
                                   for a in LM_ARCHS]}
    out["cache_consistency"] = [
        serve_cache_consistency(arch, depth, s0, dev)
        for arch, depth, s0 in SERVE_FAMILIES]
    out["families"] = []
    for arch, _, _ in SERVE_FAMILIES:
        fam = serve_family(arch, dev)
        emit({"phase": "serve_path.family", **fam})
        out["families"].append(fam)
    free_card()
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma2-2b"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env={**os.environ, "PYTHONPATH": SRC})
    lines = [ln for ln in run.stdout.splitlines()
             if ln.startswith("request ")]
    check(run.returncode == 0 and len(lines) == 4,
          f"launch.serve exited {run.returncode}: {run.stdout[-2000:]} "
          f"{run.stderr[-2000:]}")
    out["launch_serve"] = {"argv": "--arch gemma2-2b", "lines": lines,
                           "seconds": time.perf_counter() - t0}
    return out


def mesh_path(dev) -> dict:
    """The LM sharding surface on the card: gemma2-2b at the train path's
    widths, depth and batch placed by ``param_shardings`` on a one-rank
    (1, 1) ("data", "model") NCCL ``DeviceMesh``; one AdamW step on the
    DTensors against the plain step on the same weights and batch (loss
    and every updated parameter and moment bit-equal), ``MESH_STEPS``
    timed steps of each beside their peak bytes, one SketchDP step over
    the mesh's data axis at m = n / 20 (B3 and B2), and a sharded
    checkpoint of the DTensor step's parameters and AdamW state restored
    onto the plain tree, bit-equal."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import SHAPES as LM_SHAPES
    from repro_torch.configs import get_config as lm_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import init_ef_state, make_sketchdp_grad_fn
    from repro_torch.distributed.sharding import (batch_shardings, gather,
                                                  opt_state_shardings,
                                                  param_shardings, place)
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models import param_leaves as lm_leaves
    from repro_torch.train import Checkpointer, adamw, make_train_step
    free_card()
    cfg = dataclasses.replace(lm_config("gemma2-2b"), n_layers=TRAIN_LAYERS)
    seq = LM_SHAPES["train_4k"]["seq_len"]
    out = {"config": cfg.name, "n_layers": cfg.n_layers, "seq_len": seq,
           "batch": TRAIN_BATCH, "dtype": cfg.dtype,
           "mesh": {"shape": [1, 1], "axes": ["data", "model"],
                    "backend": "nccl"}}
    rdv = nccl_group("mesh")
    ck_dir = os.path.join(ROOT, "build", f"mesh-ckpt-{os.getpid()}")
    try:
        with expandable_segments():
            mesh = init_device_mesh(dev.type, (1, 1),
                                    mesh_dim_names=("data", "model"))
            params = init_params(cfg, TRAIN_SEED, device=dev)
            batch = SyntheticLM(cfg.vocab_size, seq, TRAIN_BATCH,
                                seed=TRAIN_SEED, device=dev).batch_at(0)
            opt = adamw(TRAIN_LR, weight_decay=0.0)
            step = make_train_step(cfg, opt)
            p_sh = param_shardings(cfg, mesh)
            dparams = place(params, p_sh)
            dbatch = place(batch, batch_shardings(mesh, batch))

            def plain():
                return step(params, opt.init(params), batch)

            def sharded():
                state = place(opt.init(params),
                              opt_state_shardings(p_sh, mesh))
                return step(dparams, state, dbatch)

            times = {}
            for name, fn in (("plain", plain), ("dtensor", sharded)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ms = []
                for _ in range(MESH_STEPS + 1):
                    t0 = time.perf_counter()
                    res = fn()
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                times[name] = {"step_ms": ms,
                               "step_ms_median": float(np.median(ms[1:])),
                               "peak_bytes":
                                   torch.cuda.max_memory_allocated()}
                if name == "plain":
                    p1, s1, m1 = res
                else:
                    dp1, ds1, dm1 = res
                del res
            out["steps"] = times
            loss_p = float(m1["loss"])
            loss_d = float(gather({"l": dm1["loss"]})["l"])
            loss_rel = abs(loss_d - loss_p) / max(abs(loss_p), 1e-30)
            out["loss"] = {"plain": loss_p, "dtensor": loss_d,
                           "rel_err": loss_rel}
            check(math.isfinite(loss_p) and loss_rel <= 1e-6,
                  f"DTensor loss {loss_d} vs plain {loss_p}")
            full_p, full_s = gather(dp1), gather(ds1)
            worst = 0.0
            for (path, a), (_, b) in zip(lm_leaves(full_p), lm_leaves(p1)):
                check(a.dtype == b.dtype and a.shape == b.shape,
                      f"param {path}: {a.dtype}{tuple(a.shape)}")
                if not torch.equal(a, b):
                    rel = float(((a.float() - b.float()).abs().max())
                                / b.float().abs().max().clamp(min=1e-30))
                    worst = max(worst, rel)
            for tree_a, tree_b in ((full_s.mu, s1.mu), (full_s.nu, s1.nu)):
                for (path, a), (_, b) in zip(lm_leaves(tree_a),
                                             lm_leaves(tree_b)):
                    if not torch.equal(a, b):
                        rel = float((a - b).abs().max()
                                    / b.abs().max().clamp(min=1e-30))
                        worst = max(worst, rel)
            out["update_max_rel_err"] = worst
            out["bit_equal"] = worst == 0.0 and loss_rel == 0.0
            check(worst <= 1e-6, f"DTensor step's parameters or moments "
                  f"differ from the plain step's: max rel err {worst}")
            del full_s

            # SketchDP over the mesh's data axis
            n = sum(x.numel() for _, x in lm_leaves(params))
            m = n // 20
            grad_fn = make_sketchdp_grad_fn(
                lambda p, b: loss_fn(cfg, p, b), m, mesh=mesh,
                method="threshold")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dp_loss, mean, ef = grad_fn(params, batch, init_ef_state(params),
                                        0)
            torch.cuda.synchronize()
            dp_ms = (time.perf_counter() - t0) * 1e3
            finite = all(bool(torch.isfinite(g).all())
                         for _, g in lm_leaves(mean))
            check(math.isfinite(float(dp_loss)) and finite,
                  "SketchDP over the mesh: loss or gradient not finite")
            out["sketchdp"] = {"m": m, "n": n, "loss": float(dp_loss),
                               "step_ms": dp_ms,
                               "group_size": mesh.get_group(
                                   "data").size()}
            del mean, ef

            # sharded checkpoint, restored onto the plain tree
            shutil.rmtree(ck_dir, ignore_errors=True)
            ck = Checkpointer(ck_dir, keep=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(1, {"params": dp1, "opt_state": ds1})
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got_step, back = ck.restore({"params": p1, "opt_state": s1})
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            with open(os.path.join(ck_dir, "step_00000001",
                                   "manifest.json")) as f:
                shards = sum(len(e["shards"]) for e in
                             json.load(f)["leaves"])
            check(got_step == 1, f"restored step {got_step}")
            for tree_a, tree_b in ((back["params"], full_p),
                                   (back["opt_state"].mu, gather(ds1.mu)),
                                   (back["opt_state"].nu, gather(ds1.nu))):
                for (path, a), (_, b) in zip(lm_leaves(tree_a),
                                             lm_leaves(tree_b)):
                    check(type(a) is torch.Tensor and a.device == b.device
                          and torch.equal(a, b),
                          f"restored {path} differs from the saved DTensor")
            out["checkpoint"] = {"save_s": save_s, "restore_s": restore_s,
                                 "shard_files": shards, "bit_equal": True}
            del back, dp1, ds1, p1, s1, full_p, dparams, params
    finally:
        dist.destroy_process_group()
        if os.path.exists(rdv):
            os.remove(rdv)
        shutil.rmtree(ck_dir, ignore_errors=True)
        free_card()
    return out


def dryrun_path(dev) -> dict:
    """``python -m repro_torch.launch.dryrun`` for each of ``DRYRUN_CELLS``
    in its own process (the fake group of 256 / 512 ranks cannot share a
    process with an NCCL group), all started together, on the card by
    default (fake tensors, no allocation): each record's ``status`` ok,
    its roofline terms > 0, 0 < useful-FLOPs ratio <= 1, the FLOPs
    counted on rank 0 times the ranks >= 0.99 x the model FLOPs, the
    parameter bytes a device times the ranks >= the config's parameter
    bytes; each cell's summary line, wall seconds and ``MemTracker`` peak
    beside the card's memory."""
    from repro_torch.configs import get_config as lm_config
    from repro_torch.launch.dryrun import _apply_overrides, format_summary
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    out_dir = os.path.join(ROOT, "build", f"dryrun-{os.getpid()}")
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = []
    try:
        for arch, shape, mesh, over in DRYRUN_CELLS:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh,
                   "--out", out_dir]
            for o in over:
                cmd += ["--override", o]
            procs.append((arch, shape, mesh, over, time.perf_counter(),
                          subprocess.Popen(
                              cmd, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "PYTHONPATH": SRC})))
        cells = []
        for arch, shape, mesh, over, t0, proc in procs:
            try:
                so, se = proc.communicate(timeout=DRYRUN_TIMEOUT)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            wall = time.perf_counter() - t0
            check(proc.returncode == 0,
                  f"dryrun {arch} {shape} exited {proc.returncode}: "
                  f"{so[-1500:]} {se[-3000:]}")
            mesh_name = "pod2x16x16" if mesh == "multi" else "pod16x16"
            with open(os.path.join(out_dir, f"{arch}__{shape}__"
                                   f"{mesh_name}.json")) as f:
                rec = json.load(f)
            r = rec["roofline"]
            cfg = _apply_overrides(lm_config(arch), over)
            cfg_bytes = cfg.param_count() * 2
            check(rec["status"] == "ok", f"dryrun {arch}: {rec['status']}")
            check(min(r["compute_s"], r["memory_s"],
                      r["collective_s"]) > 0, f"dryrun {arch}: {r}")
            check(0 < r["useful_flops_ratio"] <= 1,
                  f"dryrun {arch}: useful {r['useful_flops_ratio']}")
            check(rec["cost_analysis_raw"]["flops_global"]
                  >= 0.99 * r["model_flops_global"],
                  f"dryrun {arch}: counted FLOPs "
                  f"{rec['cost_analysis_raw']['flops_global']} < 0.99 x "
                  f"{r['model_flops_global']}")
            check(rec["param_bytes_per_dev"] * r["chips"] >= cfg_bytes,
                  f"dryrun {arch}: {rec['param_bytes_per_dev']} x "
                  f"{r['chips']} < {cfg_bytes}")
            check(rec["device"] == "cuda", f"dryrun {arch} ran on "
                  f"{rec['device']}")
            peak = rec["memory_analysis"]["peak_bytes"]
            cells.append({
                "arch": arch, "shape": shape, "mesh": rec["mesh"],
                "overrides": list(over), "summary": format_summary(rec),
                "wall_s": wall, "trace_s": rec["lower_s"],
                "microbatches": rec.get("microbatches"),
                "memtracker_peak_bytes": peak,
                "memory_analysis": rec["memory_analysis"],
                "card_bytes": card_bytes, "peak_over_card": peak / card_bytes,
                "param_bytes_per_dev": rec["param_bytes_per_dev"],
                "config_param_bytes": cfg_bytes,
                "flops_dev_counted": rec["cost_analysis_raw"]["flops"],
                "collectives": rec["collectives"],
                "largest_collectives": rec["largest_collectives"],
                "roofline": r,
                "analytic": rec["analytic"]})
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"cells": cells}


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {os.path.basename(__file__)}: "
             "run from the root of a checkout")
    sys.path.insert(0, SRC)
    from repro_torch import quickstart
    from repro_torch.kernels import _build
    import repro_torch.kernels as tk
    from repro_torch.core import (INVALID_IDX, CombinedSketch, Sketch,
                                  combined_priority_sketch,
                                  combined_sketch_corpus,
                                  combined_estimates_matrix,
                                  combined_threshold_sketch,
                                  correlation_from_estimates,
                                  correlation_matrix, countsketch,
                                  countsketch_estimate,
                                  dp_chebyshev_halfwidth,
                                  empirical_correlation, estimate_all_pairs,
                                  estimate_inner_product,
                                  estimate_join_correlation, fold_seed,
                                  hash_bucket, hash_sign, hash_unit,
                                  jl_estimate, jl_sketch,
                                  merge_combined_sketches, priority_sketch,
                                  sampling_ranks, sketch_corpus,
                                  threshold_sketch, weight)
    from repro_torch.core.join_correlation import (
        _bucketized_moment_inputs, _family_ranks)
    from repro_torch.data import (SketchedTableStore, column_to_vector,
                                  correlated_pair, zipf_frequency_tables)
    from repro_torch.kernels.countsketch import countsketch_ref
    from repro_torch.kernels.jl_rademacher import (jl_row_seeds, jl_rows_ref,
                                                   jl_signs_ref)
    from repro_torch.private import (DPParams, bias_aware_cs_sketch,
                                     estimate_bias_aware_cs, head_split)
    from repro_torch.distributed import (partitioned_matrix_sketch,
                                         partitioned_sketch_corpus,
                                         partitioned_sketch_corpus_sharded)
    from repro_torch.engine import (build_payload_corpus, pack_payloads,
                                    payload_weight, to_matrix)
    from repro_torch.kernels.matrix_sketch import matrix_products_ref
    from repro_torch.matrix import (estimate_matrix_product,
                                    frobenius_error_guarantee,
                                    priority_matrix_sketch,
                                    threshold_matrix_sketch)
    from repro_torch.kernels.hash_rank import (hash_rank_batched_ref,
                                               hash_rank_ref)
    from repro_torch.kernels.hash_rank.hash_rank import spread_route
    from repro_torch.kernels.intersect_estimate import (
        MOMENT_CHANNELS, allpairs_compact_ref, allpairs_estimate_ref,
        allpairs_join_tiles_ref, intersect_estimate_ref)
    from repro_torch.kernels.intersect_estimate.intersect_estimate import (
        auto_groups, moments_join_shape)
    from repro_torch.kernels.sketch_build import (hash_rank_hist_ref,
                                                  kth_smallest_ranks_ref,
                                                  union_positions)
    from repro_torch.kernels.sketch_merge import merge_bucketized_ref
    from repro_torch.serve import (DegradedServiceError, DiscoveryEngine,
                                   DurableSketchIndex, MatrixSketchStore,
                                   ResilientMatrixStore, ResilientSketchIndex,
                                   RetryPolicy, ShardDownError,
                                   ShardedDiscoveryEngine,
                                   ShardedSketchIndex, SketchIndex,
                                   index_from_arrays, list_snapshots,
                                   load_snapshot, save_snapshot)
    from repro_torch import obs
    from repro_torch.obs import CanaryMonitor
    from repro_torch.distributed import partition_bounds
    from repro_torch.serve import discovery as disc_mod
    from repro_torch.serve.validation import check_finite, check_vector
    RES_RETRY = RetryPolicy(attempts=1, deadline=None)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    smi_line = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ----------------------------------------------------------------- build
    t0 = time.perf_counter()
    logs = _build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln] for k, v in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.BUILD_SECONDS, "ptxas": ptxas})

    # ------------------------------------------------------------ train path
    # (first of the paths, before the parity phase: it needs most of the
    # card's memory, and the card is empty here), on expandable segments
    # until its flat-gradient parity is done
    segments = contextlib.ExitStack()
    segments.enter_context(expandable_segments())
    kernels = tk.KERNELS
    launches = {}
    from repro_torch.configs import SHAPES as LM_SHAPES
    from repro_torch.configs import get_config as lm_config
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed import (compression_ratio, init_ef_state,
                                         make_sketchdp_grad_fn)
    from repro_torch.distributed.grad_compress import densify_mean, step_seed
    from repro_torch.kernels.sketch_build import build_threshold_corpus
    from repro_torch.models import flatten_params, init_params, loss_fn
    from repro_torch.models import param_leaves as lm_leaves
    from repro_torch.train import (Checkpointer, StepWatchdog, adamw,
                                   gradient_noise_scale, grad_inner_product,
                                   make_train_step, sketch_grads, train_loop,
                                   value_and_grad)

    lm_cfg = dataclasses.replace(lm_config("gemma2-2b"), n_layers=TRAIN_LAYERS)
    lm_seq = LM_SHAPES["train_4k"]["seq_len"]
    train_keep = {}

    def train_path():
        import torch.distributed as dist
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = {"config": lm_cfg.name, "n_layers": lm_cfg.n_layers,
               "d_model": lm_cfg.d_model, "vocab": lm_cfg.vocab_size,
               "seq_len": lm_seq, "batch": TRAIN_BATCH,
               "tokens_per_step": TRAIN_BATCH * lm_seq,
               "dtype": lm_cfg.dtype}
        params = init_params(lm_cfg, TRAIN_SEED, device=dev)
        n = sum(x.numel() for _, x in lm_leaves(params))
        # param_count() leaves out the norm gains
        out["params"] = n
        out["param_count_config"] = lm_cfg.param_count()
        fixed = SyntheticLM(lm_cfg.vocab_size, lm_seq, TRAIN_BATCH,
                            seed=TRAIN_SEED, device=dev).batch_at(0)
        lfn = lambda p, b: loss_fn(lm_cfg, p, b)  # noqa: E731

        # 1. dense train_loop, watchdog on, one checkpoint round trip
        opt = adamw(TRAIN_LR, weight_decay=0.0)
        wd = StepWatchdog()
        params, opt_state, hist = train_loop(
            lm_cfg, params, opt.init(params), iter(lambda: fixed, None),
            make_train_step(lm_cfg, opt), n_steps=TRAIN_DENSE_STEPS,
            watchdog=wd, log_every=1, log_fn=lambda *_: None)
        losses = [h["loss"] for h in hist]
        check(all(math.isfinite(v) for v in losses),
              f"dense losses not finite: {losses}")
        check(abs(losses[0] - math.log(lm_cfg.vocab_size)) < 0.5,
              f"first loss {losses[0]} not within 0.5 of ln(V) "
              f"{math.log(lm_cfg.vocab_size)}")
        check(losses[-1] < losses[0], f"dense loss did not fall: {losses}")
        check(wd.observed == TRAIN_DENSE_STEPS, "watchdog missed steps")
        dense_ms = [h["step_time_s"] * 1e3 for h in hist]
        out["dense"] = {"losses": losses, "step_ms": dense_ms,
                        "step_ms_median": float(np.median(dense_ms[1:])),
                        "stragglers": len(wd.straggler_events)}
        out["dense"]["tokens_per_s"] = (out["tokens_per_step"] * 1e3
                                        / out["dense"]["step_ms_median"])
        ck_dir = os.path.join(ROOT, "build", f"train-ckpt-{os.getpid()}")
        shutil.rmtree(ck_dir, ignore_errors=True)
        try:
            ck = Checkpointer(ck_dir, keep=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(TRAIN_DENSE_STEPS, {"params": params,
                                        "opt_state": opt_state})
            host_s = time.perf_counter() - t0
            ck.wait()
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            step, back = ck.restore({"params": params,
                                     "opt_state": opt_state})
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            ck_bytes = sum(os.path.getsize(os.path.join(dp, f))
                           for dp, _, fs in os.walk(ck_dir) for f in fs)
        finally:
            shutil.rmtree(ck_dir, ignore_errors=True)
        check(step == TRAIN_DENSE_STEPS, f"restored step {step}")
        check(torch.equal(back["opt_state"].step, opt_state.step),
              "restored optimizer step differs")
        check(all(torch.equal(a[1], b[1]) and a[1].dtype == b[1].dtype
                  for a, b in zip(lm_leaves(back["params"]),
                                  lm_leaves(params))),
              "restored params differ")
        check(all(torch.equal(a[1], b[1]) for tree_a, tree_b in
                  ((back["opt_state"].mu, opt_state.mu),
                   (back["opt_state"].nu, opt_state.nu))
                  for a, b in zip(lm_leaves(tree_a), lm_leaves(tree_b))),
              "restored AdamW moments differ")
        del back
        out["checkpoint"] = {"save_s": save_s, "host_copy_s": host_s,
                             "restore_s": restore_s, "bytes": ck_bytes,
                             "bit_equal": True}

        # 2. SketchDP on a one-rank NCCL group, m = n // 20
        m = n // 20
        rdv = nccl_group("train")
        try:
            ef = init_ef_state(params)
            split, dp_losses = [], []
            hook = {}
            fns = {method: make_sketchdp_grad_fn(
                lfn, m, method=method,
                on_stage=lambda s, t: hook["fn"](s, t))
                for method in ("threshold", "priority")}
            for i, method in enumerate(["threshold"] * 3 + ["priority"]):
                keep = train_keep if i == 0 else None
                loss, params, opt_state, ef = sketchdp_step(
                    fns[method], hook, opt, params, opt_state, fixed, ef, i,
                    split, keep)
                dp_losses.append(loss)
                if i == 0:
                    # the residual: the flat gradient less the rank's own
                    # sketch, densified
                    idx, val, tau = train_keep["sketch"]
                    sent = densify_mean(idx[None], val[None], tau[None], n)
                    res_err = float((ef - (train_keep["flat_in"] - sent))
                                    .abs().max())
                    scale = float(train_keep["flat_in"].abs().max())
                    del sent
                    # on the host until the parity below: 3 GB of the card
                    train_keep["flat_in"] = train_keep["flat_in"].cpu()
                    out["sketch_size"] = int((idx != INVALID_IDX).sum())
        finally:
            dist.destroy_process_group()
            if os.path.exists(rdv):
                os.remove(rdv)
        check(all(math.isfinite(v) for v in dp_losses),
              f"SketchDP losses not finite: {dp_losses}")
        check(dp_losses[-1] < dp_losses[0],
              f"SketchDP loss did not fall: {dp_losses}")
        check(res_err <= 1e-6 * scale,
              f"residual != flat - sent: {res_err} (scale {scale})")
        stages = ("grad", "flatten", "sketch", "gather", "densify",
                  "optimizer", "step_ms")
        med = {s: float(np.median([r[s] for r in split[1:]]))
               for s in stages}
        out["sketchdp"] = {
            "m": m, "methods": ["threshold"] * 3 + ["priority"],
            "losses": dp_losses, "steps": split,
            "step_ms_median": med["step_ms"],
            "split_ms_median": {s: med[s] for s in stages[:-1]},
            "tokens_per_s": out["tokens_per_step"] * 1e3 / med["step_ms"],
            "compression_ratio": compression_ratio(params, m),
            "residual_max_abs_err": res_err, "residual_scale": scale}
        del opt_state, ef
        out["peak_bytes_train"] = torch.cuda.max_memory_allocated()

        # 4. telemetry: 4 one-sequence microbatches' gradients
        mbs = SyntheticLM(lm_cfg.vocab_size, lm_seq, TRAIN_MICRO,
                          seed=TRAIN_SEED + 1, device=dev).batch_at(0)
        sketches, flats = [], []
        t0 = time.perf_counter()
        for i in range(TRAIN_MICRO):
            mb = {k: v[i:i + 1] for k, v in mbs.items()}
            _, g = value_and_grad(lfn, params, mb)
            sketches.append(sketch_grads(g, TRAIN_TELEM_M, step_seed(100)))
            if i < 2:
                flats.append(flatten_params(g)[0])
            del g
        torch.cuda.synchronize()
        telem_s = time.perf_counter() - t0
        est, half = grad_inner_product(sketches[0], sketches[1])
        exact = float(torch.dot(flats[0].double(), flats[1].double()))
        del flats
        check(abs(float(est) - exact) <= float(half),
              f"grad_inner_product {float(est)} beyond its half-width "
              f"{float(half)} of the exact {exact}")
        was_on = obs.enabled()
        obs.reset()
        obs.enable()
        try:
            gns = float(gradient_noise_scale(sketches, 1))
            reg = obs.registry()
            gauges = {k: reg.value(k) for k in (
                "repro_train_gns", "repro_train_gns_big_norm2",
                "repro_train_gns_small_norm2",
                "repro_train_gns_ci_halfwidth")}
        finally:
            obs.reset()
            if not was_on:
                obs.disable()
        check(math.isfinite(gns) and gns >= 0, f"GNS {gns}")
        check(gauges["repro_train_gns"] == gns
              and all(math.isfinite(v) for v in gauges.values()),
              f"GNS gauges {gauges}")
        out["telemetry"] = {"m": TRAIN_TELEM_M, "microbatches": TRAIN_MICRO,
                            "seconds": telem_s, "inner_product": float(est),
                            "exact": exact, "halfwidth": float(half),
                            "gns": gns, "gauges": gauges}
        del sketches
        train_keep["params"] = params

        # 5. exactness at the reduced config: m >= n, dense mean gradient
        rcfg = lm_config("gemma2-2b").reduced()
        rparams = init_params(rcfg, TRAIN_SEED, device=dev)
        rn = sum(x.numel() for _, x in lm_leaves(rparams))
        g = torch.Generator().manual_seed(TRAIN_SEED)
        rb = {"tokens": torch.randint(0, rcfg.vocab_size, (8, 32),
                                      generator=g).to(dev, torch.int32),
              "labels": torch.randint(0, rcfg.vocab_size, (8, 32),
                                      generator=g).to(dev, torch.int32),
              "mask": torch.ones((8, 32), device=dev)}
        rlfn = lambda p, b: loss_fn(rcfg, p, b)  # noqa: E731
        rdv = nccl_group("exact")
        try:
            rloss, rgrads, ref_ef = make_sketchdp_grad_fn(
                rlfn, rn + 64, method="threshold")(
                    rparams, rb, init_ef_state(rparams), 0)
        finally:
            dist.destroy_process_group()
            if os.path.exists(rdv):
                os.remove(rdv)
        (dloss, _), dgrads = value_and_grad(rlfn, rparams, rb)
        ex_err = assert_tol(flatten_params(rgrads)[0],
                            flatten_params(dgrads)[0], 3e-3, 2e-4,
                            "SketchDP m >= n mean gradient vs dense")
        check(abs(float(rloss) - float(dloss)) < 1e-4, "exact loss")
        check(float(ref_ef.abs().max()) < 1e-10, "residual at m >= n")
        out["exact_reduced"] = {"params": rn, "m": rn + 64,
                                "max_abs_err": ex_err,
                                "residual_max": float(ref_ef.abs().max())}
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        return out

    trp, launches["train_path"] = run_path(kernels, train_path)
    for kname in ("hash_rank", "radix_select", "hash_rank_hist"):
        check(launches["train_path"][kname] > 0,
              f"{kname} never launched on the train path: "
              f"{launches['train_path']}")
    params_t = train_keep.pop("params")
    del params_t

    # 3. the kernels at the flat gradient's shape against their plain
    # versions on the card (not counted: the path's run is over)
    flat = train_keep.pop("flat_in").to(dev)
    del train_keep["sketch"]
    torch.cuda.empty_cache()
    n_flat = flat.numel()
    m_flat = n_flat // 20
    seed0 = step_seed(0)
    fg = {"n": n_flat, "m": m_flat}

    def plain_hash_rank_chunks(vals, seed, hist=False):
        """hash_rank_ref's body over 2^26-coordinate chunks (the plain
        int64 hash of all n at once does not fit beside the rest)."""
        h = torch.empty_like(vals)
        r = torch.empty_like(vals)
        counts = torch.zeros(256, dtype=torch.int64, device=vals.device)
        for lo in range(0, vals.numel(), 1 << 26):
            hi = min(lo + (1 << 26), vals.numel())
            ids = torch.arange(lo, hi, dtype=torch.int32, device=vals.device)
            h[lo:hi] = hash_unit(seed, ids)
            r[lo:hi] = sampling_ranks(weight(vals[lo:hi], "l2"), h[lo:hi])
            if hist:
                counts += torch.bincount(
                    (r[lo:hi].view(torch.int32) >> 24).to(torch.int64),
                    minlength=256)
        return h, r, counts.to(torch.int32)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kh, kr = tk.hash_rank(flat, seed0)
    ph, pr, _ = plain_hash_rank_chunks(flat, seed0)
    fg["hash_rank_max_abs_err"] = max(assert_bits(kh, ph, "B3 h at n"),
                                      assert_bits(kr, pr, "B3 rank at n"))
    del kh, kr
    bh, brk, bhist = tk.hash_rank_hist(flat[None], seed0)
    ph2, pr2, phist = plain_hash_rank_chunks(flat, seed0, hist=True)
    fg["hash_rank_hist_max_abs_err"] = max(
        assert_bits(bh, ph2, "B1 h at n"), assert_bits(brk[0], pr2,
                                                       "B1 rank at n"),
        assert_bits(bhist[0], phist, "B1 histogram at n"))
    del bh, ph, ph2, pr2
    # B2: priority tau (k = m + 1 over the ranks, level 0 from B1) and the
    # threshold cutoff (k = n - m + 1 over the weights)
    wts = weight(flat, "l2")[None]
    sel = {"priority_tau": (brk, m_flat + 1, bhist),
           "threshold_cut": (wts, n_flat - m_flat + 1, None)}
    for what, (keys, k, h0) in sel.items():
        got = tk.radix_select(keys, k, hist0=h0)
        lib = torch.kthvalue(keys, k, dim=1).values
        plain = kth_smallest_ranks_ref(keys, k, hist0=h0)
        fg[f"radix_select_{what}_max_abs_err"] = max(
            assert_bits(got, lib, f"B2 {what} vs torch.kthvalue"),
            assert_bits(got, plain, f"B2 {what} vs the plain descent"))
        del lib, plain
    # the whole sketches: kernel route against the plain versions
    ks = build_threshold_corpus(flat[None], m_flat, seed0, device=dev)
    ps = build_threshold_corpus(flat[None], m_flat, seed0, device=dev,
                                use_kernel=False)
    assert_bits(ks.idx, ps.idx, "threshold sketch idx at n")
    assert_bits(ks.val, ps.val, "threshold sketch val at n")
    fg["threshold_tau_rel_err"] = abs(float(ks.tau[0]) / float(ps.tau[0]) - 1)
    check(fg["threshold_tau_rel_err"] <= 1e-6, "threshold tau at n")
    fg["threshold_size"] = int((ks.idx != INVALID_IDX).sum())
    del ks, ps
    kp = build_payload_corpus(flat[None], m_flat, seed0, method="priority",
                              device=dev)
    pp = build_payload_corpus(flat[None], m_flat, seed0, method="priority",
                              device=dev, use_kernel=False)
    for f in ("idx", "payload", "tau"):
        assert_bits(getattr(kp, f), getattr(pp, f), f"priority {f} at n")
    del kp, pp
    fg["parity_s"] = time.perf_counter() - t0
    # device times at the flat gradient's shape, beside the bytes bound
    nb4 = 4 * n_flat
    fg["hash_rank"] = {"ms": cuda_ms(lambda: tk.hash_rank(flat, seed0), 1, 3),
                       "plain_ms": cuda_ms(
                           lambda: plain_hash_rank_chunks(flat, seed0), 0, 1),
                       "bytes": 3 * nb4}
    fg["hash_rank_hist"] = {
        "ms": cuda_ms(lambda: tk.hash_rank_hist(flat[None], seed0), 1, 3),
        "plain_ms": cuda_ms(lambda: plain_hash_rank_chunks(
            flat, seed0, hist=True), 0, 1),
        "bytes": 3 * nb4 + 1024}
    for what, (keys, k, h0) in sel.items():
        fg[f"radix_select_{what}"] = {
            "k": k, "ms": cuda_ms(lambda: tk.radix_select(keys, k, hist0=h0),
                                  1, 3),
            "plain_ms": cuda_ms(lambda: kth_smallest_ranks_ref(
                keys, k, hist0=h0), 0, 1),
            "library_ms": cuda_ms(lambda: torch.kthvalue(keys, k, dim=1),
                                  0, 2),
            "bytes": nb4 + (1024 if h0 is not None else 0)}
    for key in ("hash_rank", "hash_rank_hist", "radix_select_priority_tau",
                "radix_select_threshold_cut"):
        fg[key]["bound_ms"] = fg[key]["bytes"] / HBM_BYTES_PER_S * 1e3
        fg[key]["share_of_bound"] = fg[key]["bound_ms"] / fg[key]["ms"]
    # (keys: the loop's last selection keys, the weights)
    del sel, wts, brk, bhist, flat, pr, keys, got
    segments.close()
    emit({"phase": "train_path", **trp, "flat_gradient": fg,
          "nvidia_smi": smi_line, "gates_passed": [
              "dense: first loss within 0.5 of ln(V), every loss finite, "
              "the last below the first; watchdog on every step",
              "checkpoint of params and AdamW state restored bit-equal",
              "SketchDP (threshold x3, priority x1, m = n // 20, error "
              "feedback): losses finite, the last below the first; the "
              "residual = the flat gradient less the rank's own sketch",
              "B3, B2, B1 launched on the path",
              "at the flat gradient's shape: B3, B1 (h, ranks, histogram) "
              "and B2 (priority tau, threshold cutoff) bit-equal to their "
              "plain versions (B2 to torch.kthvalue too); the kernel "
              "route's threshold sketch idx / val bit-equal, tau within "
              "rtol 1e-6; the priority sketch bit-equal",
              "telemetry: the pair's estimate within its Chebyshev "
              "half-width of the exact inner product; GNS finite, >= 0, "
              "gauges set",
              "reduced config, m >= n: the SketchDP mean gradient = the "
              "dense one (rtol 3e-3, atol 2e-4), residual < 1e-10"],
          "launches": launches["train_path"]})

    # --------------------------------------------------------- families path
    # (right after the train path, before the parity phase: each family
    # trains on a freed card)
    fam_out, launches["families_path"] = run_path(
        kernels, lambda: families_path(dev, lm_seq))
    for kname in ("hash_rank", "radix_select"):
        check(launches["families_path"][kname] > 0,
              f"{kname} never launched on the families path: "
              f"{launches['families_path']}")
    torch.cuda.empty_cache()
    emit({"phase": "families_path", **fam_out, "nvidia_smi": smi_line,
          "gates_passed": [
              "each family at its widths, 3 steps on one fixed batch: the "
              "first loss within 0.5 of ln(V) + 0.02^2 d / 2 (the init's "
              "random readout), every loss and every "
              "step's gradient finite, the last loss below the first; the "
              "MoE aux_loss finite and > 0",
              "mamba2-370m at full depth and chunk 256 trains",
              "SketchDP (threshold, m = n // 20, error feedback) on "
              "mamba2-370m: loss finite, the residual = the flat gradient "
              "less the rank's own sketch; the sketch's idx / val "
              "bit-equal to the plain threshold build of the same flat "
              "gradient, tau within rtol 1e-6; B3 and B2 launched",
              "each family's reduced config (float32) on the card = on the "
              "CPU: loss within 1e-5, every gradient leaf within 1e-4 of "
              "its scale"],
          "launches": launches["families_path"]})

    # ------------------------------------------------------------ serve path
    # (right after the families path, on the card they freed; no kernel of
    # the port is on this path: prefill and decode are matrix products)
    serve_out, launches["serve_path"] = run_path(
        kernels, lambda: serve_path(dev))
    torch.cuda.empty_cache()
    emit({"phase": "serve_path", **serve_out, "nvidia_smi": smi_line,
          "gates_passed": [
              "A: each reduced config (float32) on the card = on the CPU: "
              "prefill and 8 decode steps, logits within 1e-5 of their "
              "largest magnitude",
              "B: prefill(t[:S]) = prefill(t[:S0], max_len=S) + 16 "
              "decodes at published widths, float32, decoder wq / wk "
              "times 1/4, rtol = atol = 2e-2; gemma2-2b and "
              "recurrentgemma-2b past their windows",
              "C: six families at full depth in bfloat16: 8 requests x 32 "
              "tokens below the vocabulary, a second engine's greedy "
              "tokens equal, a temperature-1.0 wave repeats",
              "python -m repro_torch.launch.serve --arch gemma2-2b exits 0 "
              "with 4 requests served"],
          "launches": launches["serve_path"]})

    # ------------------------------------------------------------- mesh path
    # (after the serve path, on the card it freed)
    mesh_out, launches["mesh_path"] = run_path(kernels,
                                               lambda: mesh_path(dev))
    for kname in ("hash_rank", "radix_select"):
        check(launches["mesh_path"][kname] > 0,
              f"{kname} never launched on the mesh path: "
              f"{launches['mesh_path']}")
    emit({"phase": "mesh_path", **mesh_out,
          "train_path_dense_step_ms": trp["dense"]["step_ms_median"],
          "nvidia_smi": smi_line, "gates_passed": [
              "one AdamW step of gemma2-2b (depth 2, 2 x 4096 tokens, "
              "bfloat16) on DTensors over a (1, 1) NCCL mesh: the loss "
              "and every updated parameter and moment within a relative "
              "1e-6 of the plain step's (bit-equal reported)",
              "SketchDP over the mesh's data axis, m = n / 20: loss and "
              "gradient finite; B3 and B2 launched",
              "the sharded checkpoint of the DTensor step restored onto "
              "the plain tree bit-equal"],
          "launches": launches["mesh_path"]})

    # ----------------------------------------------------------- dryrun path
    t0 = time.perf_counter()
    dry_out = dryrun_path(dev)
    dry_out["seconds"] = time.perf_counter() - t0
    for cell in dry_out["cells"]:
        print(cell["summary"], f"| wall {cell['wall_s']:.1f} s | "
              f"MemTracker peak {cell['memtracker_peak_bytes'] / 2**30:.1f}"
              f" GiB of {cell['card_bytes'] / 2**30:.1f} GiB", flush=True)
    emit({"phase": "dryrun_path", **dry_out, "nvidia_smi": smi_line,
          "gates_passed": [
              "each cell: status ok; compute, memory and collective terms "
              "> 0; 0 < useful-FLOPs ratio <= 1; FLOPs counted on rank 0 "
              "times the ranks >= 0.99 x the model FLOPs; parameter bytes "
              "a device times the ranks >= the config's parameter bytes; "
              "traced on the card (fake tensors)"]})


    # the discovery corpus's columns (host numpy; the join-correlation
    # path sketches them, the parity phase takes B2's union-position keys
    # from its first block)
    disc_cols, disc_rho = discovery_columns()
    DISC_D = len(disc_cols)

    def disc_block(lo):
        """Columns lo .. lo + 511 as dense vectors on the card."""
        return torch.as_tensor(np.stack([
            column_to_vector(k, v, DISC_UNIVERSE)
            for k, v in disc_cols[lo:lo + BLOCK_ROWS]]), device=dev)

    # ---------------------------------------------------------------- parity
    err = {}
    gen = torch.Generator(device=dev).manual_seed(1234)

    def rand_block(rows, n):
        v = torch.rand((rows, n), generator=gen, device=dev) * 2 - 1
        keep = torch.rand((rows, n), generator=gen, device=dev) < NNZ / N
        return torch.where(keep, v, torch.zeros((), device=dev))

    traps = torch.tensor([1e-20, -1e-20, 1e-40, 1.1e-19, 1e19, -1e19, 1e20,
                          3e18], device=dev)

    def with_traps(x):
        pick = torch.rand(x.shape, generator=gen, device=dev) < 0.01
        return torch.where(pick, traps[torch.randint(
            0, len(traps), x.shape, generator=gen, device=dev)], x)

    blk = rand_block(BLOCK_ROWS, N)
    got = tk.hash_rank_hist(blk, SEED)
    ref = hash_rank_hist_ref(blk, SEED)
    for g, r, what in zip(got, ref, ("h", "rank", "hist")):
        assert_bits(g, r, f"hash_rank_hist {what}")
    for g, r, what in zip(tk.hash_rank_batched(blk, SEED),
                          hash_rank_batched_ref(blk, SEED), ("h", "rank")):
        assert_bits(g, r, f"hash_rank_batched {what}")
    ragged = with_traps(rand_block(BLOCK_ROWS, N + 77))
    for variant in ("l2", "l1", "uniform"):
        got = tk.hash_rank_hist(ragged, SEED, variant=variant)
        ref = hash_rank_hist_ref(ragged, SEED, variant=variant)
        for g, r, what in zip(got, ref, ("h", "rank", "hist")):
            assert_bits(g, r, f"hash_rank_hist {variant} ragged {what}")
        for g, r, what in zip(
                tk.hash_rank_batched(ragged, SEED, variant=variant),
                hash_rank_batched_ref(ragged, SEED, variant=variant),
                ("h", "rank")):
            assert_bits(g, r, f"hash_rank_batched {variant} ragged {what}")
    err["hash_rank_hist"] = 0.0
    err["hash_rank_batched"] = 0.0
    vec = with_traps(rand_block(1, 100_000)[0])
    for variant in ("l2", "l1", "uniform"):
        for g, r, what in zip(tk.hash_rank(vec, SEED, variant=variant),
                              hash_rank_ref(vec, SEED, variant=variant),
                              ("h", "rank")):
            assert_bits(g, r, f"hash_rank {variant} n=100000 {what}")
    # the spread route (csrc/sketch_build.cu), which every single vector
    # takes: B1 as one cluster launch that writes its histogram, B3 spread
    # over the SMs; each shape and variant bit-equal to the plain version,
    # with the traps, an all-zero row (every rank +inf), an unaligned row
    # (one row of an odd-width block), and one row of a block that takes
    # the batched route against the same row launched alone
    spread_cases = []
    odd = with_traps(rand_block(5, JOIN_KEYS + 1))
    wide = with_traps(rand_block(64, JOIN_KEYS))
    one_rows = [("n=256", vec[:256]), ("n=30000", vec[:JOIN_KEYS]),
                ("n=100000", vec), ("zeros n=30000", torch.zeros(
                    JOIN_KEYS, device=dev)), ("unaligned n=30001", odd[3]),
                ("row 5 of (64, 30000)", wide[5])]
    check(not spread_route(dev, *wide.shape),
          "the (64, 30000) block should take the batched route")
    for what, row in one_rows:
        n1 = int(row.shape[0])
        check(spread_route(dev, 1, n1) and spread_route(dev, 1, n1, hist=True),
              f"{what} should take the spread route")
        spread_cases.append([what, n1])
        for variant in ("l2", "l1", "uniform"):
            for g, r, out in zip(
                    tk.hash_rank_hist(row[None], SEED, variant=variant),
                    hash_rank_hist_ref(row[None], SEED, variant=variant),
                    ("h", "rank", "hist")):
                assert_bits(g, r, f"hash_rank_hist D=1 {what} {variant} {out}")
            for g, r, out in zip(tk.hash_rank(row, SEED, variant=variant),
                                 hash_rank_ref(row, SEED, variant=variant),
                                 ("h", "rank")):
                assert_bits(g, r, f"hash_rank {what} {variant} {out}")
    for variant in ("l2", "uniform"):
        _, r_wide, hist_wide = tk.hash_rank_hist(wide, SEED, variant=variant)
        _, r_one, hist_one = tk.hash_rank_hist(wide[5][None], SEED,
                                               variant=variant)
        assert_bits(r_one[0], r_wide[5], f"B1 routes {variant} rank")
        assert_bits(hist_one[0], hist_wide[5], f"B1 routes {variant} hist")
        assert_bits(tk.hash_rank(wide[5], SEED, variant=variant)[1],
                    tk.hash_rank_batched(wide, SEED, variant=variant)[1][5],
                    f"B3 routes {variant} rank")
    # a raw launch of the spread route into a histogram full of garbage:
    # the kernel writes every bin
    sb_lib = importlib.import_module(
        "repro_torch.kernels.sketch_build.sketch_build")._lib()
    g_h, g_r = torch.empty(JOIN_KEYS, device=dev), torch.empty(
        (1, JOIN_KEYS), device=dev)
    g_hist = torch.full((1, 256), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    _build.check(sb_lib.repro_hash_rank_hist(
        vec.data_ptr(), g_h.data_ptr(), g_r.data_ptr(), g_hist.data_ptr(), 1,
        JOIN_KEYS, SEED, 0, 1, torch.cuda.current_stream().cuda_stream),
        "repro_hash_rank_hist")
    assert_bits(g_hist, hash_rank_hist_ref(vec[None, :JOIN_KEYS], SEED)[2],
                "hash_rank_hist spread route over a garbage histogram")
    del odd, wide, r_wide, hist_wide, r_one, hist_one
    err["hash_rank"] = 0.0
    # B2 (radix_select) at the shapes the paths give it, each against
    # torch.kthvalue and the plain four-level descent, bit for bit: the
    # priority tau of a ragged block (with and without the level-0
    # histogram), adaptive tau's weight cutoff, the store add's (1, 65536)
    # row-weight ranks, the single vectors of the quickstart (n = 100000)
    # and of Fig. 10 (n = 30000, k = 267), the merge's (4096, 4098)
    # candidates, a per-row k
    _, rank_l2, hist0_l2 = tk.hash_rank_hist(ragged, SEED)
    W_l2 = weight(ragged, "l2")
    mat_ranks = sampling_ranks(payload_weight(matrix_pair(0, dev)[0][None],
                                              "l2"),
                               hash_unit(SEED, torch.arange(
                                   MAT_N, dtype=torch.int32, device=dev))[None])
    merge_keys = torch.rand((4096, 4098), generator=gen, device=dev)
    merge_keys[torch.rand(merge_keys.shape, generator=gen, device=dev)
               < 0.6] = torch.inf
    per_row_k = torch.randint(1, N + 78, (BLOCK_ROWS,), generator=gen,
                              device=dev)
    b2_cases = [
        ("priority tau, hist0", rank_l2, M + 1, hist0_l2),
        ("priority tau", rank_l2, M + 1, None),
        ("adaptive cutoff", W_l2, W_l2.shape[1] - M + 1, None),
        ("per-row k", rank_l2, per_row_k, None),
        ("store add", mat_ranks, MAT_M + 1, None),
        ("quickstart vector", tk.hash_rank(vec, SEED)[1][None], M + 1, None),
        ("fig10 vector", tk.hash_rank(vec[:JOIN_KEYS], SEED, variant=
                                      "uniform")[1][None], 267, None),
        ("merge candidates", merge_keys, M + 1, None)]
    for what, keys, k, h0 in b2_cases:
        got = tk.radix_select(keys, k, hist0=h0)
        want = torch.stack([torch.kthvalue(row, k if isinstance(k, int)
                                           else int(k[d])).values
                            for d, row in enumerate(keys)]) \
            if not isinstance(k, int) else torch.kthvalue(keys, k, dim=1).values
        assert_bits(got, want, f"radix_select {what} vs torch.kthvalue")
        assert_bits(got, kth_smallest_ranks_ref(keys, k, hist0=h0),
                    f"radix_select {what} vs the plain descent")
    # B2 on the combined build's union positions q at (512, 2^18) (the
    # discovery corpus's first block): integer-valued floats in [0, m+1],
    # almost all m+1, so the k-th key's top-byte bin holds nearly every
    # key of a row (far over the on-chip candidate buffer)
    _, _, q_ranks = _family_ranks(disc_block(0), DISC_SEED)
    q_keys, _ = union_positions(q_ranks, DISC_M)
    del q_ranks
    q_head = int((q_keys < DISC_M + 1).sum(dim=1).max())
    for k in (DISC_M + 1, 1, q_keys.shape[1]):
        got = tk.radix_select(q_keys, k)
        assert_bits(got, torch.kthvalue(q_keys, k, dim=1).values,
                    f"radix_select union positions k={k} vs torch.kthvalue")
        assert_bits(got, kth_smallest_ranks_ref(q_keys, k),
                    f"radix_select union positions k={k} vs the plain "
                    "descent")
    err["radix_select"] = 0.0
    del rank_l2, hist0_l2, W_l2, mat_ranks, merge_keys

    corpus_blocks = [tk.bucketize_corpus(
        tk.build_priority_corpus(rand_block(BLOCK_ROWS, N), M, SEED,
                                 device=dev),
        n_buckets=N_BUCKETS, slots=SLOTS) for _ in range(8)]
    pc = tk.BucketizedSketch(*(torch.cat(parts) for parts in
                               zip(*corpus_blocks)))
    q = tk.BucketizedSketch(*(x[17] for x in pc))
    pc_shape = tuple(pc.idx.shape)
    got = tk.intersect_estimate(q.idx, q.val, q.tau, pc.idx, pc.val, pc.tau)
    err["intersect_estimate"] = assert_close(
        got, intersect_estimate_ref(q.idx, q.val, q.tau, pc.idx, pc.val,
                                    pc.tau), "intersect_estimate C=4096")
    b4_err = {"served": err["intersect_estimate"]}
    assert_bits(tk.intersect_estimate(q.idx, q.val, q.tau, pc.idx, pc.val,
                                      pc.tau), got,
                "intersect_estimate C=4096, run to run")
    sub = tk.BucketizedSketch(*(x[:512] for x in pc))
    p_sub = tk.slot_inclusion_probs(sub)
    e_plain = assert_close(
        tk.allpairs_estimate(sub.idx, sub.val, p_sub, sub.idx, sub.val,
                             p_sub),
        allpairs_estimate_ref(sub.idx, sub.val, p_sub, sub.idx, sub.val,
                              p_sub, ct=64), "allpairs_estimate 512x512")
    got_m = tk.allpairs_estimate(sub.idx, sub.val, p_sub, sub.idx, sub.val,
                                 p_sub, moments=True)
    ref_m = allpairs_estimate_ref(sub.idx, sub.val, p_sub, sub.idx, sub.val,
                                  p_sub, moments=True, ct=64)
    e_mom = max(assert_close(got_m[..., c], ref_m[..., c],
                             f"allpairs moments channel {c}")
                for c in range(6))
    assert_bits(tk.allpairs_estimate(sub.idx, sub.val, p_sub, sub.idx,
                                     sub.val, p_sub, moments=True), got_m,
                "allpairs moments, run to run")
    err["allpairs_estimate"] = max(e_plain, e_mom)
    # the compaction pass against its plain version, up to each count
    # (entries past a count are unspecified on the card)
    p_c4096 = tk.slot_inclusion_probs(pc)
    got_c = tk.allpairs_compact(pc.idx, pc.val, p_c4096)
    ref_c = allpairs_compact_ref(pc.idx, pc.val, p_c4096)
    assert_bits(got_c[1], ref_c[1], "allpairs_compact counts")
    used = (torch.arange(ref_c[0].shape[2], device=dev)[None, None, :]
            < ref_c[1][..., None])
    assert_bits(got_c[0][used], ref_c[0][used], "allpairs_compact entries")
    err["allpairs_compact"] = 0.0
    del corpus_blocks, pc, sub, got_m, ref_m, got_c, ref_c, used, p_c4096
    # B5's moments mode at the correlation matrix's layout, (64, 1024, 4)
    # x (4096, 1024, 4): the combined sketches (m = 512) of 4096 random
    # rows, their inclusion probabilities as payloads
    cs = [tk.build_combined_priority_corpus(rand_block(BLOCK_ROWS, N),
                                            DISC_M, DISC_SEED, device=dev)
          for _ in range(8)]
    mom = _bucketized_moment_inputs(CombinedSketch(*(
        torch.cat(f) for f in zip(*cs))), DISC_BUCKETS, DISC_SLOTS)[:3]
    mom_q = tuple(x[:64].contiguous() for x in mom)
    got_m = tk.allpairs_moments(*mom_q, *mom)
    ref_m = allpairs_estimate_ref(*mom_q, *mom, moments=True, ct=64)
    e_mom = max(assert_close(got_m[..., c], ref_m[..., c],
                             f"allpairs moments 64x4096 B=1024 channel {c}")
                for c in range(6))
    assert_bits(tk.allpairs_moments(*mom_q, *mom), got_m,
                "allpairs moments 64x4096 B=1024, run to run")
    # the self-join (one compacted corpus on both sides: the tiles on and
    # above the diagonal, mirrored) against the join with a copy of the
    # corpus on the B side (every tile joined), bit for bit; its first 64
    # rows are the query launch's, and out[a, b] is out[b, a] with x and y
    # swapped
    mom_self = tk.allpairs_moments(*mom, *mom)
    assert_bits(mom_self, tk.allpairs_moments(*mom, *(x.clone() for x in
                                                       mom)),
                "allpairs moments 4096x4096 self-join vs a B-side copy")
    assert_bits(mom_self[:64], got_m,
                "allpairs moments self-join rows vs the 64-row launch")
    assert_bits(mom_self, mom_self.transpose(0, 1)[..., list(MOMENT_SWAP)],
                "allpairs moments self-join vs its transpose, x and y "
                "swapped")
    err["allpairs_estimate"] = max(err["allpairs_estimate"], e_mom)
    b5_moments_err = e_mom
    del cs, mom, mom_q, got_m, ref_m, mom_self

    # B6 on two half-partition corpora of one block, and with 16 buckets,
    # where the merge itself overflows (m = 64 there, as the reference's
    # test has it: 16 x 4 slots a side must hold more than m/2 candidates
    # for the merged tau to exist)
    half = torch.rand(N, generator=gen, device=dev) < 0.5
    merge_drops = {}
    for nb, m in ((N_BUCKETS, M), (16, 64)):
        lo, hi = (tk.bucketize_corpus(tk.build_priority_corpus(
            torch.where(side, blk, torch.zeros((), device=dev)), m, SEED,
            device=dev), n_buckets=nb, slots=SLOTS) for side in (half, ~half))
        tau = tk.merged_tau_bucketized(lo, hi, SEED, m=m)
        got = tk.merge_bucketized(lo.idx, lo.val, hi.idx, hi.val, tau, SEED)
        ref = merge_bucketized_ref(lo.idx, lo.val, hi.idx, hi.val, tau, SEED)
        for g, r, what in zip(got, ref, ("idx", "val", "dropped")):
            assert_bits(g, r, f"merge_bucketized n_buckets={nb} {what}")
        merge_drops[nb] = int(got[2].sum())
    check(merge_drops[16] > 0, "the n_buckets=16 merge dropped nothing")
    err["merge_bucketized"] = 0.0
    del lo, hi, got, ref

    # B7 on bucketized matrix-sketch pairs: the store's widths (256 pairs
    # of m = 256 sketches of (65536, 16) matrices in 512 x 4) and edge
    # cases (S = 2 and 3, unequal widths, 24 x 24 outputs beyond one
    # block, a 16-bucket layout that drops rows); each small case with a
    # padding pair and a keep-everything (tau = inf) pair; the store's
    # shape once more with one query side broadcast against every pair
    def mat_side(P, n, d, side, m, nb, slots, special):
        X = torch.randn((P, n, d), generator=gen, device=dev)
        X *= torch.exp(torch.randn((P, n, 1), generator=gen, device=dev))
        if side == 0:
            X[:, (3 * n) // 4:] = 0.0
            if special:
                X[0, 40:] = 0.0             # 40 nonzero rows < m
        else:
            X[:, : n // 4] = 0.0
        sk = tk.bucketize_matrix_sketches(to_matrix(build_payload_corpus(
            X, m, SEED, device=dev)), n_buckets=nb, slots=slots)
        idx, rows = sk.idx, sk.rows
        if special and side == 0:           # the last pair's A: padding
            idx[-1] = INVALID_IDX
            rows[-1] = 0.0
            sk = sk._replace(tau=torch.cat([sk.tau[:-1], sk.tau.new_ones(1)]))
        return idx, rows, tk.matrix_slot_probs(sk), sk.dropped

    b7_cases = [(MAT_PAIRS, MAT_N, MAT_D, MAT_D, MAT_M, N_BUCKETS, SLOTS),
                (7, 4096, 8, 3, 64, 128, 4), (7, 4096, 6, 6, 64, 128, 2),
                (7, 4096, 5, 7, 64, 128, 3), (7, 4096, 24, 24, 64, 128, 4),
                (7, 4096, 4, 4, 64, 16, 4)]
    b7_err, b7_drops = 0.0, 0
    for P, n, da, db, m, nb, slots in b7_cases:
        special = P != MAT_PAIRS
        a = mat_side(P, n, da, 0, m, nb, slots, special)
        b = mat_side(P, n, db, 1, m, nb, slots, special)
        got = tk.matrix_products(*a[:3], *b[:3])
        what = f"matrix_products P={P} d={da}x{db} S={slots} B={nb}"
        b7_err = max(b7_err, assert_close(
            got, matrix_products_ref(*a[:3], *b[:3]), what))
        assert_bits(tk.matrix_products(*a[:3], *b[:3]), got,
                    f"{what}, run to run")
        if special:
            check(bool((got[-1] == 0).all()), f"{what}: padding pair not 0")
        if nb == 16:
            b7_drops = int(a[3].sum() + b[3].sum())
        if P == MAT_PAIRS:
            q = [x[:1].contiguous() for x in a[:3]]
            got_q = tk.matrix_products(*q, *b[:3])
            assert_bits(got_q, tk.matrix_products(
                *(x.expand(P, *x.shape[1:]).contiguous() for x in q),
                *b[:3]), "matrix_products broadcast query vs copies")
            b7_err = max(b7_err, assert_close(
                got_q, matrix_products_ref(*q, *b[:3]),
                "matrix_products broadcast query"))
            # a pair's bits depend on its two sketches alone: the first k
            # pairs of the P-pair call against a k-pair call, batched and
            # with the query side broadcast
            for k in (1, 7, P - 1):
                assert_bits(tk.matrix_products(*(x[:k] for x in a[:3]),
                                               *(x[:k] for x in b[:3])),
                            got[:k], f"matrix_products first {k} of {P} "
                            f"pairs vs a {k}-pair call")
                assert_bits(tk.matrix_products(*q, *(x[:k] for x in b[:3])),
                            got_q[:k], f"matrix_products broadcast, first "
                            f"{k} of {P} pairs vs a {k}-pair call")
    check(b7_drops > 0, "the 16-bucket matrix layout dropped nothing")
    err["matrix_products"] = b7_err
    del a, b, got

    # B8 at the join-size path's shapes (Fig. 10's first table: n = 30000,
    # m = 400, the modulo branch; the bias-aware tail's residual at
    # m = (400 - 16) // 3 = 128, the mask branch) and the quickstart's
    # (n = 100000, m = 600); B9 at (30000, 400) and at the main path's
    # width (a 65536-wide row, m = 256) under both row-seed rules
    # (kernels.jl_project's and core.baselines.jl_sketch's).  Each against
    # its plain version and against a second launch, bit for bit
    fa0, fb0 = zipf_frequency_tables(np.random.default_rng(7), JOIN_KEYS,
                                     JOIN_ROWS, JOIN_ROWS,
                                     overlap=JOIN_OVERLAP, z=JOIN_Z)
    fa0_t = torch.as_tensor(fa0, device=dev)
    # B4 at the served join-size panel's shape: its index (m = 400, 1024
    # buckets x 4 slots, trial 0's seed) holding fa, fa scaled to [0, 1]
    # and fb, queried by fb
    join_rows = torch.as_tensor(np.stack(
        [fa0, fa0 / max(float(fa0.max()), 1.0), fb0]).astype(np.float32),
        device=dev)
    jc = tk.bucketize_corpus(tk.build_priority_corpus(
        join_rows, JOIN_M, 0, device=dev), n_buckets=JOIN_BUCKETS,
        slots=SLOTS)
    jq = tk.bucketize(priority_sketch(torch.as_tensor(fb0, device=dev),
                                      JOIN_M, 0), n_buckets=JOIN_BUCKETS,
                      slots=SLOTS)
    got = tk.intersect_estimate(jq.idx, jq.val, jq.tau, jc.idx, jc.val,
                                jc.tau)
    ref = intersect_estimate_ref(jq.idx, jq.val, jq.tau, jc.idx, jc.val,
                                 jc.tau)
    b4_err["join"] = assert_close(got, ref, "intersect_estimate join shape")
    b4_err["join_max_abs_estimate"] = float(ref.abs().max())
    err["intersect_estimate"] = max(err["intersect_estimate"],
                                    b4_err["join"])
    assert_bits(tk.intersect_estimate(jq.idx, jq.val, jq.tau, jc.idx, jc.val,
                                      jc.tau), got,
                "intersect_estimate join shape, run to run")
    for variant in ("l2", "uniform"):
        for g, r, out in zip(
                tk.hash_rank_hist(fa0_t[None], 42, variant=variant),
                hash_rank_hist_ref(fa0_t[None], 42, variant=variant),
                ("h", "rank", "hist")):
            assert_bits(g, r, f"hash_rank_hist Fig. 10 vector {variant} {out}")
        for g, r, out in zip(tk.hash_rank(fa0_t, 42, variant=variant),
                             hash_rank_ref(fa0_t, 42, variant=variant),
                             ("h", "rank")):
            assert_bits(g, r, f"hash_rank Fig. 10 vector {variant} {out}")
    spread_cases.append(["Fig. 10 vector", JOIN_KEYS])
    tail_t = torch.as_tensor(head_split(fa0, JOIN_HEAD)[2], device=dev)
    qs_t = torch.as_tensor(quickstart.make_vectors()[0], device=dev)
    b8_cases = (("fig10", fa0_t, JOIN_M),
                ("tail", tail_t, (JOIN_M - JOIN_HEAD) // CS_TAIL_REPS),
                ("quickstart", qs_t, int(quickstart.M * 1.5)))
    sb, ss = int(fold_seed(5, 1)), int(fold_seed(5, 2))
    b8_err = 0.0
    for case, v, m in b8_cases:
        what = f"countsketch {case} n={v.shape[0]} m={m}"
        got = tk.countsketch_scatter(v, m, sb, ss)
        assert_bits(tk.countsketch_scatter(v, m, sb, ss), got,
                    f"{what}, run to run")
        b8_err = max(b8_err, assert_tol(got, countsketch_ref(v, sb, ss, m),
                                        CS_TOL, CS_TOL, what))
    err["countsketch_scatter"] = b8_err
    b9_cases = (("fig10", fa0_t, JOIN_M), ("main", rand_block(1, N)[0], M))
    b9_err = 0.0
    for case, v, m in b9_cases:
        rows = torch.arange(m, dtype=torch.int64, device=dev)
        for rule, seeds in (
                ("jl_project", jl_row_seeds(SEED, rows)),
                ("jl_sketch", (int(fold_seed(SEED, 0)) + rows) & 0xFFFFFFFF)):
            what = f"jl_rademacher {case} n={v.shape[0]} m={m} {rule}"
            got = tk.jl_rademacher(v, seeds)
            assert_bits(tk.jl_rademacher(v, seeds), got,
                        f"{what}, run to run")
            ref = jl_rows_ref(v, seeds)
            scale = max(1.0, float(ref.abs().max()))
            b9_err = max(b9_err, assert_tol(got, ref, JL_TOL,
                                            JL_TOL * scale, what))
            # a row's bits do not depend on m: the first k rows of the
            # m-row call against a k-row call
            for k in (1, 7, m - 1):
                assert_bits(tk.jl_rademacher(v, seeds[:k]), got[:k],
                            f"{what}: first {k} rows vs a {k}-row call")
    # small integers sum exactly in any order: the kernel equals its plain
    # version bit for bit, so every sign is the reference's
    int_v = torch.randint(-8, 9, (JOIN_KEYS + 1,), generator=gen,
                          device=dev).float()
    int_seeds = jl_row_seeds(SEED, torch.arange(JOIN_M, device=dev))
    assert_bits(tk.jl_rademacher(int_v, int_seeds),
                jl_rows_ref(int_v, int_seeds),
                f"jl_rademacher on small integers n={JOIN_KEYS + 1} vs plain")
    err["jl_rademacher"] = b9_err
    emit({"phase": "parity", "max_abs_err": err,
          "build_kernels": "bit-equal", "merge_kernel": "bit-equal",
          "hash_rank_spread_route_cases": spread_cases,
          "radix_select_cases": [[w, list(kk.shape),
                                  k if isinstance(k, int) else "per-row",
                                  h0 is not None]
                                 for w, kk, k, h0 in b2_cases],
          "merge_dropped": merge_drops, "estimators": f"rtol={RTOL}",
          "intersect_estimate_cases": [list(pc_shape), list(jc.idx.shape)],
          "intersect_estimate_max_abs_err_by_shape": b4_err,
          "matrix_products_cases": [list(c) for c in b7_cases],
          "matrix_products_layout_dropped": b7_drops,
          "countsketch_cases": [[c, int(v.shape[0]), m]
                                for c, v, m in b8_cases],
          "countsketch_tolerance": f"rtol=atol={CS_TOL}",
          "jl_rademacher_cases": [[c, int(v.shape[0]), m]
                                  for c, v, m in b9_cases],
          "jl_rademacher_tolerance":
              f"rtol={JL_TOL}, atol={JL_TOL} x max(1, max |out|)",
          "jl_rademacher_rows": "first k of m rows bit-equal to a k-row "
                                "call (k = 1, 7, m - 1); small integers "
                                "bit-equal to plain",
          "matrix_products_pairs": "first k of 256 pairs bit-equal to a "
                                   "k-pair call (k = 1, 7, 255), batched "
                                   "and broadcast",
          "radix_select_union_positions": {
              "shape": list(q_keys.shape), "k": [DISC_M + 1, 1,
                                                 q_keys.shape[1]],
              "max_keys_below_m_plus_1_a_row": q_head,
              "vs": "torch.kthvalue and the plain descent, bit-equal"},
          "allpairs_moments_b1024": {
              "shape": [64, DISC_D, DISC_BUCKETS, DISC_SLOTS],
              "max_abs_err": b5_moments_err, "run_to_run": "bit-equal"},
          "repeat_launches": "bit-equal"})

    # ------------------------------------------------------------- main path
    rng = np.random.default_rng(2)
    vidx, vval = make_data(rng)
    D = D_BATCH + D_SPARSE
    names = [f"doc{d:04d}" for d in range(D)]
    sq_norms = (torch.as_tensor(vval, device=dev).double() ** 2).sum(dim=1)
    sources = rng.choice(D, N_QUERIES, replace=False)
    noise = rng.standard_normal((N_QUERIES, NNZ)).astype(np.float32)

    def planted(qi, src):
        qv = np.zeros(N, np.float32)
        qv[vidx[src]] = vval[src] + 0.05 * noise[qi]
        return qv

    def main_path():
        index = SketchIndex(M, n_buckets=N_BUCKETS, slots=SLOTS, seed=SEED,
                            device=dev)
        block_ms = []
        t_ingest = time.perf_counter()
        for lo in range(0, D_BATCH, BLOCK_ROWS):
            rows = list(range(lo, min(lo + BLOCK_ROWS, D_BATCH)))
            block = dense_rows(vidx, vval, rows)
            t0 = time.perf_counter()
            index.add_many([names[r] for r in rows], block)
            block_ms.append((time.perf_counter() - t0) * 1e3)
        for d in range(D_BATCH, D):
            index.add(names[d], indices=vidx[d], values=vval[d])
        ingest_s = time.perf_counter() - t_ingest
        check(len(index) == D and index.capacity == D, "index size/capacity")

        query_ms, hits = [], 0
        for qi, src in enumerate(sources):
            qv = planted(qi, src)
            t0 = time.perf_counter()
            top = index.query(qv, top_k=5)
            query_ms.append((time.perf_counter() - t0) * 1e3)
            hits += top[0][0] == names[src]
        check(hits == N_QUERIES, f"planted top-1 recall {hits}/{N_QUERIES}")

        # the quickstart example's data and asserts, through the kernel
        # builds (raises if an assert fails)
        qs = quiet(quickstart.main, device=dev)

        t0 = time.perf_counter()
        ap = index.all_pairs()
        all_pairs_ms = (time.perf_counter() - t0) * 1e3
        check(ap.shape == (D, D) and bool(np.isfinite(ap).all()),
              "all_pairs shape/finite")
        row_err = 0.0
        for k in rng.choice(D_BATCH, 16, replace=False):
            row = np.array([e for _, e in index.query(
                dense_rows(vidx, vval, [k])[0])])
            row_err = max(row_err, assert_close(
                torch.as_tensor(ap[k]),
                torch.as_tensor(row.astype(np.float32)),
                f"all_pairs row {k} vs query"))
        diag = torch.as_tensor(np.diag(ap).astype(np.float64), device=dev)
        diag_scaled = float(((diag - sq_norms).abs() / sq_norms).max())
        check(diag_scaled < 8.0 / math.sqrt(M),
              f"all_pairs diagonal scaled error {diag_scaled}")

        # the discovery engine's tile launch: four (128, 128) tiles of
        # random rows, each bit-equal to its block of all_pairs' matrix
        # (a cell's bits depend on its two rows only)
        c = index._corpus()
        arrs = (c.idx, c.val, tk.slot_inclusion_probs(c))
        trng = np.random.default_rng(5)
        for t in range(4):
            ra, rb = (trng.choice(D, 128, replace=False) for _ in range(2))
            assert_bits(tk.estimate_tile_rows(*arrs, *arrs, ra, rb).cpu(),
                        torch.as_tensor(ap[np.ix_(ra, rb)]),
                        f"estimate_tile_rows tile {t} vs all_pairs")
        # the batched estimator on 64 rows: the bucketized kernel against
        # the per-pair join, on the pairs neither row lost an entry of
        S64 = sketch_corpus(dense_rows(vidx, vval, range(64)), M, SEED,
                            backend="kernel", device=dev)
        kept = tk.bucketize_corpus(S64, n_buckets=N_BUCKETS,
                                   slots=SLOTS).dropped == 0
        clean = kept[:, None] & kept[None, :]
        ea_err = assert_close(
            estimate_all_pairs(S64, S64, backend="kernel",
                               n_buckets=N_BUCKETS, slots=SLOTS)[clean],
            estimate_all_pairs(S64, S64, backend="reference")[clean],
            "estimate_all_pairs kernel vs reference, 64 rows")
        return dict(index=index, ap=ap, block_ms=block_ms,
                    ingest_s=ingest_s, query_ms=query_ms, hits=hits, qs=qs,
                    all_pairs_ms=all_pairs_ms, row_err=row_err,
                    diag_scaled=diag_scaled, ea_err=ea_err,
                    ea_pairs=int(clean.sum()))

    mp, launches["main_path"] = run_path(kernels, main_path)
    index, ap = mp["index"], mp["ap"]
    need = ("hash_rank_hist", "radix_select", "intersect_estimate",
            "allpairs_compact", "allpairs_estimate")
    check(all(launches["main_path"][k] > 0 for k in need),
          f"a kernel of the main path never launched: {launches}")
    emit({"phase": "main_path", "D": D, "n": N, "nnz": NNZ, "m": M,
          "n_buckets": N_BUCKETS, "slots": SLOTS,
          "total_dropped": index.total_dropped,
          "planted_top1": f"{mp['hits']}/{N_QUERIES}",
          "quickstart_scaled_error": mp["qs"]["scaled_error"],
          "quickstart_bound": mp["qs"]["bound"],
          "all_pairs_vs_query_max_abs_err": mp["row_err"],
          "diag_max_scaled_error": mp["diag_scaled"],
          "diag_bound": 8.0 / math.sqrt(M),
          "tiles_vs_all_pairs": "4 tiles of 128 x 128 random rows, "
                                "bit-equal",
          "estimate_all_pairs_kernel_vs_reference_max_abs_err":
              mp["ea_err"],
          "estimate_all_pairs_pairs_compared": mp["ea_pairs"],
          "seconds": mp["seconds"],
          "launches": launches["main_path"]})

    # -------------------------------------------------------- threshold path
    h_all = hash_unit(SEED, torch.arange(N, dtype=torch.int32, device=dev))

    def threshold_path():
        sizes, over, scaled, block_ms = [], 0, [], []
        for lo in range(0, D, BLOCK_ROWS):
            A = torch.as_tensor(dense_rows(vidx, vval,
                                           range(lo, lo + BLOCK_ROWS)),
                                device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sk = sketch_corpus(A, M, SEED, method="threshold",
                               backend="kernel", device=dev)
            torch.cuda.synchronize()
            block_ms.append((time.perf_counter() - t0) * 1e3)
            ref = tk.build_threshold_corpus(A, M, SEED, device=dev,
                                            use_kernel=False)
            for g, r, what in zip(sk, ref, ("idx", "val", "tau")):
                assert_bits(g, r, f"threshold build rows {lo}.. {what}")
            sizes.append((sk.idx != INVALID_IDX).sum(dim=1))
            W = weight(A, "l2")
            include = (W > 0) & (h_all[None] <= sk.tau[:, None] * W)
            over += int((include.sum(dim=1) > CAP).sum())
            self_sk = Sketch(sk.idx, sk.val, sk.tau[:, None])
            est = estimate_inner_product(self_sk, self_sk).double()
            true = (A.double() ** 2).sum(dim=1)
            scaled.append((est - true).abs() / true)
        sizes = torch.cat(sizes).double()
        worst = float(torch.cat(scaled).max())
        mean_size = float(sizes.mean())
        check(abs(mean_size - M) <= 0.02 * M,
              f"threshold mean sketch size {mean_size} not within 2% of {M}")
        check(worst < 8.0 / math.sqrt(M),
              f"threshold self-estimate scaled error {worst}")
        # map-reduce over 4 column slices of one block vs the one-shot build
        A = torch.as_tensor(dense_rows(vidx, vval, range(BLOCK_ROWS)),
                            device=dev)
        tau_rel = 0.0
        for method in ("priority", "threshold"):
            got = partitioned_sketch_corpus(A, M, SEED, method=method,
                                            num_partitions=PARTITIONS,
                                            device=dev)
            want = sketch_corpus(A, M, SEED, method=method, backend="kernel",
                                 device=dev)
            assert_bits(got.idx, want.idx, f"partitioned {method} idx")
            assert_bits(got.val, want.val, f"partitioned {method} val")
            if method == "priority":
                assert_bits(got.tau, want.tau, "partitioned priority tau")
            else:
                rel = ((got.tau.double() - want.tau.double()).abs()
                       / want.tau.double())
                tau_rel = float(rel.max())
                check(tau_rel <= 1e-5,
                      f"partitioned threshold tau rel err {tau_rel}")
        qs = quiet(quickstart.main, device=dev)
        return dict(mean_size=mean_size, size_min=float(sizes.min()),
                    size_max=float(sizes.max()), overflow_rows=over,
                    worst_scaled=worst, block_ms=block_ms, tau_rel=tau_rel,
                    qs=qs)

    tp, launches["threshold_path"] = run_path(kernels, threshold_path)
    need = ("hash_rank_batched", "hash_rank", "radix_select")
    check(all(launches["threshold_path"][k] > 0 for k in need),
          f"a kernel of the threshold path never launched: {launches}")
    emit({"phase": "threshold_path", "D": D, "n": N, "m": M, "cap": CAP,
          "mean_sketch_size": tp["mean_size"],
          "sketch_size_range": [tp["size_min"], tp["size_max"]],
          "overflow_cut_rows": tp["overflow_rows"],
          "self_estimate_max_scaled_error": tp["worst_scaled"],
          "bound": 8.0 / math.sqrt(M),
          "partitioned_P": PARTITIONS,
          "partitioned_threshold_tau_max_rel_err": tp["tau_rel"],
          "quickstart_threshold_scaled_error":
              tp["qs"]["scaled_error"]["threshold"],
          "quickstart_threshold_size": tp["qs"]["threshold_size"],
          "seconds": tp["seconds"],
          "launches": launches["threshold_path"]})

    # ------------------------------------------------------------ merge path
    def merge_path():
        lo_ix, hi_ix = (SketchIndex(M, n_buckets=N_BUCKETS, slots=SLOTS,
                                    seed=SEED,
                                    dp=DPParams(epsilon=MERGE_EPS),
                                    dp_rng=np.random.default_rng(21 + k),
                                    device=dev) for k in range(2))
        for lo in range(0, D_BATCH, BLOCK_ROWS):
            rows = list(range(lo, min(lo + BLOCK_ROWS, D_BATCH)))
            block = dense_rows(vidx, vval, rows)
            low = block.copy()
            low[:, N // 2:] = 0.0
            block[:, :N // 2] = 0.0
            lo_ix.add_many([names[r] for r in rows], low)
            hi_ix.add_many([names[r] for r in rows], block)
        for d in range(D_BATCH, D):
            side = vidx[d] < N // 2
            lo_ix.add(names[d], indices=vidx[d][side], values=vval[d][side])
            hi_ix.add(names[d], indices=vidx[d][~side],
                      values=vval[d][~side])
        pre = {k: getattr(lo_ix, k)[:D].copy()
               for k in ("_idx", "_val", "_tau", "_dropped", "_head_idx",
                         "_head_val")}
        clean = (lo_ix._dropped[:D] == 0) & (hi_ix._dropped[:D] == 0)
        # the peer releases once; merging composes its ledger here
        hi_ix.query(planted(0, sources[0]), mode="private")
        check(hi_ix.accountant.spent_epsilon == MERGE_EPS,
              "the peer's release was not charged once")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lo_ix.merge_from(hi_ix)
        merge_ms = (time.perf_counter() - t0) * 1e3
        check(lo_ix.accountant.spent_epsilon == MERGE_EPS
              and lo_ix.accountant.ledger == hi_ix.accountant.ledger,
              "merge_from did not compose the peer's privacy ledger")
        rows = np.flatnonzero(clean)
        for k in ("_idx", "_val", "_tau", "_dropped"):
            assert_bits(torch.as_tensor(getattr(lo_ix, k)[rows]),
                        torch.as_tensor(getattr(index, k)[rows]),
                        f"merged index {k} on rows no partition dropped")
        for qi, src in enumerate(sources):
            qv = planted(qi, src)
            got = np.array([e for _, e in lo_ix.query(qv)])[rows]
            want = np.array([e for _, e in index.query(qv)])[rows]
            check(bool(np.array_equal(got, want)),
                  f"merged index query {qi} differs on equal rows")
        ap_m = lo_ix.all_pairs()
        check(bool(np.array_equal(ap_m[np.ix_(rows, rows)],
                                  ap[np.ix_(rows, rows)])),
              "merged index all_pairs differs on equal rows")
        return dict(other_rows=int(D - rows.size), merge_ms=merge_ms,
                    pre=pre, hi=hi_ix, dropped=index.total_dropped,
                    merged_dropped=lo_ix.total_dropped,
                    merged_epsilon=lo_ix.accountant.spent_epsilon)

    mg, launches["merge_path"] = run_path(kernels, merge_path)
    need = ("hash_rank_hist", "radix_select", "merge_bucketized",
            "intersect_estimate", "allpairs_compact", "allpairs_estimate")
    check(all(launches["merge_path"][k] > 0 for k in need),
          f"a kernel of the merge path never launched: {launches}")
    # a half-index row drops an entry with probability drop_share; either
    # half does for this share of the rows
    expected = D * (1.0 - (1.0 - drop_share(M, N_BUCKETS, SLOTS)) ** 2)
    check(mg["other_rows"] <= 2 * expected,
          f"{mg['other_rows']} rows had partition drops; the layout "
          f"predicts {expected:.0f}")
    emit({"phase": "merge_path", "D": D, "split_at": N // 2,
          "rows_bit_equal": D - mg["other_rows"],
          "rows_with_partition_drops": mg["other_rows"],
          "rows_with_partition_drops_predicted": expected,
          "full_index_dropped": mg["dropped"],
          "merged_index_dropped": mg["merged_dropped"],
          "merge_from_ms": mg["merge_ms"],
          "peer_epsilon_composed": mg["merged_epsilon"],
          "seconds": mg["seconds"],
          "launches": launches["merge_path"]})

    # ----------------------------------------------------------- matrix path
    mrng = np.random.default_rng(5)
    mat_names = [f"A{c:04d}" for c in range(MAT_C)]
    q_src = mrng.choice(MAT_C, MAT_QUERIES, replace=False)
    pair_ix = mrng.choice(MAT_C, (MAT_PAIRS, 2))

    def matrix_path():
        store = MatrixSketchStore(MAT_M, dim=MAT_D, seed=SEED, device=dev)
        add_ms = []
        for c in range(MAT_C):
            A = matrix_pair(c, dev)[0].cpu().numpy()
            t0 = time.perf_counter()
            store.add(mat_names[c], A)
            add_ms.append((time.perf_counter() - t0) * 1e3)
        check(len(store) == MAT_C and store.capacity == MAT_C,
              "store size/capacity")
        query_ms, answers = [], []
        for c in q_src:
            Q = matrix_pair(int(c), dev)[1].cpu().numpy()
            t0 = time.perf_counter()
            answers.append(store.query(Q))
            query_ms.append((time.perf_counter() - t0) * 1e3)
        pairs = [(mat_names[i], mat_names[j]) for i, j in pair_ix]
        t0 = time.perf_counter()
        prods = store.products(pairs)
        products_ms = (time.perf_counter() - t0) * 1e3
        A0 = matrix_pair(0, dev)[0]
        part, part_ms = {}, {}
        for method in ("priority", "threshold"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            part[method] = partitioned_matrix_sketch(
                A0, MAT_M, SEED, num_partitions=PARTITIONS, method=method)
            torch.cuda.synchronize()
            part_ms[method] = (time.perf_counter() - t0) * 1e3
        return dict(store=store, add_ms=add_ms, query_ms=query_ms,
                    answers=answers, pairs=pairs, prods=prods,
                    products_ms=products_ms, part=part, part_ms=part_ms)

    mx, launches["matrix_path"] = run_path(kernels, matrix_path)
    need = ("radix_select", "matrix_products")
    check(all(launches["matrix_path"][k] > 0 for k in need),
          f"a kernel of the matrix path never launched: {launches}")
    store = mx["store"]
    lib_bc, lib_p = store._buckets()
    _, lib_buckets, lib_slots = lib_bc.idx.shape   # the store's layout
    lib_dropped = lib_bc.dropped[:MAT_C].cpu().numpy()
    corpus_m = store._corpus()
    # each answer against the exact per-pair join on the card, on every
    # stored sketch whose layout dropped no row (queries whose own layout
    # dropped a row are counted, not compared)
    frob, q_err, q_dropped, q_compared = [], 0.0, 0, 0
    for c, ans in zip(q_src, mx["answers"]):
        A, Q = matrix_pair(int(c), dev)
        check([n for n, _ in ans] == mat_names, "query answer names")
        est = torch.as_tensor(np.stack([e for _, e in ans]), device=dev)
        check(est.shape == (MAT_C, MAT_D, MAT_D)
              and bool(torch.isfinite(est).all()), "query answer shape")
        sq = priority_matrix_sketch(Q, MAT_M, SEED)
        if int(tk.bucketize_matrix_sketches(sq).dropped[0]) > 0:
            q_dropped += 1
        else:
            exact = estimate_matrix_product(sq, corpus_m)[:MAT_C]
            ok = torch.as_tensor(lib_dropped == 0, device=dev)
            q_err = max(q_err, assert_close(est[ok], exact[ok],
                                            f"store query {c}"))
            q_compared += 1
        true = Q.double().T @ A.double()
        bound = float(frobenius_error_guarantee(Q.double(), A.double(),
                                                MAT_M, 0.1,
                                                method="priority"))
        frob.append(float(torch.linalg.norm(est[int(c)].double() - true))
                    / bound)
    frob = np.array(frob)
    check(q_compared >= MAT_QUERIES // 2,
          f"only {q_compared} queries had a drop-free layout")
    check(np.mean(frob > 1.0) <= 0.2,
          f"{int(np.sum(frob > 1.0))} of {MAT_QUERIES} partner estimates "
          "beyond the Frobenius guarantee")
    # products against per-pair product, where neither layout dropped
    ia, ib = pair_ix[:, 0], pair_ix[:, 1]
    p_err = 0.0
    for k, (a_name, b_name) in enumerate(mx["pairs"]):
        if lib_dropped[ia[k]] == 0 and lib_dropped[ib[k]] == 0:
            p_err = max(p_err, assert_close(
                torch.as_tensor(mx["prods"][k]),
                torch.as_tensor(store.product(a_name, b_name)),
                f"products pair {k}"))
    # the partitioned build against the one-shot build
    A0 = matrix_pair(0, dev)[0]
    one = {"priority": priority_matrix_sketch(A0, MAT_M, SEED),
           "threshold": threshold_matrix_sketch(A0, MAT_M, SEED)}
    for method, got in mx["part"].items():
        assert_bits(got.row_idx, one[method].row_idx,
                    f"partitioned matrix {method} idx")
        assert_bits(got.rows, one[method].rows,
                    f"partitioned matrix {method} rows")
        if method == "priority":
            assert_bits(got.tau, one[method].tau, "partitioned matrix tau")
        else:
            mat_tau_rel = float(abs(float(got.tau) - float(one[method].tau))
                                / float(one[method].tau))
            check(mat_tau_rel <= 1e-5,
                  f"partitioned matrix threshold tau rel err {mat_tau_rel}")
    # the row weight on the card against the CPU's, bit for bit
    assert_bits(payload_weight(A0, "l2").cpu(),
                payload_weight(A0.cpu(), "l2"), "payload_weight d=16")
    # stored sketches with a bucket drop against the Poisson expectation
    drop_rows = int((lib_dropped > 0).sum())
    drop_expected = MAT_C * drop_share(MAT_M, lib_buckets, lib_slots)
    check(drop_rows <= 2 * drop_expected,
          f"{drop_rows} stored sketches dropped a row; the layout predicts "
          f"{drop_expected:.0f}")
    emit({"phase": "matrix_path", "C": MAT_C, "n": MAT_N, "d": MAT_D,
          "m": MAT_M, "n_buckets": lib_buckets, "slots": lib_slots,
          "overlap": MAT_OVERLAP, "queries": MAT_QUERIES,
          "queries_compared": q_compared,
          "queries_with_layout_drop": q_dropped,
          "query_vs_join_max_abs_err": q_err,
          "partner_frob_ratio_median": float(np.median(frob)),
          "partner_frob_ratio_max": float(frob.max()),
          "partner_beyond_guarantee": int(np.sum(frob > 1.0)),
          "products_pairs": MAT_PAIRS,
          "products_vs_product_max_abs_err": p_err,
          "partitioned_P": PARTITIONS,
          "partitioned_threshold_tau_rel_err": mat_tau_rel,
          "stored_with_drop": drop_rows,
          "stored_with_drop_predicted": drop_expected,
          "seconds": mx["seconds"],
          "launches": launches["matrix_path"]})

    # -------------------------------------------------------- join-size path
    jrng = np.random.default_rng(7)       # fig10_joinsize.py's rng
    samples = samples_for_budget(JOIN_M)
    join_methods = {
        "JL": (lambda v, s: jl_sketch(v, JOIN_M, s), jl_estimate),
        "CS": (lambda v, s: countsketch(v, JOIN_M, s), countsketch_estimate),
        "TS-weighted": (lambda v, s: threshold_sketch(v, samples, s,
                                                      backend="kernel"),
                        estimate_inner_product),
        "PS-weighted": (lambda v, s: priority_sketch(v, samples, s,
                                                     backend="kernel"),
                        estimate_inner_product),
        "TS-uniform": (
            lambda v, s: threshold_sketch(v, samples, s, variant="uniform",
                                          backend="kernel"),
            lambda a, b: estimate_inner_product(a, b, variant="uniform")),
        "PS-uniform": (
            lambda v, s: priority_sketch(v, samples, s, variant="uniform",
                                         backend="kernel"),
            lambda a, b: estimate_inner_product(a, b, variant="uniform")),
    }
    dp_join = DPParams(epsilon=JOIN_EPS, clamp=JOIN_CLAMP,
                       p_floor=JOIN_P_FLOOR)

    def join_tables():
        return zipf_frequency_tables(jrng, JOIN_KEYS, JOIN_ROWS, JOIN_ROWS,
                                     overlap=JOIN_OVERLAP, z=JOIN_Z)

    def join_panel(skew_both: bool):
        fa, fb = join_tables()
        if not skew_both:   # TPC-H-like: only one side skewed
            fb = np.where(fb > 0, np.ceil(fb.mean()), 0).astype(np.float32)
        true = float(fa.astype(np.float64) @ fb.astype(np.float64))
        ta, tb = (torch.as_tensor(x, device=dev) for x in (fa, fb))
        errs, ms = {}, {}
        for mname, (sk, est) in join_methods.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rel = [abs(float(est(sk(ta, s), sk(tb, s))) - true) / true
                   for s in range(JOIN_TRIALS)]
            ms[mname] = (time.perf_counter() - t0) / (2 * JOIN_TRIALS) * 1e3
            errs[mname] = float(np.mean(rel))
        return errs, ms

    def served_index(s, device):
        return SketchIndex(m=JOIN_M, n_buckets=JOIN_BUCKETS, seed=s,
                           head_h=JOIN_HEAD, dp=dp_join,
                           dp_rng=np.random.default_rng((17, s)),
                           device=device)

    def served_panel():
        """The Twitter-like tables through SketchIndex: fa ingested (and
        a [0, 1]-scaled copy for the private row, so the clamp 1.0 is
        exact), fb the query; plain, bias_aware and private side by side;
        then the bias-aware CountSketch tail on the same tables."""
        fa, fb = join_tables()
        true = float(fa.astype(np.float64) @ fb.astype(np.float64))
        scale = max(float(fa.max()), 1.0)
        fa_n = (fa / scale).astype(np.float32)
        true_n = true / scale
        band = float(dp_chebyshev_halfwidth(
            float(fa_n.astype(np.float64) @ fa_n),
            float(fb.astype(np.float64) @ fb), JOIN_M,
            q=dp_join.survival, noise_scale=dp_join.noise_scale(JOIN_M),
            clamp=dp_join.clamp, p_floor=dp_join.p_floor, capacity=JOIN_M,
            universe=JOIN_KEYS, delta=0.05))
        ta, tb = (torch.as_tensor(x, device=dev) for x in (fa, fb))
        rel = {k: [] for k in ("direct", "plain", "bias_aware", "private")}
        query_ms = {k: [] for k in ("plain", "bias_aware", "private")}
        in_band, ledger = 0, {}
        for s in range(JOIN_TRIALS):
            sa = priority_sketch(ta, JOIN_M, s)
            sb_ = priority_sketch(tb, JOIN_M, s)
            rel["direct"].append(
                abs(float(estimate_inner_product(sa, sb_)) - true) / true)
            ix = served_index(s, dev)
            ix.add("fa", fa)
            ix.add("fa_private", fa_n)
            ans = {}
            for mode in query_ms:
                t0 = time.perf_counter()
                ans[mode] = dict(ix.query(fb, mode=mode))
                query_ms[mode].append((time.perf_counter() - t0) * 1e3)
            rel["plain"].append(abs(ans["plain"]["fa"] - true) / true)
            rel["bias_aware"].append(
                abs(ans["bias_aware"]["fa"] - true) / true)
            err_priv = abs(ans["private"]["fa_private"] - true_n)
            rel["private"].append(err_priv / abs(true_n))
            in_band += err_priv <= band
            if s == 0:
                # one charge a release epoch; the cached release is free;
                # the same release from CPU copies with the same rng
                first = ix._private_release
                ledger["first"] = ix.accountant.spent_epsilon
                ix.query(fb, mode="private")
                ledger["cached"] = ix.accountant.spent_epsilon
                check(ix._private_release is first,
                      "a query of the cached release made a new one")
                cpu = served_index(s, "cpu")
                cpu.add("fa", fa)
                cpu.add("fa_private", fa_n)
                cpu.query(fb, mode="private")
                for k in ("idx", "z"):
                    assert_bits(
                        torch.as_tensor(getattr(cpu._private_release, k)),
                        torch.as_tensor(getattr(first, k)),
                        f"private release {k} from CPU copies")
                ix.add("fb", fb)
                ix.query(fb, mode="private")
                ledger["second_epoch"] = ix.accountant.spent_epsilon
        check(ledger == {"first": JOIN_EPS, "cached": JOIN_EPS,
                         "second_epoch": 2 * JOIN_EPS},
              f"privacy ledger {ledger}: want {JOIN_EPS} a release epoch")
        cs_est = [estimate_bias_aware_cs(
            bias_aware_cs_sketch(fa, JOIN_M, s, h=JOIN_HEAD,
                                 reps=CS_TAIL_REPS, device=dev),
            bias_aware_cs_sketch(fb, JOIN_M, s, h=JOIN_HEAD,
                                 reps=CS_TAIL_REPS, device=dev))
            for s in range(JOIN_TRIALS)]
        return dict(rel={k: float(np.mean(v)) for k, v in rel.items()},
                    in_band=in_band / JOIN_TRIALS, band=band,
                    ledger=ledger,
                    query_ms={k: float(np.percentile(v, 50))
                              for k, v in query_ms.items()},
                    cs_tail_rel=abs(float(np.median(cs_est)) - true) / true)

    def join_size_path():
        tpch, tpch_ms = join_panel(skew_both=False)
        tw, tw_ms = join_panel(skew_both=True)
        served = served_panel()
        return dict(tpch=tpch, tw=tw, tpch_ms=tpch_ms, tw_ms=tw_ms,
                    served=served)

    jp, launches["join_size_path"] = run_path(kernels, join_size_path)
    need = ("countsketch_scatter", "jl_rademacher", "hash_rank_hist",
            "radix_select", "hash_rank", "intersect_estimate")
    check(all(launches["join_size_path"][k] > 0 for k in need),
          f"a kernel of the join-size path never launched: {launches}")
    tw, sv = jp["tw"], jp["served"]
    gates = {
        "served_matches_direct":
            sv["rel"]["plain"] <= 2.5 * sv["rel"]["direct"] + 0.02,
        "served_private_within_band": sv["in_band"] >= 0.75,
        "weighted_beats_uniform_on_skew":
            tw["PS-weighted"] < tw["PS-uniform"],
        "weighted_competitive_with_linear":
            tw["PS-weighted"] < 1.2 * tw["JL"],
        "bias_aware_cs_tail_within_half": sv["cs_tail_rel"] < 0.5,
    }
    emit({"phase": "join_size_path", "n_keys": JOIN_KEYS,
          "rows": JOIN_ROWS, "trials": JOIN_TRIALS, "m": JOIN_M,
          "samples": samples, "overlap": JOIN_OVERLAP, "z": JOIN_Z,
          "rel_err_tpch_like": jp["tpch"], "rel_err_twitter_like": tw,
          "ms_per_sketch_tpch_like": jp["tpch_ms"],
          "ms_per_sketch_twitter_like": jp["tw_ms"],
          "served_rel_err": sv["rel"], "private_band": sv["band"],
          "private_in_band": sv["in_band"],
          "served_query_p50_ms": sv["query_ms"],
          "bias_aware_cs_tail_median_rel_err": sv["cs_tail_rel"],
          "epsilon_spent": sv["ledger"], "gates": gates,
          "seconds": jp["seconds"],
          "launches": launches["join_size_path"]})
    check(all(gates.values()), f"Fig. 10 gates failed: {gates}")

    # ------------------------------------------------- join-correlation path
    def rows_of(S, ix):
        return type(S)(*(f[ix] for f in S))

    def fig6_panel():
        """benchmarks/fig6_join_corr.py at its full widths: 60 correlated
        pairs, a budget of 400 doubles; each method's mean |estimate -
        exact post-join correlation| and ms a pair (host clock)."""
        rng6 = np.random.default_rng(3)
        pairs = []
        for rho in np.linspace(-0.9, 0.9, CORR_PAIRS):
            a, b = correlated_pair(rng6, CORR_N, CORR_NNZ, CORR_OVERLAP, rho)
            mask = (a != 0) & (b != 0)
            pairs.append((torch.as_tensor(a, device=dev),
                          torch.as_tensor(b, device=dev),
                          float(np.corrcoef(a[mask], b[mask])[0, 1])))
        msamp = samples_for_budget(CORR_M)

        def uniform(build):
            return lambda a, b, s: float(empirical_correlation(
                build(a, msamp, s, variant="uniform", backend="kernel"),
                build(b, msamp, s, variant="uniform", backend="kernel")))

        def weighted(method):
            def fn(a, b, s):
                S = combined_sketch_corpus(torch.stack([a, b]), msamp, s,
                                           method=method, backend="kernel",
                                           device=dev)
                return float(estimate_join_correlation(rows_of(S, 0),
                                                       rows_of(S, 1)))
            return fn

        def legacy(build):
            return lambda a, b, s: float(estimate_join_correlation(
                build(a, msamp, s), build(b, msamp, s)))

        methods = {
            "JL": lambda a, b, s: linear_corr(jl_sketch, jl_estimate, a, b,
                                              CORR_M, s),
            "CS": lambda a, b, s: linear_corr(countsketch,
                                              countsketch_estimate, a, b,
                                              CORR_M, s),
            "PS-uniform": uniform(priority_sketch),
            "TS-uniform": uniform(threshold_sketch),
            "TS-weighted": weighted("threshold"),
            "PS-weighted": weighted("priority"),
            "TS-weighted legacy": legacy(combined_threshold_sketch),
            "PS-weighted legacy": legacy(combined_priority_sketch)}
        errs, ms = {}, {}
        for name, fn in methods.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            errs[name] = float(np.mean([abs(fn(a, b, i) - true) for i, (
                a, b, true) in enumerate(pairs)]))
            ms[name] = (time.perf_counter() - t0) / CORR_PAIRS * 1e3
        # each pair's kernel-route builds bit-equal to the same builds on
        # the kernels' plain versions
        for i, (a, b, _) in enumerate(pairs):
            ab = torch.stack([a, b])
            for build in (tk.build_combined_priority_corpus,
                          tk.build_combined_threshold_corpus):
                for g, r, f in zip(
                        build(ab, msamp, i, device=dev),
                        build(ab, msamp, i, device=dev, use_kernel=False),
                        CombinedSketch._fields):
                    assert_bits(g, r, f"fig6 pair {i} {build.__name__} {f}")
        route = {k: v for k, v in errs.items() if "legacy" not in k}
        best = min(route, key=route.get)
        gates = {"weighted_best": best in ("PS-weighted", "TS-weighted"),
                 "beats_linear": errs["PS-weighted"] < errs["JL"]
                 and errs["PS-weighted"] < errs["CS"]}
        return dict(errs=errs, ms=ms, best=best, gates=gates, samples=msamp)

    def planted_err(S, exact, lo=0):
        """Mean |estimate - exact| over the planted pairs of the groups in
        rows lo .. lo + len(S) of the corpus, one batched estimate."""
        G = S.idx.shape[0] // DISC_GROUP
        qs = torch.arange(G, device=dev) * DISC_GROUP
        cols = qs[:, None] + torch.arange(1, DISC_GROUP, device=dev)
        est = estimate_join_correlation(
            rows_of(S, qs.repeat_interleave(DISC_GROUP - 1)),
            rows_of(S, cols.flatten())).reshape(G, DISC_GROUP - 1)
        return float((est.double() - exact).abs().mean())

    def discovery():
        """The D = 4096 corpus: combined sketches in 512-row blocks (each
        bit-equal to its build on the plain versions), the 4096 x 4096
        correlation matrix on B5's moments mode, its 64 query rows
        against the per-pair join, the planted-pair error and the top
        columns."""
        blocks, exact, build_ms = [], [], []
        for lo in range(0, DISC_D, BLOCK_ROWS):
            A = disc_block(lo)
            S, ms = step_ms(lambda: combined_sketch_corpus(
                A, DISC_M, DISC_SEED, backend="kernel", device=dev))
            build_ms.append(ms)
            plain = tk.build_combined_priority_corpus(
                A, DISC_M, DISC_SEED, device=dev, use_kernel=False)
            for g, r, f in zip(S, plain, CombinedSketch._fields):
                assert_bits(g, r, f"combined priority block {lo} {f}")
            if lo == 0:
                for g, r, f in zip(*(tk.build_combined_threshold_corpus(
                        A, DISC_M, DISC_SEED, device=dev, use_kernel=uk)
                        for uk in (True, False)), CombinedSketch._fields):
                    assert_bits(g, r, f"combined threshold block 0 {f}")
                block0 = A
            exact.append(planted_exact(A))
            blocks.append(S)
        S = CombinedSketch(*(torch.cat(f) for f in zip(*blocks)))
        exact = torch.cat(exact)
        C, corr_ms = step_ms(lambda: correlation_matrix(
            S, backend="kernel", n_buckets=DISC_BUCKETS, slots=DISC_SLOTS))
        qrows = torch.arange(0, DISC_D, DISC_GROUP, device=dev)
        SQ = rows_of(S, qrows)
        mom_k = combined_estimates_matrix(SQ, S, backend="kernel",
                                          n_buckets=DISC_BUCKETS,
                                          slots=DISC_SLOTS)
        mom_r = combined_estimates_matrix(SQ, S, backend="reference")
        ref = correlation_from_estimates(mom_r)
        drops = _bucketized_moment_inputs(S, DISC_BUCKETS, DISC_SLOTS)[3]
        clean = (drops[qrows] == 0)[:, None] & (drops == 0)[None, :]
        Cq = C[qrows]
        # a cell's bits depend on its two rows only: the square matrix's
        # query rows are those of a (64, D) launch
        assert_bits(correlation_from_estimates(mom_k), Cq,
                    "correlation_matrix query rows vs a (64, D) launch")
        mom_err = assert_moments(mom_k, mom_r, clean, "kernel vs the "
                                 "per-pair join on the query rows")
        # the correlation where it is conditioned: with few matches
        # n sum_x2 - sum_x^2 cancels (it is 0 in exact arithmetic for one
        # match), and each backend's float32 rounding picks its sign
        e64 = {k: v.double() for k, v in mom_r.items()}
        well = clean
        for m1, m2 in (("sum_x", "sum_x2"), ("sum_y", "sum_y2")):
            raw2 = e64["n"] * e64[m2]
            well = well & (raw2 - e64[m1] * e64[m1] >= CORR_COND * raw2)
        err_q = assert_tol(Cq[well], ref[well], CORR_GATE_RTOL,
                           CORR_GATE_RTOL, "correlation_matrix kernel vs "
                           "reference on the query rows")
        cols = qrows[:, None] + torch.arange(1, DISC_GROUP, device=dev)
        planted_well = int(torch.gather(well, 1, cols).sum())
        planted_clean = int(torch.gather(clean, 1, cols).sum())
        del mom_k, mom_r, e64
        est = torch.gather(Cq, 1, cols)
        mean_err = float((est.double() - exact).abs().mean())
        top = torch.gather(cols, 1, est.abs().argmax(dim=1, keepdim=True))
        top_rho = np.abs(disc_rho[top.flatten().cpu().numpy()])
        hits = int((top_rho == 0.75).sum())
        # the per-pair estimator on ten planted pairs against the
        # reference backend's entries
        pair_err = 0.0
        for i in range(min(10, len(qrows))):
            q, c = int(qrows[i]), int(qrows[i]) + 1 + i
            e = estimate_join_correlation(rows_of(S, q), rows_of(S, c))
            pair_err = max(pair_err, abs(float(e) - float(ref[i, c])))
        check(pair_err <= 1e-5, f"estimate_join_correlation vs the "
              f"reference matrix: {pair_err}")
        del C
        return dict(S=S, exact=exact, block0=block0, build_ms=build_ms,
                    corr_ms=corr_ms, err_q=err_q, mom_err=mom_err,
                    pairs_compared=int(clean.sum()),
                    pairs_conditioned=int(well.sum()),
                    planted_conditioned=planted_well,
                    planted_drop_free=planted_clean,
                    drops=drops,
                    mean_err=mean_err,
                    hits=hits, pair_err=pair_err,
                    max_err=float((est.double() - exact).abs().max()))

    def table_store():
        """SketchedTableStore on the card: the first group's 64 columns
        through add_column, top_correlated against the same store on
        CPU copies; then examples/join_correlation_discovery.py's six
        columns."""
        names = [f"g0c{c:02d}" for c in range(DISC_GROUP)]
        stores = [SketchedTableStore(universe=DISC_UNIVERSE, m=DISC_M,
                                     seed=DISC_SEED, device=d)
                  for d in (dev, "cpu")]
        add_ms, top_ms = [], []
        for name, (k, v) in zip(names, disc_cols):
            _, ms = step_ms(lambda: stores[0].add_column(name, k, v))
            add_ms.append(ms)
            stores[1].add_column(name, k, v)
        for _ in range(20):
            top, ms = step_ms(lambda: stores[0].top_correlated(names[0],
                                                               k=5))
            top_ms.append(ms)
        cpu_top = stores[1].top_correlated(names[0], k=5)
        check([n for n, _ in top] == [n for n, _ in cpu_top],
              f"store top_correlated {top} vs CPU copies {cpu_top}")
        store_err = max(abs(a - b) for (_, a), (_, b) in zip(top, cpu_top))
        check(store_err <= 1e-5, f"store scores vs CPU copies {store_err}")
        ex = SketchedTableStore(universe=DISC_UNIVERSE, m=DISC_M,
                                seed=DISC_SEED, device=dev)
        for name, (k, v) in zip(EXAMPLE_NAMES, disc_cols):
            ex.add_column(name, k, v)
        truth = dict(zip(EXAMPLE_NAMES[1:], DISC_RHOS))
        lines = [f"{n:15s} rho_est = {s:+.3f}   (true {truth[n]:+.2f})"
                 for n, s in ex.top_correlated(EXAMPLE_NAMES[0], k=5)]
        return dict(top=top, store_err=store_err, add_ms=add_ms,
                    top_ms=top_ms, example=lines, example_join_size=ex.
                    join_size(EXAMPLE_NAMES[0], EXAMPLE_NAMES[1]))

    def combined_merge(disc):
        """Block 0 split by coordinate at 2^17, both halves built and
        merged on the card, against the merge of the same parts on the
        CPU; the merged correlations' planted-pair error beside the
        one-shot build's."""
        A = disc["block0"]
        half = DISC_UNIVERSE // 2
        lo, hi = A.clone(), A.clone()
        lo[:, half:] = 0.0
        hi[:, :half] = 0.0
        parts = [tk.build_combined_priority_corpus(x, DISC_M, DISC_SEED,
                                                   device=dev)
                 for x in (lo, hi)]
        merged = merge_combined_sketches(*parts, DISC_SEED, m=DISC_M)
        on_cpu = merge_combined_sketches(
            *(CombinedSketch(*(f.cpu() for f in p)) for p in parts),
            DISC_SEED, m=DISC_M)
        assert_bits(merged.idx.cpu(), on_cpu.idx, "combined merge idx")
        assert_bits(merged.val.cpu(), on_cpu.val, "combined merge val")
        ulps = 0
        for f in ("tau_ones", "tau_val", "tau_sq", "scale"):
            g, r = getattr(merged, f).cpu(), getattr(on_cpu, f)
            fin = torch.isfinite(r)
            check(torch.equal(torch.isfinite(g), fin),
                  f"combined merge {f}: finite masks differ")
            if bool(fin.any()):
                ulps = max(ulps, int((g[fin].view(torch.int32).long() -
                                      r[fin].view(torch.int32).long()
                                      ).abs().max()))
        check(ulps <= 1, f"combined merge taus {ulps} ulps from the CPU's")
        ex0 = disc["exact"][:BLOCK_ROWS // DISC_GROUP]
        return dict(tau_ulps=ulps, merged_err=planted_err(merged, ex0),
                    one_shot_err=planted_err(rows_of(
                        disc["S"], slice(0, BLOCK_ROWS)), ex0))

    def join_corr_path():
        fig6 = fig6_panel()
        disc = discovery()
        store = table_store()
        merge = combined_merge(disc)
        return dict(fig6=fig6, disc=disc, store=store, merge=merge)

    jcp, launches["join_corr_path"] = run_path(kernels, join_corr_path)
    need = ("radix_select", "allpairs_compact", "allpairs_estimate",
            "countsketch_scatter", "jl_rademacher", "hash_rank_hist",
            "hash_rank")
    check(all(launches["join_corr_path"][k] > 0 for k in need),
          f"a kernel of the join-correlation path never launched: {launches}")
    f6, dc, st, mg6 = (jcp[k] for k in ("fig6", "disc", "store", "merge"))
    corr_gates = {
        **f6["gates"],
        "planted_mean_err_below": dc["mean_err"] < PLANTED_ERR_GATE,
        "top1_planted_075": dc["hits"] >= TOP1_GATE}
    emit({"phase": "join_corr_path", "fig6": {
              "n": CORR_N, "nnz": CORR_NNZ, "overlap": CORR_OVERLAP,
              "pairs": CORR_PAIRS, "m": CORR_M, "samples": f6["samples"],
              "mean_abs_err": f6["errs"], "ms_per_pair": f6["ms"],
              "best": f6["best"]},
          "discovery": {
              "D": DISC_D, "universe": DISC_UNIVERSE, "m": DISC_M,
              "n_buckets": DISC_BUCKETS, "slots": DISC_SLOTS,
              "build_ms_per_block": dc["build_ms"],
              "correlation_matrix_ms": dc["corr_ms"],
              "query_rows_moments_vs_reference_max_err_of_pair_scale":
                  dc["mom_err"],
              "query_pairs_drop_free": dc["pairs_compared"],
              "query_rows_vs_reference_max_abs_err": dc["err_q"],
              "query_pairs_conditioned": dc["pairs_conditioned"],
              "planted_pairs_drop_free": dc["planted_drop_free"],
              "planted_pairs_conditioned": dc["planted_conditioned"],
              "rows_with_bucket_drop": int((dc["drops"] > 0).sum()),
              "entries_dropped": int(dc["drops"].sum()),
              "planted_mean_abs_err": dc["mean_err"],
              "planted_max_abs_err": dc["max_err"],
              "planted_err_gate": PLANTED_ERR_GATE,
              "top1_planted_075": f"{dc['hits']}/{DISC_GROUPS}",
              "per_pair_vs_reference_max_abs_err": dc["pair_err"]},
          "store": {"top_correlated": st["top"],
                    "vs_cpu_copies_max_abs_err": st["store_err"],
                    "add_column_p50_ms": float(np.percentile(st["add_ms"],
                                                             50)),
                    "top_correlated_p50_ms": float(np.percentile(
                        st["top_ms"], 50)),
                    "example_top5": st["example"],
                    "example_join_size": st["example_join_size"]},
          "merge": mg6, "gates": corr_gates,
          "seconds": jcp["seconds"],
          "launches": launches["join_corr_path"]})
    check(all(corr_gates.values()),
          f"join-correlation gates failed: {corr_gates}")

    # -------------------------------------------------------- discovery path
    def query_row(ix, qv) -> np.ndarray:
        """The query against every row of ``ix`` in one one-row launch of
        B5, sketched as ``SketchIndex.query`` sketches it."""
        sq = priority_sketch(torch.as_tensor(qv, device=dev), ix.m, ix.seed)
        qb = tk.bucketize(sq, n_buckets=ix.n_buckets, slots=ix.slots)
        qc = tk.BucketizedSketch(qb.idx[None], qb.val[None],
                                 qb.tau.reshape(1),
                                 torch.zeros(1, dtype=torch.int32,
                                             device=dev))
        c = ix._corpus()
        return tk.estimate_tile_rows(
            qc.idx, qc.val, tk.slot_inclusion_probs(qc), c.idx, c.val,
            tk.slot_inclusion_probs(c), [0],
            np.arange(len(ix))).cpu().numpy()[0]

    first_batch, max_batch = disc_mod._FIRST_BATCH, disc_mod._MAX_BATCH
    scan_meta = {}

    def counted(scan, what, tasks=None):
        """Run one scan (of ``tasks`` shard tasks when it is a fan-out):
        every visited tile pair was computed, one tile-list join launch a
        batch of the schedule (exactly, for one scan), at most 2 x visited
        + the first batch - 2 tiles a scan (the doubling's bound), no
        tile through the plain join, every tile pair launched or pruned.
        ``scan_meta[what]``: the batches, tiles computed and the device
        peak of the scan (its own allocations above what was allocated
        before it: the layout when the scan built it, the batches'
        tiles) beside the reckoned ``peak_bytes``."""
        jt = tk.allpairs_join_tiles
        b0, t0, p0 = jt.launches, jt.tiles, tk.allpairs_estimate.launches
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = scan()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        st = res.stats
        batches, tiles, n = jt.launches - b0, jt.tiles - t0, st.tiles_launched
        n_tasks = 1 if tasks is None else tasks
        check(tk.allpairs_estimate.launches == p0,
              f"{what}: {tk.allpairs_estimate.launches - p0} plain B5 "
              "launches in a scan")
        check(st.kernel_launches == n > 0 and n <= tiles
              <= 2 * n + n_tasks * (first_batch - 2)
              and (tasks is not None or tiles <= st.tiles_total),
              f"{what}: {tiles} tiles computed for {n} visited "
              f"({st.kernel_launches} kernel launches)")
        check(batches == schedule_batches(tiles, first_batch, max_batch)
              if tasks is None else 0 < batches <= tiles,
              f"{what}: {batches} tile-list launches for {tiles} tiles")
        check(st.tiles_launched + st.tiles_pruned == st.tiles_total,
              f"{what}: launched + pruned != total ({st})")
        scan_meta[what] = {
            "tiles_launched": n, "batches": batches, "tiles_computed": tiles,
            "within_visited_plus_first_batch":
                tiles <= n + n_tasks * first_batch,
            "device_peak_bytes": peak - base,
            "device_peak_bytes_with_resident": peak,
            "reckoned_peak_bytes": st.peak_bytes}
        return res

    def scan_gates(ix, est, what):
        """top_pairs(k=10) in both modes, each bit-equal to ``est`` (the
        index's all_pairs matrix) plus the sort."""
        eng = DiscoveryEngine(ix, tile=TOPK_TILE)
        out = {}
        for absolute in (False, True):
            res = counted(lambda: eng.top_pairs(TOPK_K, absolute=absolute),
                          f"{what} top_pairs" + (" absolute" if absolute
                                                 else ""))
            check(res.items == true_top_pairs(est, ix._names, TOPK_K,
                                              absolute),
                  f"{what}: top_pairs(absolute={absolute}) differs from "
                  "all_pairs() plus the sort")
            out["absolute" if absolute else "plain"] = res
        return eng, out

    def query_gates(ix, eng, qv, what):
        """top_k_for_query(k=10) bit-equal to one one-row launch of B5
        plus the sort; against ``query(top_k=10)`` (B4) by names, within
        RTOL."""
        res = counted(lambda: eng.top_k_for_query(qv, TOPK_K),
                      f"{what} top_k_for_query")
        check(res.items == true_top_rows(query_row(ix, qv), ix._names,
                                         TOPK_K),
              f"{what}: top_k_for_query differs from a one-row launch plus "
              "the sort")
        err = same_ranking(res.items, ix.query(qv, top_k=TOPK_K),
                           f"{what}: top_k_for_query vs query(top_k)")
        return res, err

    def stats_of(res) -> dict:
        return dataclasses.asdict(res.stats)

    def discovery_path():
        X = topk_corpus()
        dense_host_bytes = X.nbytes
        queries = X[:TOPK_QUERIES].copy()   # row 1 is planted on row 0
        names_t = [f"c{i}" for i in range(TOPK_D)]
        sk = SketchIndex(TOPK_M, n_buckets=TOPK_BUCKETS, slots=TOPK_SLOTS,
                         seed=SEED, initial_capacity=TOPK_D, device=dev)
        block_ms = []
        for lo in range(0, TOPK_D, BLOCK_ROWS):
            t0 = time.perf_counter()
            sk.add_many(names_t[lo:lo + BLOCK_ROWS], X[lo:lo + BLOCK_ROWS])
            block_ms.append((time.perf_counter() - t0) * 1e3)
        del X
        est_t = sk.all_pairs()
        eng, scans = scan_gates(sk, est_t, "skewed")
        # B5 against its plain version at this corpus's shape: the rows of
        # the first two scan tiles (the heaviest columns, whose samples
        # share ids) against every column, from the matrix the scan gates
        # hold the scans to
        hc = sk._corpus()
        hp = tk.slot_inclusion_probs(hc)
        heavy = np.concatenate([eng.tile_members(0), eng.tile_members(1)])
        hr = torch.as_tensor(heavy, device=dev)
        block_err = assert_close(
            torch.as_tensor(est_t[heavy], device=dev),
            allpairs_estimate_ref(hc.idx[hr], hc.val[hr], hp[hr], hc.idx,
                                  hc.val, hp, ct=512)[:, :TOPK_D],
            f"skewed all_pairs rows of tiles 0-1 ({heavy.size} x {TOPK_D})")
        err["allpairs_estimate"] = max(err["allpairs_estimate"], block_err)
        del hc, hp, hr
        st = scans["plain"].stats
        reduction = st.tiles_total / st.kernel_launches
        budget = TOPK_BYTES_PER_SAMPLE * TOPK_D * TOPK_M
        truth = {it[:2] for it in true_top_pairs(est_t, names_t, TOPK_K)}
        cheb = counted(lambda: DiscoveryEngine(
            sk, tile=TOPK_TILE, ceiling="chebyshev").top_pairs(TOPK_K),
            "skewed chebyshev")
        gates = {
            "launch_reduction_ge_5x": reduction >= TOPK_MIN_REDUCTION,
            "peak_bytes_le_40_D_m": st.peak_bytes <= budget,
            "peak_bytes_below_dense": st.peak_bytes < est_t.nbytes,
            "chebyshev_launches_le_admissible":
                cheb.stats.tiles_launched <= st.tiles_launched}
        check(all(gates.values()), f"discovery gates failed: {gates}")
        q_res, q_err = query_gates(sk, eng, queries[0], "skewed")
        check(q_res.items[0][0] == "c0" and q_res.items[1][0] == "c1",
              f"skewed query: planted rows not first: {q_res.items[:2]}")
        # the flat corpus: the main path's index and its all_pairs matrix
        feng, fscans = scan_gates(index, ap, "flat")
        fq_res, fq_err = query_gates(index, feng, planted(0, sources[0]),
                                     "flat")
        check(fq_res.items[0][0] == names[sources[0]],
              "flat query: the planted source is not first")
        # dirty tiles: a copy of the skewed index appends 512 rows below
        # every column's norm; the next scan refreshes the trailing tiles
        cp = index_from_arrays(
            **{k: getattr(sk, "_" + k) for k in (
                "idx", "val", "tau", "dropped", "g", "kn", "head_idx",
                "head_val", "head_kept")},
            names=sk._names, dim=sk._dim, m=TOPK_M, n_buckets=TOPK_BUCKETS,
            slots=TOPK_SLOTS, seed=SEED, device=dev)
        ceng = DiscoveryEngine(cp, tile=TOPK_TILE)
        check(counted(lambda: ceng.top_pairs(TOPK_K), "copy").items
              == scans["plain"].items, "the copy's scan differs")
        n_tiles, r0 = ceng._summaries.n_tiles, ceng._summaries.refreshes
        tail = np.random.default_rng(7).standard_normal(
            (BLOCK_ROWS, TOPK_N), dtype=np.float32) * TOPK_TAIL_SCALE
        cp.add_many([f"tail{i}" for i in range(BLOCK_ROWS)], tail)
        after = counted(lambda: ceng.top_pairs(TOPK_K), "after append")
        refreshed = ceng._summaries.refreshes - r0
        check(0 < refreshed < n_tiles,
              f"append refreshed {refreshed} of {n_tiles} tiles")
        check(after.items == true_top_pairs(cp.all_pairs(), cp._names,
                                             TOPK_K),
              "after the append: top_pairs differs from all_pairs() plus "
              "the sort")
        return dict(
            index=sk, eng=eng, feng=feng, queries=queries, scans=scans,
            fscans=fscans, cheb=cheb, reduction=reduction, budget=budget,
            dense_host_bytes=dense_host_bytes, dense_bytes=est_t.nbytes,
            block_ms=block_ms, gates=gates, q_res=q_res, q_err=q_err,
            block_err=block_err, block_rows=int(heavy.size),
            fq_res=fq_res, fq_err=fq_err, refreshed=refreshed,
            n_tiles=n_tiles, D_after=len(cp),
            cheb_recall=len({it[:2] for it in cheb.items} & truth) / TOPK_K)

    dp, launches["discovery_path"] = run_path(kernels, discovery_path)
    need = ("hash_rank_hist", "radix_select", "intersect_estimate",
            "allpairs_compact", "allpairs_estimate", "allpairs_join_tiles")
    check(all(launches["discovery_path"][k] > 0 for k in need),
          f"a kernel of the discovery path never launched: {launches}")
    emit({"phase": "discovery_path",
          "skewed": {
              "D": TOPK_D, "n": TOPK_N, "m": TOPK_M,
              "n_buckets": TOPK_BUCKETS, "slots": TOPK_SLOTS,
              "tile": TOPK_TILE, "k": TOPK_K,
              "dense_host_bytes": dp["dense_host_bytes"],
              "all_pairs_bytes": dp["dense_bytes"],
              "peak_budget_bytes": dp["budget"],
              "add_many_ms_per_block": float(np.mean(dp["block_ms"])),
              "top_pairs": {k: stats_of(v) for k, v in dp["scans"].items()},
              "top_pairs_items": dp["scans"]["plain"].items,
              "launch_reduction": dp["reduction"],
              "heavy_rows_vs_plain": {
                  "rows": dp["block_rows"], "cols": TOPK_D,
                  "max_abs_err": dp["block_err"], "parity": f"rtol={RTOL}"},
              "chebyshev": {**stats_of(dp["cheb"]),
                            "recall": dp["cheb_recall"]},
              "query": {**stats_of(dp["q_res"]),
                        "vs_index_query_max_abs_err": dp["q_err"]}},
          "flat": {
              "D": D, "m": M, "n_buckets": N_BUCKETS, "slots": SLOTS,
              "top_pairs": {k: stats_of(v) for k, v in dp["fscans"].items()},
              "query": {**stats_of(dp["fq_res"]),
                        "vs_index_query_max_abs_err": dp["fq_err"]}},
          "append": {"rows": BLOCK_ROWS, "D_after": dp["D_after"],
                     "tiles_refreshed": dp["refreshed"],
                     "tiles_before": dp["n_tiles"]},
          "gates": dp["gates"],
          "bit_equal_to_all_pairs_sort": "skewed and flat, both modes, "
                                         "and after the append",
          "batch_schedule": {"first": first_batch, "max": max_batch},
          "scans": {k: v for k, v in scan_meta.items()
                    if not k.startswith("sharded")},
          "seconds": dp["seconds"],
          "launches": launches["discovery_path"]})

    # ------------------------------------------------ tile-list join parity
    def scan_order(eng):
        """An engine's pair-scan visit order: the tile pairs u <= v by
        descending ceiling, as ``_pair_scan`` orders them."""
        ceil = eng._ceiling_matrix(eng)
        uu, vv = np.triu_indices(eng._summaries.n_tiles)
        order = np.argsort(-ceil[uu, vv], kind="stable")
        return uu[order], vv[order]

    def join_tiles_parity():
        """B5's tile-list join on both discovery corpora's scan layouts:
        the first 132 tile pairs of the scan order (the skewed corpus's
        heaviest first) and the last tile with itself in one launch, each
        tile bit-equal to ``estimate_tile_rows`` on the pair's rows; the
        first 8 at each groups setting bit-equal to the launch; all within
        tolerance of the plain version (in chunks of 16 pairs)."""
        out, e = {}, 0.0
        for what, eng in (("skewed", dp["eng"]), ("flat", dp["feng"])):
            lay = eng._prepare()
            c, p = eng._dev, eng._probs
            uu, vv = scan_order(eng)
            nt = eng._summaries.n_tiles
            pairs = np.concatenate([np.stack([uu[:132], vv[:132]], 1),
                                    [[nt - 1, nt - 1]]]).astype(np.int32)
            pt = torch.as_tensor(pairs, device=dev)
            side = (lay.entries, lay.counts)
            got = tk.allpairs_join_tiles(*side, *side, pt)
            for n, (u, v) in enumerate(pairs):
                ru, rv = eng.tile_members(int(u)), eng.tile_members(int(v))
                assert_bits(got[n, :ru.size, :rv.size],
                            tk.estimate_tile_rows(c.idx, c.val, p, c.idx,
                                                  c.val, p, ru, rv),
                            f"{what} tile-list join pair {n} ({u}, {v}) vs "
                            "estimate_tile_rows")
            for g in (1, 2, 4, 8, 16):
                assert_bits(tk.allpairs_join_tiles(*side, *side, pt[:8],
                                                   groups=g), got[:8],
                            f"{what} tile-list join at {g} groups")
            plain = torch.cat([allpairs_join_tiles_ref(
                *side, *side, pt[i:i + 16]) for i in range(0, len(pt), 16)])
            err_w = assert_close(got, plain, f"{what} tile-list join vs "
                                             "its plain version")
            e = max(e, err_w)
            out[what] = {"pairs": len(pairs), "shape": [64, 64, *c.idx.shape[1:]],
                         "max_abs_err_vs_plain": err_w,
                         "groups_bit_equal": [1, 2, 4, 8, 16]}
        return out, e

    jt_parity, err["allpairs_join_tiles"] = join_tiles_parity()
    emit({"phase": "join_tiles", "corpora": jt_parity,
          "gates_passed": [
              "each tile bit-equal to estimate_tile_rows on its rows",
              "each groups setting bit-equal to the launch",
              f"within rtol={RTOL} of the plain version"]})

    # ---------------------------------------------------------- sharded path
    def same_up_to_ties(got: list, want: list, what: str) -> None:
        """Two answers' estimates bit-equal position by position; their
        names equal except where the estimate ties another of ``want``'s
        (the global heap and the coordinator break exact ties their own
        ways)."""
        check([it[-1] for it in got] == [it[-1] for it in want],
              f"{what}: the estimates differ")
        for i, (g, w) in enumerate(zip(got, want)):
            check(g[:-1] == w[:-1] or sum(it[-1] == w[-1] for it in want)
                  > 1, f"{what}: {g} against {w} at {i}, not a tie")

    def homes_of(sh) -> np.ndarray:
        """(D, 2) (shard, row in shard) of every global row."""
        return np.array(sh._homes, np.int64).reshape(-1, 2)

    def counting_engine(sh, raise_on, exc, **kw):
        """A fan-out whose ``call_wrapper`` records every task attempt and
        raises ``exc`` for tasks that touch shard ``raise_on``."""
        calls = []

        def wrapper(shards, fn):
            calls.append(shards)
            if raise_on in shards:
                raise exc(f"injected fault on shard {raise_on}")
            return fn()

        eng = ShardedDiscoveryEngine(sh, tile=TOPK_TILE, call_wrapper=wrapper,
                                     sleep=lambda s: None, **kw)
        return eng, calls

    def fault_gates(sh, truth) -> dict:
        """Shard 1 lost to ConnectionError (2 tries), to TimeoutError (1
        try); shard 0 killed, then revived."""
        D_s = len(sh)
        sizes = [len(s) for s in sh._shards]
        total = D_s * (D_s - 1) // 2
        lost_1 = sizes[1] * (sizes[1] - 1) // 2 + sizes[1] * (D_s - sizes[1])
        home = dict(zip(sh._names, homes_of(sh)[:, 0].tolist()))
        out = {}
        eng, calls = counting_engine(
            sh, 1, ConnectionError,
            retry=RetryPolicy(attempts=2, base_delay=0.0))
        res = eng.top_pairs(TOPK_K)
        tries = collections.Counter(calls)
        lost = tuple((s, t) for s in range(SHARDS) for t in range(s, SHARDS)
                     if 1 in (s, t))
        got = {it[:2] for it in res.items}
        surviving = [it[:2] for it in truth
                     if home[it[0]] != 1 and home[it[1]] != 1]
        check(res.degraded and res.lost_pairs == lost
              and res.coverage == (total - lost_1) / total,
              f"shard 1 lost: degraded={res.degraded}, lost "
              f"{res.lost_pairs}, coverage {res.coverage}")
        check(all(p in got for p in surviving),
              "shard 1 lost: a surviving true top-k pair is missing")
        check(all(tries[key] == 2 for key in lost)
              and all(tries[key] == 1 for key in tries if key not in lost),
              f"shard 1 lost: attempts {dict(tries)}")
        out["connection_error"] = {
            "coverage": res.coverage, "lost_pairs": list(res.lost_pairs),
            "surviving_true_pairs_found": f"{len(surviving)}/"
                                          f"{len(surviving)}",
            "attempts_of_lost_tasks": [tries[key] for key in lost],
            "tiles_launched": res.stats.tiles_launched}
        eng, calls = counting_engine(
            sh, 1, TimeoutError, retry=RetryPolicy(attempts=5, base_delay=0.0))
        res = eng.top_pairs(TOPK_K)
        tries = collections.Counter(calls)
        check(res.degraded and res.lost_pairs == lost
              and all(tries[key] == 1 for key in tries),
              f"timeout: lost {res.lost_pairs}, attempts {dict(tries)}")
        out["timeout"] = {"coverage": res.coverage,
                          "attempts": sorted(set(tries.values()))}
        eng, calls = counting_engine(sh, -1, ConnectionError)
        eng.kill_shard(0, "maintenance")
        down = eng.top_pairs(TOPK_K)
        down_calls = list(calls)
        eng.revive_shard(0)
        up = eng.top_pairs(TOPK_K)
        check(down.degraded and down.lost_shards == (0,)
              and all(0 not in key for key in down_calls),
              f"killed shard 0: lost shards {down.lost_shards}, calls "
              f"{sorted(set(down_calls))}")
        check(not up.degraded and up.coverage == 1.0
              and up.items == truth,
              f"revived shard 0: coverage {up.coverage}")
        out["killed_shard_0"] = {"coverage": down.coverage,
                                 "calls_to_shard_0": 0,
                                 "revived_coverage": up.coverage}
        return out

    def nccl_build():
        """``partitioned_sketch_corpus_sharded`` as a one-rank NCCL group
        over the main path's first 512 x 65536 block, both methods."""
        import torch.distributed as dist
        from datetime import timedelta
        rdv = os.path.join(ROOT, "build", f"nccl_rendezvous.{os.getpid()}")
        os.makedirs(os.path.dirname(rdv), exist_ok=True)
        if os.path.exists(rdv):
            os.remove(rdv)
        dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0,
                                world_size=1, timeout=timedelta(seconds=60))
        try:
            A = torch.as_tensor(dense_rows(vidx, vval, range(BLOCK_ROWS)),
                                device=dev)
            out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
            # the first collective creates the NCCL communicator: timed apart
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            partitioned_sketch_corpus_sharded(A, M, SEED)
            torch.cuda.synchronize()
            out["first_call_ms"] = (time.perf_counter() - t0) * 1e3
            for method in ("priority", "threshold"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sk = partitioned_sketch_corpus_sharded(A, M, SEED,
                                                       method=method)
                torch.cuda.synchronize()
                out[method] = sk
                out[f"{method}_ms"] = (time.perf_counter() - t0) * 1e3
            return A, out
        finally:
            dist.destroy_process_group()
            if os.path.exists(rdv):
                os.remove(rdv)

    def sharded_path():
        X = topk_corpus()
        names_t = [f"c{i}" for i in range(TOPK_D)]
        sh = ShardedSketchIndex(num_shards=SHARDS, m=TOPK_M,
                                n_buckets=TOPK_BUCKETS, slots=TOPK_SLOTS,
                                seed=SEED, device=dev)
        for lo in range(0, TOPK_D, BLOCK_ROWS):
            sh.add_many(names_t[lo:lo + BLOCK_ROWS], X[lo:lo + BLOCK_ROWS])
        queries = X[:SHARD_QUERIES].copy()
        del X
        check(np.array_equal(homes_of(sh), np.stack(
            [np.arange(TOPK_D) % SHARDS, np.arange(TOPK_D) // SHARDS], 1)),
              "skewed: the homes are not round-robin")
        n_tasks = SHARDS * (SHARDS + 1) // 2
        scans = {mode: counted(
            lambda: sh.top_pairs(TOPK_K, absolute=absolute),
            f"sharded skewed top_pairs {mode}", tasks=n_tasks)
            for mode, absolute in (("plain", False), ("absolute", True))}
        cheb = ShardedDiscoveryEngine(sh, tile=TOPK_TILE,
                                      ceiling="chebyshev").top_pairs(TOPK_K)
        for res in (*scans.values(), cheb):
            st = res.stats
            check(not res.degraded and res.coverage == 1.0
                  and st.kernel_launches == st.tiles_launched > 0
                  and st.tiles_launched + st.tiles_pruned == st.tiles_total
                  == dp["scans"]["plain"].stats.tiles_total,
                  f"skewed sharded scan: {st}, coverage {res.coverage}")
        q_scans = [sh.top_k_for_query(q, TOPK_K) for q in queries]
        q_index = [sh.query(q, top_k=TOPK_K) for q in queries]
        t0 = time.perf_counter()
        est_s = sh.all_pairs()
        all_pairs_ms = (time.perf_counter() - t0) * 1e3
        faults = fault_gates(sh, dp["scans"]["plain"].items)
        # the flat index: the main path's rows in the main path's order
        fsh = ShardedSketchIndex(num_shards=SHARDS, m=M, n_buckets=N_BUCKETS,
                                 slots=SLOTS, seed=SEED, device=dev)
        for lo in range(0, D_BATCH, BLOCK_ROWS):
            rows = list(range(lo, min(lo + BLOCK_ROWS, D_BATCH)))
            fsh.add_many([names[r] for r in rows],
                         dense_rows(vidx, vval, rows))
        for d in range(D_BATCH, D):
            fsh.add(names[d], indices=vidx[d], values=vval[d])
        t0 = time.perf_counter()
        fscan = counted(lambda: fsh.top_pairs(TOPK_K),
                        "sharded flat top_pairs", tasks=n_tasks)
        fscan_ms = (time.perf_counter() - t0) * 1e3
        fq = [planted(qi, sources[qi]) for qi in range(FLAT_QUERIES)]
        f_answers = [fsh.query(q) for q in fq]
        f_all_pairs = fsh.all_pairs()
        nccl_A, nccl = nccl_build()
        return dict(index=sh, queries=queries, scans=scans, cheb=cheb,
                    q_scans=q_scans, q_index=q_index, est=est_s,
                    all_pairs_ms=all_pairs_ms, faults=faults, flat=fsh,
                    fscan=fscan, fscan_ms=fscan_ms, fq=fq,
                    f_answers=f_answers, f_all_pairs=f_all_pairs,
                    nccl_A=nccl_A, nccl=nccl)

    shp, launches["sharded_path"] = run_path(kernels, sharded_path)
    # the query sketches are priority sketches: B1 and B2, not B3
    need = ("hash_rank_hist", "radix_select", "intersect_estimate",
            "allpairs_compact", "allpairs_estimate", "allpairs_join_tiles")
    check(all(launches["sharded_path"][k] > 0 for k in need),
          f"a kernel of the sharded path never launched: {launches}")
    # the gates against the global index (its launches outside the path)
    sh, fsh = shp["index"], shp["flat"]
    for mode in ("plain", "absolute"):
        check(shp["scans"][mode].items == dp["scans"][mode].items,
              f"skewed sharded top_pairs ({mode}) differs from the global "
              "index's")
    same_up_to_ties(shp["cheb"].items, dp["cheb"].items,
                    "skewed sharded Chebyshev scan vs the global one")
    est_g = dp["index"].all_pairs()
    assert_bits(torch.as_tensor(shp["est"]), torch.as_tensor(est_g),
                "skewed sharded all_pairs vs the global all_pairs")
    del est_g
    q_err = 0.0
    for i, (q, res, top) in enumerate(zip(shp["queries"], shp["q_scans"],
                                          shp["q_index"])):
        same_up_to_ties(res.items, dp["eng"].top_k_for_query(
            q, TOPK_K).items, f"skewed sharded top_k_for_query {i} vs the "
            "global one")
        q_err = max(q_err, same_ranking(
            res.items, top, f"skewed sharded top_k_for_query {i} vs "
            "query(top_k)"))
    check(shp["fscan"].items == dp["fscans"]["plain"].items,
          "flat sharded top_pairs differs from the global scan's")
    assert_bits(torch.as_tensor(shp["f_all_pairs"]), torch.as_tensor(ap),
                "flat sharded all_pairs vs the global all_pairs")
    for i, (q, got) in enumerate(zip(shp["fq"], shp["f_answers"])):
        want = index.query(q)
        check([n for n, _ in got] == [n for n, _ in want],
              f"flat query {i}: names differ")
        assert_bits(torch.tensor([e for _, e in got], dtype=torch.float32),
                    torch.tensor([e for _, e in want], dtype=torch.float32),
                    f"flat sharded query {i} vs the global query")
    nccl = shp["nccl"]
    one_shot = tk.build_priority_corpus(shp["nccl_A"], M, SEED)
    for g, w, f in zip(nccl["priority"], one_shot, ("idx", "val", "tau")):
        assert_bits(g, w, f"NCCL partitioned priority {f} vs the one-shot "
                          "build")
    one_shot_t = tk.build_threshold_corpus(shp["nccl_A"], M, SEED)
    assert_bits(nccl["threshold"].idx, one_shot_t.idx,
                "NCCL partitioned threshold idx vs the one-shot build")
    nccl_tau_err = assert_tol(nccl["threshold"].tau, one_shot_t.tau, 1e-5,
                              0.0, "NCCL partitioned threshold tau")
    # B5 on one cross-shard tile (the first tiles of shards 0 and 1)
    # against its plain version and the global matrix's block
    e0, e1 = sh._discovery._engines[:2]
    e0._prepare()
    e1._prepare()
    (c0, p0), (c1, p1) = (e0._dev, e0._probs), (e1._dev, e1._probs)
    r0, r1 = e0.tile_members(0), e1.tile_members(0)
    cross_args = (c0.idx, c0.val, p0, c1.idx, c1.val, p1, r0, r1)
    cross = tk.estimate_tile_rows(*cross_args)
    cross_err = assert_close(
        cross, tk.estimate_tile_rows(*cross_args, use_kernel=False),
        f"cross-shard tile ({len(r0)}, {len(r1)}) vs its plain route")
    gid = {h: g for g, h in enumerate(sh._homes)}
    assert_bits(cross.cpu(), torch.as_tensor(shp["est"][np.ix_(
        [gid[(0, int(r))] for r in r0], [gid[(1, int(r))] for r in r1])]),
        "cross-shard tile vs the global matrix's block")
    err["allpairs_estimate"] = max(err["allpairs_estimate"], cross_err)
    del shp["est"], shp["f_all_pairs"]
    emit({"phase": "sharded_path", "shards": SHARDS,
          "skewed": {
              "D": TOPK_D, "n": TOPK_N, "m": TOPK_M,
              "n_buckets": TOPK_BUCKETS, "slots": TOPK_SLOTS,
              "tile": TOPK_TILE, "k": TOPK_K,
              "shard_sizes": [len(s) for s in sh._shards],
              "top_pairs": {k: stats_of(v) for k, v in shp["scans"].items()},
              "global_top_pairs": {k: stats_of(v)
                                   for k, v in dp["scans"].items()},
              "chebyshev": stats_of(shp["cheb"]),
              "top_k_for_query_launched_p50": float(np.median(
                  [r.stats.tiles_launched for r in shp["q_scans"]])),
              "query_vs_index_query_max_abs_err": q_err,
              "all_pairs_ms": shp["all_pairs_ms"],
              "cross_tile_vs_plain": {
                  "shape": [len(r0), len(r1), TOPK_BUCKETS, TOPK_SLOTS],
                  "max_abs_err": cross_err, "parity": f"rtol={RTOL}"}},
          "flat": {"D": D, "top_pairs": stats_of(shp["fscan"]),
                   "top_pairs_ms": shp["fscan_ms"],
                   "queries_bit_equal": FLAT_QUERIES},
          "faults": shp["faults"],
          "scans": {k: v for k, v in scan_meta.items()
                    if k.startswith("sharded")},
          "nccl_build": {"backend": nccl["backend"], "world": nccl["world"],
                         "shape": list(shp["nccl_A"].shape),
                         "first_call_ms": nccl["first_call_ms"],
                         "priority_ms": nccl["priority_ms"],
                         "threshold_ms": nccl["threshold_ms"],
                         "threshold_tau_max_abs_err": nccl_tau_err},
          "gates_passed": [
              "skewed top_pairs (plain, absolute) and all_pairs bit-equal "
              "to the global index's; Chebyshev up to exact ties",
              "top_k_for_query bit-equal to the global scan (up to exact "
              "ties) and by names to query(top_k)",
              "flat top_pairs, all_pairs and query bit-equal to the global "
              "index's",
              "lost shard: coverage as reckoned, surviving true pairs "
              "found, 2 tries (ConnectionError), 1 (TimeoutError); killed "
              "shard never called, revived coverage 1.0",
              "NCCL world-1 build: priority bit-equal, threshold idx "
              "bit-equal and tau within rtol 1e-5"],
          "seconds": shp["seconds"],
          "launches": launches["sharded_path"]})

    # ------------------------------------------------------- resilience path
    def dir_bytes(path) -> int:
        return sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(path) for f in fs)

    def shard_energy(v, bounds) -> np.ndarray:
        return np.array([float(np.sum(v[lo:hi].astype(np.float64) ** 2))
                         for lo, hi in bounds])

    def median_s(fn, n_rep: int, warmup: int = 1) -> float:
        """Median host seconds of ``fn`` after ``warmup`` calls, as
        ``benchmarks/common.py::time_callable``."""
        for _ in range(warmup):
            fn()
        ts = []
        for _ in range(n_rep):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def gate_share(err, bound, what) -> dict:
        """The share of estimates beyond their bound (the Chebyshev
        guarantee: at most delta) and the largest error over bound."""
        ratio = np.asarray(err, np.float64) / np.asarray(bound, np.float64)
        share = float(np.mean(ratio > 1.0))
        check(share <= RES_DELTA, f"{what}: {share} of the estimates beyond "
              f"their bound (delta {RES_DELTA})")
        return {"beyond_bound_share": share, "max_err_over_bound":
                float(ratio.max())}

    res_tmp = os.path.join(ROOT, "build", f"resilience-{os.getpid()}")
    res_queries = [planted(qi, src) for qi, src in enumerate(sources)]

    def resilience_path():
        """Degraded reads, the degraded-serving sweep, durability, the
        resilient store and the canaries, observability on throughout;
        the durable indexes' directory is removed however it ends."""
        try:
            return resilience_run()
        finally:
            obs.disable()
            obs.reset()
            shutil.rmtree(res_tmp, ignore_errors=True)

    def resilience_run():
        obs.reset()
        obs.enable()
        want = collections.Counter()   # what the registry must count
        shutil.rmtree(res_tmp, ignore_errors=True)
        os.makedirs(res_tmp)

        def read(fanout, call, surface):
            """One guarded read: its shard attempts (one a shard up) and,
            served degraded, the surface's count."""
            want["attempts"] += fanout.num_shards - len(fanout.down_shards())
            res = call()
            want[f"degraded {surface}"] += res.degraded
            want[f"coverage {surface}"] = res.coverage
            return res

        out = {}
        # -- degraded serving at the main path's widths ------------------
        rix = ResilientSketchIndex(N, num_shards=RES_SHARDS, m=M,
                                   n_buckets=N_BUCKETS, slots=SLOTS,
                                   seed=SEED, retry=RES_RETRY, device=dev)
        V = torch.empty((D, N), dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        for lo in range(0, D, BLOCK_ROWS):
            rows = list(range(lo, min(lo + BLOCK_ROWS, D)))
            blk = dense_rows(vidx, vval, rows)
            rix.add_many([names[r] for r in rows], blk)
            V[lo:lo + len(rows)] = torch.as_tensor(blk, device=dev)
        ingest_s = time.perf_counter() - t0
        V64 = V.double()
        del V
        Q64 = torch.as_tensor(np.stack(res_queries), device=dev).double()
        exact = (Q64 @ V64.T).cpu().numpy()
        gram = (V64 @ V64.T).cpu().numpy()
        del V64, Q64
        levels = {}
        for kills in ((), (1,), (1, 3)):
            for p in range(RES_SHARDS):
                rix.revive_shard(p)
            for p in kills:
                rix.kill_shard(p, "resilience path")
            surv = [p for p in range(RES_SHARDS) if p not in kills]
            est = np.empty((N_QUERIES, D), np.float32)
            bnd = np.empty((N_QUERIES, D), np.float64)
            q_ms, cov_err, cov_min = [], 0.0, 1.0
            for qi, qv in enumerate(res_queries):
                t0 = time.perf_counter()
                r = read(rix, lambda: rix.query(qv), "serve.query")
                q_ms.append((time.perf_counter() - t0) * 1e3)
                check(r.down_shards == kills, f"down shards {r.down_shards}")
                e2 = shard_energy(qv, rix.bounds)
                share = e2[surv].sum() / e2.sum()
                cov_err = max(cov_err, abs(r.coverage - share) / share)
                cov_min = min(cov_min, r.coverage)
                check(abs(r.coverage - share) <= 1e-6 * share,
                      f"query {qi}, {len(kills)} down: coverage {r.coverage}"
                      f" vs the surviving energy share {share}")
                if not kills:
                    check(r.coverage == 1.0 and not r.degraded,
                          f"healthy query {qi}: coverage {r.coverage}")
                est[qi], bnd[qi] = r.estimates, r.bound
            levels[len(kills)] = {
                "down": list(kills), **gate_share(
                    np.abs(est.astype(np.float64) - exact), bnd,
                    f"{len(kills)} shards down: query"),
                "coverage_min": cov_min,
                "coverage_max_rel_err": cov_err,
                "query_p50_ms": float(np.percentile(q_ms, 50)),
                "query_p99_ms": float(np.percentile(q_ms, 99))}
        # all_pairs with shard 1 down: the surviving shards' own sum
        for p in range(RES_SHARDS):
            rix.revive_shard(p)
        rix.kill_shard(1, "resilience path")
        t0 = time.perf_counter()
        ap_d = read(rix, rix.all_pairs, "serve.all_pairs")
        ap_ms = (time.perf_counter() - t0) * 1e3
        check(ap_d.down_shards == (1,) and ap_d.estimates.shape == (D, D),
              "degraded all_pairs shape or down shards")
        own = np.zeros((D, D), np.float64)
        for p in (0, 2, 3):
            own += rix._shards[p].all_pairs()
        assert_bits(torch.as_tensor(ap_d.estimates),
                    torch.as_tensor(own.astype(np.float32)),
                    "degraded all_pairs vs the surviving shards' sum")
        ap_gate = gate_share(np.abs(ap_d.estimates.astype(np.float64) - gram),
                             ap_d.bound, "1 shard down: all_pairs")
        del own, gram
        q0 = res_queries[0]
        try:
            read(rix, lambda: rix.query(q0, strict=True), "serve.query")
            check(False, "strict mode served a degraded answer")
        except DegradedServiceError:
            pass
        for p in range(RES_SHARDS):
            rix.kill_shard(p, "resilience path")
        try:
            read(rix, lambda: rix.query(q0), "serve.query")
            check(False, "a query with every shard down was answered")
        except ShardDownError:
            pass
        for p in range(RES_SHARDS):
            rix.revive_shard(p)

        def hang(shard, fn):
            if shard == 2:
                raise TimeoutError("injected hang")
            return fn()
        rix._call_wrapper = hang
        r = read(rix, lambda: rix.query(q0), "serve.query")
        check(r.down_shards == (2,) and "TimeoutError" in
              rix.down_shards()[2], "the hung shard was not marked down")
        want["deadline_hits"] += 1
        want["shard_down"] += 1
        rix._call_wrapper = None
        rix.revive_shard(2)
        # query p50, observability off and on (not gated)
        p50 = {}
        for state in ("disabled", "enabled"):
            (obs.disable if state == "disabled" else obs.enable)()
            ms = []
            for qv in res_queries[:64]:
                if state == "enabled":
                    want["attempts"] += RES_SHARDS
                t0 = time.perf_counter()
                rix.query(qv)
                ms.append((time.perf_counter() - t0) * 1e3)
            p50[state] = float(np.percentile(ms, 50))
        want["coverage serve.query"] = 1.0
        out["serving"] = {"D": D, "n": N, "m": M, "shards": RES_SHARDS,
                          "ingest_s": ingest_s, "levels": levels,
                          "all_pairs_one_down": {**ap_gate, "ms": ap_ms,
                                                 "coverage": ap_d.coverage},
                          "query_p50_ms_obs": p50}
        del rix, ap_d

        # -- benchmarks/degraded_serving.py's sweep at its FULL_POINT ----
        Dd, nd, md, Pd = DEG_POINT
        srng = np.random.default_rng(17)
        six = ResilientSketchIndex(nd, num_shards=Pd, m=md, n_buckets=2 * md,
                                   seed=SEED, retry=RES_RETRY, device=dev)
        Vd = srng.standard_normal((Dd, nd)).astype(np.float32)
        six.add_many([f"v{d}" for d in range(Dd)], Vd)
        Qd = srng.standard_normal((DEG_QUERIES, nd)).astype(np.float32)
        true = Vd.astype(np.float64) @ Qd.astype(np.float64).T
        sweep = []
        for frac in DEG_LOSSES:
            k = int(round(frac * Pd))
            for p in range(Pd):
                six.revive_shard(p)
            for p in range(k):
                six.kill_shard(p, "chaos sweep")
            worst, covs = 0.0, []
            for qi in range(DEG_QUERIES):
                r = read(six, lambda: six.query(Qd[qi]), "serve.query")
                err = np.abs(np.asarray(r.estimates, np.float64) - true[:, qi])
                worst = max(worst, float(np.max(err / np.asarray(r.bound))))
                covs.append(r.coverage)

            def one():
                read(six, lambda: six.query(Qd[0]), "serve.query")
            sweep.append({"loss_fraction": frac, "shards_down": k,
                          "ms_query": median_s(one, 3) * 1e3,
                          "coverage": float(np.mean(covs)),
                          "max_err_over_bound": worst})
            check(worst <= 1.0, f"sweep loss {frac}: max error over bound "
                  f"{worst}")
        covs = [s["coverage"] for s in sweep]
        check(covs[0] == 1.0 and all(a >= b - 1e-6
                                     for a, b in zip(covs, covs[1:])),
              f"sweep coverage not monotone: {covs}")
        out["sweep"] = {"D": Dd, "n": nd, "m": md, "P": Pd, "points": sweep}
        del six, Vd

        # -- durability at the main path's widths -------------------------
        kw = dict(m=M, n_buckets=N_BUCKETS, slots=SLOTS, seed=SEED,
                  device=dev)
        ddir = os.path.join(res_tmp, "main")
        dur = DurableSketchIndex(ddir, **kw)
        t0 = time.perf_counter()
        for lo in range(0, 7 * BLOCK_ROWS, BLOCK_ROWS):
            rows = list(range(lo, lo + BLOCK_ROWS))
            dur.add_many([names[r] for r in rows],
                         dense_rows(vidx, vval, rows))
        snap7 = dur.snapshot()
        rows = list(range(7 * BLOCK_ROWS, D_BATCH))
        dur.add_many([names[r] for r in rows], dense_rows(vidx, vval, rows))
        for d in range(D_BATCH, D):
            dur.add(names[d], indices=vidx[d], values=vval[d])
        durable_ingest_s = time.perf_counter() - t0
        want["wal add_many"] += 8
        want["wal add"] += D_SPARSE
        want["snapshots"] += 1
        pre = dur.index
        pre_answers = [pre.query(q) for q in res_queries]
        pre_top = pre.top_pairs(10).items
        dur.journal.close()
        with open(dur.journal.path) as f:
            last = f.readlines()[-1]
        with open(dur.journal.path, "a") as f:      # a torn tail
            f.write(last[: len(last) // 2])
        journal_bytes = sum(os.path.getsize(os.path.join(ddir, f))
                            for f in os.listdir(ddir) if f.endswith(".wal"))
        snapshot_bytes = dir_bytes(snap7)

        def recovered_gates(rec, what, replayed, dropped):
            check((rec.replayed_ops, rec.dropped_tail) == (replayed, dropped),
                  f"{what}: replayed {rec.replayed_ops} ops, dropped "
                  f"{rec.dropped_tail}; expected {replayed}, {dropped}")
            check(rec.index._names == pre._names, f"{what}: names differ")
            for k in ("_idx", "_val", "_tau", "_dropped", "_g", "_kn"):
                assert_bits(torch.as_tensor(getattr(rec.index, k)[:D]),
                            torch.as_tensor(getattr(pre, k)[:D]),
                            f"{what}: {k} vs the pre-crash index")
            for qi, q in enumerate(res_queries):
                check(rec.query(q) == pre_answers[qi],
                      f"{what}: query {qi} differs from the pre-crash one")
            check(rec.index.top_pairs(10).items == pre_top,
                  f"{what}: top_pairs(10) differs from the pre-crash one")

        t0 = time.perf_counter()
        rec = DurableSketchIndex.recover(ddir, **kw)
        recover_s = time.perf_counter() - t0
        want["recoveries"] += 1
        recovered_gates(rec, "recovery", 1 + D_SPARSE, 1)

        def rebuild():
            fresh = SketchIndex(**kw)
            for lo in range(0, D_BATCH, BLOCK_ROWS):
                rows = list(range(lo, min(lo + BLOCK_ROWS, D_BATCH)))
                fresh.add_many([names[r] for r in rows],
                               dense_rows(vidx, vval, rows))
            for d in range(D_BATCH, D):
                fresh.add(names[d], indices=vidx[d], values=vval[d])
            return fresh
        t0 = time.perf_counter()
        rebuild()
        rebuild_s = time.perf_counter() - t0
        # a newer snapshot with a flipped byte: quarantined, the older one
        # and the archived journal segment serve the recovery
        newest = rec.snapshot()
        want["snapshots"] += 1
        rec.journal.close()
        with open(os.path.join(newest, "val.npy"), "r+b") as f:
            f.seek(-11, os.SEEK_END)
            b = f.read(1)
            f.seek(-11, os.SEEK_END)
            f.write(bytes([b[0] ^ 0x10]))
        t0 = time.perf_counter()
        rec2 = DurableSketchIndex.recover(ddir, **kw)
        fallback_s = time.perf_counter() - t0
        want["recoveries"] += 1
        want["quarantines"] += 1
        check(os.path.isdir(newest + ".quarantined")
              and list_snapshots(os.path.join(ddir, "snapshots")) == [snap7],
              "the corrupt snapshot was not quarantined")
        recovered_gates(rec2, "fallback recovery", 1 + D_SPARSE, 0)
        rec2.journal.close()
        out["durability"] = {
            "D": D, "ingest": f"7 x {BLOCK_ROWS} add_many, snapshot, "
            f"{D_BATCH - 7 * BLOCK_ROWS} add_many, {D_SPARSE} sparse add",
            "durable_ingest_s": durable_ingest_s,
            "journal_bytes": journal_bytes, "snapshot_bytes": snapshot_bytes,
            "recover_s": recover_s, "rebuild_s": rebuild_s,
            "rebuild_over_recover": rebuild_s / recover_s,
            "fallback_recover_s": fallback_s,
            "replayed_ops": rec.replayed_ops,
            "dropped_tail": rec.dropped_tail}
        del dur, rec, rec2, pre, pre_answers
        shutil.rmtree(ddir)

        # -- the recovery gate at degraded_serving.py's recovery point ----
        Dr, nr, mr = REC_POINT
        rdir = os.path.join(res_tmp, "recovery")
        rnames, Vr, rkw = recovery_point(rdir, dev)
        want["wal add_many"] += REC_BATCHES
        want["snapshots"] += 1

        def recover_r():
            want["recoveries"] += 1
            r = DurableSketchIndex.recover(rdir, **rkw)
            r.journal.close()
            return r

        def rebuild_r():
            fresh = SketchIndex(**rkw)
            fresh.add_many(rnames, Vr)
            return fresh
        s_recover = median_s(recover_r, REC_REPS)
        s_rebuild = median_s(rebuild_r, REC_REPS)
        r, f = recover_r(), rebuild_r()
        exact_r = r.index._names == f._names and all(
            np.array_equal(getattr(r.index, k)[:Dr], getattr(f, k)[:Dr])
            for k in ("_idx", "_val", "_tau"))
        check(exact_r, "recovery point: recovered index not bit-exact")
        check(s_rebuild / s_recover >= REC_SPEEDUP,
              f"recovery {s_recover * 1e3:.1f} ms is not {REC_SPEEDUP}x "
              f"faster than the rebuild's {s_rebuild * 1e3:.1f} ms")
        out["recovery_point"] = {"D": Dr, "n": nr, "m": mr,
                                 "batches": REC_BATCHES,
                                 "recover_ms": s_recover * 1e3,
                                 "rebuild_ms": s_rebuild * 1e3,
                                 "speedup": s_rebuild / s_recover,
                                 "gate": REC_SPEEDUP, "bit_exact": exact_r}
        del r, f, Vr
        shutil.rmtree(rdir)

        # -- durable merges on merge_path's partitions (B6 on replay) ----
        parts = partition_bounds(N, PARTITIONS)

        def ingest_part(ix, p):
            lo_c, hi_c = parts[p]
            for lo in range(0, D_BATCH, BLOCK_ROWS):
                rows = list(range(lo, min(lo + BLOCK_ROWS, D_BATCH)))
                blk = dense_rows(vidx, vval, rows)
                blk[:, :lo_c] = 0.0
                blk[:, hi_c:] = 0.0
                ix.add_many([names[r] for r in rows], blk)
            for d in range(D_BATCH, D):
                side = (vidx[d] >= lo_c) & (vidx[d] < hi_c)
                ix.add(names[d], indices=vidx[d][side], values=vval[d][side])
        mdir = os.path.join(res_tmp, "merge")
        mdur = DurableSketchIndex(mdir, **kw)
        ingest_part(mdur, 0)
        mdur.snapshot()
        want["wal add_many"] += len(range(0, D_BATCH, BLOCK_ROWS))
        want["wal add"] += D_SPARSE
        want["snapshots"] += 1
        for p in range(1, PARTITIONS):
            peer = SketchIndex(**kw)
            ingest_part(peer, p)
            mdur.merge_from(peer)
            want["wal merge_from"] += 1
        del peer
        mpre = mdur.index
        mq = res_queries[:32]
        m_answers = [mpre.query(q) for q in mq]
        mdur.journal.close()
        merges = tk.merge_bucketized.launches
        t0 = time.perf_counter()
        mrec = DurableSketchIndex.recover(mdir, **kw)
        merge_recover_s = time.perf_counter() - t0
        want["recoveries"] += 1
        check(tk.merge_bucketized.launches - merges == PARTITIONS - 1,
              "the replayed merges did not run the merge kernel once each")
        check((mrec.replayed_ops, mrec.dropped_tail) == (PARTITIONS - 1, 0),
              f"merge recovery replayed {mrec.replayed_ops} ops")
        check(mrec.index._names == mpre._names, "merged names differ")
        for k in ("_idx", "_val", "_tau", "_dropped", "_g", "_kn"):
            assert_bits(torch.as_tensor(getattr(mrec.index, k)[:D]),
                        torch.as_tensor(getattr(mpre, k)[:D]),
                        f"recovered merged {k} vs the pre-crash index")
        for qi, q in enumerate(mq):
            check(mrec.query(q) == m_answers[qi],
                  f"recovered merged index: query {qi} differs")
        mrec.journal.close()
        out["durable_merge"] = {
            "partitions": PARTITIONS, "merges_replayed": mrec.replayed_ops,
            "journal_bytes": sum(os.path.getsize(os.path.join(mdir, f))
                                 for f in os.listdir(mdir)
                                 if f.endswith(".wal")),
            "recover_s": merge_recover_s,
            "clean_rows": int(((mpre._dropped[:D]) == 0).sum())}
        del mdur, mrec, mpre
        shutil.rmtree(mdir)

        # -- ResilientMatrixStore at matrix_path's widths -----------------
        rms = ResilientMatrixStore(MAT_N, MAT_D, num_shards=RES_SHARDS,
                                   m=MAT_M, seed=SEED, retry=RES_RETRY,
                                   device=dev)
        As = torch.empty((MAT_C, MAT_N, MAT_D), dtype=torch.float32,
                         device=dev)
        t0 = time.perf_counter()
        for c in range(MAT_C):
            As[c] = matrix_pair(c, dev)[0]
            rms.add(mat_names[c], As[c].cpu().numpy())
        store_ingest_s = time.perf_counter() - t0
        pairs = mx["pairs"]
        ia = torch.as_tensor(pair_ix[:, 0], device=dev)
        ib = torch.as_tensor(pair_ix[:, 1], device=dev)
        true_p = torch.einsum("pnd,pne->pde", As[ia].double(),
                              As[ib].double()).cpu().numpy()
        Qs = [matrix_pair(int(c), dev)[1] for c in q_src]
        # every (query, stored) exact product in float64 as one GEMM:
        # rows (query, d), columns (stored, e)
        A64 = As.permute(1, 0, 2).reshape(MAT_N, MAT_C * MAT_D).double()
        Q64 = torch.stack(Qs).double().permute(0, 2, 1).reshape(
            len(Qs) * MAT_D, MAT_N)
        true_q = (Q64 @ A64).reshape(len(Qs), MAT_D, MAT_C, MAT_D).permute(
            0, 2, 1, 3).cpu().numpy()
        del A64, Q64
        store = {}
        for kills in ((), (2,)):
            for p in range(RES_SHARDS):
                rms.revive_shard(p)
            for p in kills:
                rms.kill_shard(p, "resilience path")
            t0 = time.perf_counter()
            prods = read(rms, lambda: rms.products(pairs), "products")
            prod_ms = (time.perf_counter() - t0) * 1e3
            q_ms, answers = [], []
            for Q in Qs:
                Qh = Q.cpu().numpy()
                t0 = time.perf_counter()
                answers.append(read(rms, lambda: rms.query(Qh),
                                    "serve.matrix_query"))
                q_ms.append((time.perf_counter() - t0) * 1e3)
            surv = [p for p in range(RES_SHARDS) if p not in kills]
            own = sum(rms._shards[p].products(pairs).astype(np.float64)
                      for p in surv)
            assert_bits(torch.as_tensor(prods.estimates),
                        torch.as_tensor(own.astype(np.float32)),
                        f"{len(kills)} down: products vs the shards' sum")
            own_q = sum(np.stack([e for _, e in rms._shards[p].query(
                Qs[0].cpu().numpy()[rms.bounds[p][0]:rms.bounds[p][1]])])
                .astype(np.float64) for p in surv)
            assert_bits(torch.as_tensor(answers[0].estimates),
                        torch.as_tensor(own_q.astype(np.float32)),
                        f"{len(kills)} down: query vs the shards' sum")
            frob_p = np.linalg.norm(
                (prods.estimates.astype(np.float64) - true_p).reshape(
                    len(pairs), -1), axis=1)
            gates = {"products": gate_share(
                frob_p, prods.bound, f"{len(kills)} down: products")}
            q_err, q_bnd = [], []
            for qi, ans in enumerate(answers):
                q_err.append(np.linalg.norm(
                    (ans.estimates.astype(np.float64) - true_q[qi]).reshape(
                        MAT_C, -1), axis=1))
                q_bnd.append(np.asarray(ans.bound))
            gates["query"] = gate_share(np.concatenate(q_err),
                                        np.concatenate(q_bnd),
                                        f"{len(kills)} down: store query")
            store[len(kills)] = {"down": list(kills), **gates,
                                 "coverage_products": prods.coverage,
                                 "products_ms": prod_ms,
                                 "query_p50_ms": float(np.percentile(q_ms,
                                                                     50)),
                                 "prods": prods, "answers": answers}
        # the port's CPU run on the same inputs: the shards' sketches
        # through snapshots (a sample re-sketched on the CPU, bit-equal),
        # the healthy products and 16 queries estimated on the CPU
        cpu_shards = []
        for p, sh_p in enumerate(rms._shards):
            path = save_snapshot(sh_p, os.path.join(res_tmp, f"store{p}"))
            cpu_shards.append(load_snapshot(path, device="cpu")[0])
        for c in (0, 1, MAT_C - 1):
            for p, (lo, hi) in enumerate(rms.bounds):
                sk = priority_matrix_sketch(As[c, lo:hi].cpu(), MAT_M,
                                            rms._shards[p].seed)
                assert_bits(sk.row_idx, torch.as_tensor(
                    rms._shards[p]._idx[c]), f"CPU sketch {c} shard {p}")
                assert_bits(sk.rows, torch.as_tensor(
                    rms._shards[p]._rows[c]), f"CPU rows {c} shard {p}")
        # the card's layout drops a bucket's overflow (the CPU's sorted
        # join does not): compare where no shard's layout dropped a row
        lib_clean = np.ones(MAT_C, bool)
        for sh_p in rms._shards:
            lib_clean &= sh_p._buckets()[0].dropped[:MAT_C].cpu().numpy() == 0
        clean_p = lib_clean[pair_ix[:, 0]] & lib_clean[pair_ix[:, 1]]
        cpu_p = sum(s.products(pairs).astype(np.float64) for s in cpu_shards)
        cpu_err = assert_close(
            torch.as_tensor(store[0]["prods"].estimates[clean_p]),
            torch.as_tensor(cpu_p.astype(np.float32)[clean_p]),
            "healthy store products vs the CPU run")
        q_compared = 0
        for Q, ans in zip(Qs, store[0]["answers"]):
            if q_compared == 16:
                break
            Qh = Q.cpu().numpy()
            if any(int(tk.bucketize_matrix_sketches(priority_matrix_sketch(
                    Q[lo:hi], MAT_M, sh_p.seed)).dropped[0]) > 0
                   for sh_p, (lo, hi) in zip(rms._shards, rms.bounds)):
                continue
            cpu_q = sum(np.stack([e for _, e in s.query(
                Qh[lo:hi])]).astype(np.float64)
                for s, (lo, hi) in zip(cpu_shards, rms.bounds))
            cpu_err = max(cpu_err, assert_close(
                torch.as_tensor(ans.estimates[lib_clean]),
                torch.as_tensor(cpu_q.astype(np.float32)[lib_clean]),
                "healthy store query vs the CPU run"))
            q_compared += 1
        check(q_compared >= 8 and clean_p.sum() >= MAT_PAIRS // 4,
              f"too few drop-free store answers to compare: {q_compared} "
              f"queries, {int(clean_p.sum())} pairs")
        for v in store.values():
            del v["prods"], v["answers"]
        out["store"] = {"C": MAT_C, "n": MAT_N, "d": MAT_D, "m": MAT_M,
                        "shards": RES_SHARDS, "ingest_s": store_ingest_s,
                        "levels": store, "cpu_max_abs_err": cpu_err,
                        "cpu_compared": {
                            "pairs": int(clean_p.sum()),
                            "queries": q_compared,
                            "stored": int(lib_clean.sum()),
                            "rule": "no shard's layout dropped a row"}}
        del rms, As, cpu_shards, true_q, true_p

        # -- canaries -----------------------------------------------------
        cix = ResilientSketchIndex(N, num_shards=RES_SHARDS, m=M,
                                   n_buckets=N_BUCKETS, slots=SLOTS,
                                   seed=SEED, retry=RES_RETRY, device=dev)
        ones = np.ones(N, np.float32)
        cix.add("target", ones)
        mon = CanaryMonitor.from_vectors(
            cix, [("ones", ones, "target", ones)], registry=obs.registry(),
            m=M)
        want["attempts"] += RES_SHARDS
        healthy = mon.check()[0]
        reg = obs.registry()
        check(not healthy.violated and reg.value("repro_canary_slo_ok") == 1,
              f"healthy canary outside its budget: {healthy}")
        cix.kill_shard(1)
        cix.kill_shard(3)
        want["attempts"] += RES_SHARDS - 2
        want["degraded serve.query"] += 1
        degraded = mon.check()[0]
        want["coverage serve.query"] = 0.5
        check(degraded.violated and reg.value("repro_canary_slo_ok") == 0,
              f"2 shards down and the canary stayed inside: {degraded}")
        out["canary"] = {"healthy_ratio": healthy.budget_ratio,
                         "degraded_ratio": degraded.budget_ratio,
                         "degraded_error": degraded.error,
                         "halfwidth": degraded.halfwidth}

        # -- the exposition: every family the path fed --------------------
        text = obs.prometheus_text()
        samples = {}
        for line in text.splitlines():
            if not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                samples[key] = float(value)

        def sample(key, expected, what):
            check(samples.get(key) == expected,
                  f"{key} = {samples.get(key)}, the path did {expected} "
                  f"({what})")
        for op in ("add_many", "add", "merge_from"):
            sample(f'repro_wal_appends_total{{op="{op}"}}',
                   want[f"wal {op}"], "journal appends")
        sample("repro_snapshots_total", want["snapshots"], "snapshots")
        sample("repro_snapshot_quarantines_total", want["quarantines"],
               "quarantines")
        sample("repro_recovery_total", want["recoveries"], "recoveries")
        sample("repro_recovery_replayed_ops", PARTITIONS - 1,
               "the last recovery's replay")
        sample("repro_recovery_dropped_tail", 0, "the last recovery's tail")
        check(samples.get("repro_recovery_snapshot_age_seconds", -1) >= 0,
              "recovery snapshot age")
        for surface in ("serve.query", "serve.all_pairs",
                        "serve.matrix_query"):
            sample(f'repro_degraded_results_total{{surface="{surface}"}}',
                   want[f"degraded {surface}"], "degraded answers")
            sample(f'repro_quality_coverage{{surface="{surface}"}}',
                   want[f"coverage {surface}"], "the last coverage")
        sample('repro_retry_attempts_total{surface="serve"}',
               want["attempts"], "guarded shard calls")
        sample('repro_deadline_hits_total{surface="serve"}',
               want["deadline_hits"], "timeouts")
        sample('repro_shard_down_total{surface="serve"}', want["shard_down"],
               "shards given up on")
        tr = obs.tracer()
        check(tr.active_depth() == 0, "spans left open")
        trace_path = os.path.join(res_tmp, "trace.jsonl")
        n_events = obs.export_chrome(trace_path)
        with open(trace_path) as f:
            events = [json.loads(ln) for ln in f]
        check(n_events == len(events) == len(tr.events())
              == tr.spans_finished - tr.spans_dropped
              and all(e["ph"] == "X" for e in events),
              "the Chrome export is not one event a finished span")
        out["exposition"] = {
            "families": len(obs.snapshot()), "lines": len(text.splitlines()),
            "spans_finished": tr.spans_finished,
            "spans_exported": n_events,
            "counts": dict(want)}
        return out

    rp, launches["resilience_path"] = run_path(kernels, resilience_path)
    need = ("hash_rank_hist", "radix_select", "intersect_estimate",
            "allpairs_compact", "allpairs_estimate", "merge_bucketized",
            "matrix_products")
    check(all(launches["resilience_path"][k] > 0 for k in need),
          f"a kernel of the resilience path never launched: {launches}")
    emit({"phase": "resilience_path", **rp,
          "gates_passed": [
              "degraded query at 0, 1, 2 shards down: coverage = the "
              "surviving energy share (rtol 1e-6), at most delta of the "
              "estimates beyond their bound; healthy coverage 1.0",
              "degraded all_pairs = the surviving shards' sum, bit for bit;"
              " bound held",
              "strict refuses, all down raises, a hung shard is marked down"
              " and counted",
              "degraded_serving.py sweep: max error over bound <= 1, "
              "coverage monotone",
              "recovery bit-equal (blocks, summaries, queries, top_pairs) "
              "after a torn tail and past a quarantined snapshot",
              f"recovery >= {REC_SPEEDUP}x faster than the rebuild at "
              "degraded_serving.py's recovery point",
              "3 durable merges replayed through B6, bit-equal",
              "resilient store: products and query = the surviving "
              "shards' sum; Frobenius bound held; healthy within rtol of "
              "the CPU run",
              "canary in budget healthy, violated at 2 shards down",
              "exposition counts = what the path did; one Chrome event a "
              "finished span"],
          "launches": launches["resilience_path"]})

    # ---------------------------------------------------------------- timing
    corpus = index._corpus()
    C, B, S = corpus.idx.shape
    blk = torch.as_tensor(dense_rows(vidx, vval, range(BLOCK_ROWS)),
                          device=dev)
    Db, nb = blk.shape
    _, rank, hist0 = tk.hash_rank_hist(blk, SEED)
    qv = np.zeros(N, np.float32)
    qv[vidx[sources[0]]] = vval[sources[0]]
    q = tk.bucketize(priority_sketch(torch.as_tensor(qv, device=dev), M,
                                     SEED), n_buckets=N_BUCKETS, slots=SLOTS)
    p_c = tk.slot_inclusion_probs(corpus)
    # compares the join needs: pairs of valid slots sharing a bucket
    per_bucket = (corpus.idx != INVALID_IDX).sum(dim=(0, 2)).double()
    join_ops = float((per_bucket * per_bucket).sum())
    qa = torch.as_tensor(quickstart.make_vectors()[0], device=dev)
    qn = qa.shape[0]

    def host_corpus(arrays):
        return tk.BucketizedSketch(*(torch.as_tensor(a, device=dev)
                                     for a in arrays))

    pre = mg["pre"]
    hi_ix = mg["hi"]
    mine = host_corpus([pre[k] for k in ("_idx", "_val", "_tau",
                                         "_dropped")])
    theirs = host_corpus([a[:D] for a in (hi_ix._idx, hi_ix._val,
                                          hi_ix._tau, hi_ix._dropped)])
    m_tau = tk.merged_tau_bucketized(mine, theirs, SEED, m=M)

    t = {}
    t["hash_rank_hist"] = (cuda_ms(lambda: tk.hash_rank_hist(blk, SEED)),
                           cuda_ms(lambda: hash_rank_hist_ref(blk, SEED),
                                   iters=5), None,
                           (2 * Db * nb + nb + Db * 256) * 4, "bytes")
    # B2: the whole selection (priority tau of one block, level 0 from
    # the hash/rank pass), one launch, against the plain descent and
    # torch.kthvalue on the same ranks
    t["radix_select"] = (
        cuda_ms(lambda: tk.radix_select(rank, M + 1, hist0=hist0)),
        cuda_ms(lambda: kth_smallest_ranks_ref(rank, M + 1, hist0=hist0),
                iters=5),
        cuda_ms(lambda: torch.kthvalue(rank, M + 1, dim=1), iters=5),
        (Db * nb + Db * 256 + Db) * 4, "bytes")
    t["hash_rank_batched"] = (
        cuda_ms(lambda: tk.hash_rank_batched(blk, SEED)),
        cuda_ms(lambda: hash_rank_batched_ref(blk, SEED), iters=5), None,
        (2 * Db * nb + nb) * 4, "bytes")
    t["hash_rank"] = (cuda_ms(lambda: tk.hash_rank(qa, 42)),
                      cuda_ms(lambda: hash_rank_ref(qa, 42), iters=5), None,
                      3 * qn * 4, "bytes")
    # without the level-0 histogram: a counting pass and a compaction pass
    selection_no_hist0_ms = cuda_ms(lambda: tk.radix_select(rank, M + 1))
    threshold_ms = cuda_ms(lambda: tk.build_threshold_corpus(
        blk, M, SEED, device=dev), iters=10)
    threshold_plain_ms = cuda_ms(lambda: tk.build_threshold_corpus(
        blk, M, SEED, device=dev, use_kernel=False), iters=5)
    threshold_bytes = Db * nb * 4 + Db * (CAP * 8 + 4)
    # B4's two bounds: the full stream (every id and value read once) and
    # the bytes this query's work needs (b4_needed_bytes)
    b4_full = {"served": C * B * S * 8 + C * 8 + B * S * 8 + 4}
    b4_need = {"served": b4_needed_bytes(q.idx, corpus.idx)}
    t["intersect_estimate"] = (
        cuda_ms(lambda: tk.intersect_estimate(q.idx, q.val, q.tau, corpus.idx,
                                              corpus.val, corpus.tau)),
        cuda_ms(lambda: intersect_estimate_ref(q.idx, q.val, q.tau,
                                               corpus.idx, corpus.val,
                                               corpus.tau), iters=5),
        None, b4_need["served"], "bytes")
    # B5: the compaction pass (once: one corpus against itself) and the
    # join, as all_pairs launches them; each step alone as well
    ap_ms = cuda_ms(lambda: tk.allpairs_estimate(
        corpus.idx, corpus.val, p_c, corpus.idx, corpus.val, p_c),
        warmup=2, iters=10)
    compact_ms = cuda_ms(lambda: tk.allpairs_compact(corpus.idx, corpus.val,
                                                     p_c))
    compact_plain_ms = cuda_ms(lambda: allpairs_compact_ref(
        corpus.idx, corpus.val, p_c), iters=3)
    compacted = tk.allpairs_compact(corpus.idx, corpus.val, p_c)
    ap_out = torch.empty((C, C), device=dev)
    ie_lib = importlib.import_module(
        "repro_torch.kernels.intersect_estimate.intersect_estimate")._lib()

    def join_raw():
        _build.check(ie_lib.repro_allpairs_join(
            compacted[0].data_ptr(), compacted[1].data_ptr(),
            compacted[0].data_ptr(), compacted[1].data_ptr(),
            ap_out.data_ptr(), C, C, B, S, 0,
            torch.cuda.current_stream().cuda_stream), "allpairs_join")

    join_ms = cuda_ms(join_raw, warmup=2, iters=10)
    occupied = int(compacted[1].sum())
    ap_plain = cuda_ms(lambda: allpairs_estimate_ref(
        corpus.idx, corpus.val, p_c, corpus.idx, corpus.val, p_c, ct=64),
        warmup=0, iters=1)
    # the full D x D matrix against its plain version too (the parity
    # phase held a 512 x 512 block; this is the main path's shape), and
    # against a second launch bit for bit
    ap_full = tk.allpairs_estimate(corpus.idx, corpus.val, p_c, corpus.idx,
                                   corpus.val, p_c)
    err["allpairs_estimate"] = max(err["allpairs_estimate"], assert_close(
        ap_full, allpairs_estimate_ref(corpus.idx, corpus.val, p_c,
                                       corpus.idx, corpus.val, p_c, ct=64),
        f"allpairs_estimate {C}x{C}"))
    assert_bits(tk.allpairs_estimate(corpus.idx, corpus.val, p_c, corpus.idx,
                                     corpus.val, p_c), ap_full,
                f"allpairs_estimate {C}x{C}, run to run")
    del ap_full
    # one corpus on both sides, compacted once: read once, D x D written
    ap_bytes = C * B * S * 12 + C * C * 4
    t["allpairs_estimate"] = (ap_ms, ap_plain, None, ap_bytes, "ops")
    # the compaction's bytes: the corpus read once, the occupied entries
    # (16 bytes) and the counts written once
    t["allpairs_compact"] = (compact_ms, compact_plain_ms, None,
                             C * B * S * 12 + occupied * 16
                             + compacted[1].numel() * 4, "bytes")
    # all_pairs step by step: the slot probabilities, B5, the copy of the
    # D x D matrix to the host
    ap_steps = {}
    pc_steps, ap_steps["slot_probabilities"] = step_ms(
        lambda: tk.slot_inclusion_probs(corpus))
    est_ap, ap_steps["kernel"] = step_ms(lambda: tk.allpairs_estimate(
        corpus.idx, corpus.val, pc_steps, corpus.idx, corpus.val, pc_steps))
    _, ap_steps["device_to_host"] = step_ms(lambda: est_ap.cpu().numpy())
    del est_ap, pc_steps
    # the merge kernel at the merge path's shape, against its plain version
    got = tk.merge_bucketized(mine.idx, mine.val, theirs.idx, theirs.val,
                              m_tau, SEED)
    ref = merge_bucketized_ref(mine.idx, mine.val, theirs.idx, theirs.val,
                               m_tau, SEED)
    for g, r, what in zip(got, ref, ("idx", "val", "dropped")):
        assert_bits(g, r, f"merge_bucketized D={D} {what}")
    t["merge_bucketized"] = (
        cuda_ms(lambda: tk.merge_bucketized(mine.idx, mine.val, theirs.idx,
                                            theirs.val, m_tau, SEED)),
        cuda_ms(lambda: merge_bucketized_ref(mine.idx, mine.val, theirs.idx,
                                             theirs.val, m_tau, SEED),
                iters=3),
        None, D * B * S * 24 + D * 8, "bytes")
    # B8 and B9 at Fig. 10's shape (n = 30000, m = 400), against their
    # plain versions and one PyTorch call each with the hashes excluded:
    # index_add_ of precomputed signed values into precomputed buckets
    # (B8), torch.mv with a materialised sign matrix (B9)
    idx_j = torch.arange(JOIN_KEYS, dtype=torch.int32, device=dev)
    b8_bucket = hash_bucket(sb, idx_j, JOIN_M).to(torch.int64)
    b8_signed = hash_sign(ss, idx_j) * fa0_t
    t["countsketch_scatter"] = (
        cuda_ms(lambda: tk.countsketch_scatter(fa0_t, JOIN_M, sb, ss)),
        cuda_ms(lambda: countsketch_ref(fa0_t, sb, ss, JOIN_M), iters=5),
        cuda_ms(lambda: torch.zeros(JOIN_M, device=dev).index_add_(
            0, b8_bucket, b8_signed)),
        (JOIN_KEYS + JOIN_M) * 4, "bytes")
    jl_rows = torch.arange(JOIN_M, dtype=torch.int64, device=dev)
    jl_seeds = jl_row_seeds(SEED, jl_rows)
    jl_S = jl_signs_ref(SEED, jl_rows, JOIN_KEYS)
    t["jl_rademacher"] = (
        cuda_ms(lambda: tk.jl_rademacher(fa0_t, jl_seeds),
                iters=WRAPPER_ITERS),
        cuda_ms(lambda: jl_rows_ref(fa0_t, jl_seeds), iters=3),
        cuda_ms(lambda: torch.mv(jl_S, fa0_t)),
        (JOIN_KEYS + 2 * JOIN_M) * 4, "ops")
    del jl_S

    def jl_bound_ms(n: int, m: int) -> float:
        """m n terms: 10 integer operations and one float add each, or
        the bytes (the vector and the row seeds read, the output
        written), whichever takes longer."""
        terms = float(n) * m
        return max(terms * JL_INT_OPS / INT32_OPS_PER_S * 1e3,
                   terms * 2 / FP32_OPS_PER_S * 1e3,
                   (n + 2 * m) * 4 / HBM_BYTES_PER_S * 1e3)

    # the other shapes the paths give them
    b8_shapes = {f"{c} n={int(v.shape[0])} m={m}": (
        cuda_ms(lambda v=v, m=m: tk.countsketch_scatter(v, m, sb, ss)),
        (int(v.shape[0]) + m) * 4 / HBM_BYTES_PER_S * 1e3)
        for c, v, m in b8_cases}
    b9_shapes = {}
    for c, v, m in b9_cases:
        seeds = jl_row_seeds(SEED, torch.arange(m, device=dev))
        b9_shapes[f"{c} n={int(v.shape[0])} m={m}"] = (
            cuda_ms(lambda v=v, seeds=seeds: tk.jl_rademacher(v, seeds),
                    iters=WRAPPER_ITERS),
            jl_bound_ms(int(v.shape[0]), m))
    # device-only times of the kernels whose wrappers' host time hides
    # them (B3 single-vector, B8, B9, B2 on one vector): raw launches of
    # the C entries with preallocated outputs, back to back in a CUDA
    # graph (graph_ms), beside the wrapper's time (cuda_ms over calls)
    def raw(module, lib_fn, entry, *args):
        fn = getattr(getattr(importlib.import_module(
            f"repro_torch.kernels.{module}"), lib_fn)(), entry)

        def launch():
            _build.check(fn(*args, torch.cuda.current_stream().cuda_stream),
                         entry)
        return launch

    h_o, r_o = (torch.empty(qn, device=dev) for _ in range(2))
    cs_o, jl_o = (torch.empty(JOIN_M, device=dev) for _ in range(2))
    # B4 at the join path's shape: the served index's two rows (fa, fa
    # scaled) queried by fb; a raw launch takes 16-byte loads only on
    # aligned arrays, as the wrapper decides
    jc2 = tk.BucketizedSketch(*(x[:2] for x in jc))
    b4_full["join"] = 2 * JOIN_BUCKETS * SLOTS * 8 + 2 * 8 + \
        JOIN_BUCKETS * SLOTS * 8 + 4
    b4_need["join"] = b4_needed_bytes(jq.idx, jc2.idx)
    ie_o = torch.empty(C, device=dev)
    ie_cases = {"served": (q, corpus), "join": (jq, jc2)}

    def ie_raw(case):
        qq, cc = ie_cases[case]
        ptrs = (qq.idx.data_ptr(), qq.val.data_ptr(), cc.idx.data_ptr(),
                cc.val.data_ptr())
        vec = int(cc.idx.shape[2] == 4 and not any(p % 16 for p in ptrs))
        return raw("intersect_estimate.intersect_estimate", "_lib",
                   "repro_intersect_estimate", ptrs[0], ptrs[1],
                   qq.tau.data_ptr(), ptrs[2], ptrs[3], cc.tau.data_ptr(),
                   ie_o.data_ptr(), *cc.idx.shape, vec)

    ie_join_ms = cuda_ms(lambda: tk.intersect_estimate(
        jq.idx, jq.val, jq.tau, jc2.idx, jc2.val, jc2.tau))
    # B1 and B3 on one vector, the spread route as the wrappers take it: at
    # the join path's (1, 30000) (B1 for the PS sketches, l2 and uniform;
    # B3 for the TS sketches), the quickstart's n = 100000 (B3), and
    # n = 256, one block of one coordinate a thread: the floor a one-block
    # launch sets on this card
    b1_v = fa0_t[None].contiguous()
    b1_h, b1_r = torch.empty(JOIN_KEYS, device=dev), torch.empty(
        (1, JOIN_KEYS), device=dev)
    b1_hist = torch.empty((1, 256), dtype=torch.int32, device=dev)
    floor_v = qa[:256].contiguous()
    round_v = qa[None, :16384].contiguous()

    def b1_raw(v, variant):
        n1 = int(v.shape[1])
        return raw("sketch_build.sketch_build", "_lib", "repro_hash_rank_hist",
                   v.data_ptr(), b1_h.data_ptr(), b1_r.data_ptr(),
                   b1_hist.data_ptr(), 1, n1, 42, variant,
                   int(spread_route(dev, 1, n1, hist=True)))

    def b3_raw(v):
        n1 = int(v.shape[0])
        return raw("hash_rank.hash_rank", "_lib", "repro_hash_rank",
                   v.data_ptr(), h_o.data_ptr(), r_o.data_ptr(), n1, 42, 0,
                   int(spread_route(dev, 1, n1)))

    def one_vector_bound_ms(n1: int, hist: bool) -> float:
        """The vector read once, h and the ranks written once, and the
        histogram when there is one, over the memory rate."""
        return (3 * n1 + (256 if hist else 0)) * 4 / HBM_BYTES_PER_S * 1e3
    jl_seeds32 = jl_seeds.to(torch.int32).contiguous()
    # B9 at the parity shape (a 65536-wide row, m = 256)
    jl_main_v = b9_cases[1][1]
    jl_main_seeds = jl_row_seeds(SEED, torch.arange(M, device=dev)).to(
        torch.int32).contiguous()
    jl_main_o = torch.empty(M, device=dev)
    sel_o = torch.empty(1, device=dev)
    qs_keys = tk.hash_rank(qa, 42)[1][None].contiguous()
    _, fig_keys, fig_h0 = tk.hash_rank_hist(fa0_t[None].contiguous(), 42,
                                            variant="uniform")
    fig_k = samples_for_budget(JOIN_M) + 1
    # the store add's shape, the most launched selection: (1, 65536)
    # row-weight ranks, no level-0 histogram
    store_keys = sampling_ranks(
        payload_weight(matrix_pair(0, dev)[0][None], "l2"),
        hash_unit(SEED, torch.arange(MAT_N, dtype=torch.int32,
                                     device=dev))[None]).contiguous()
    small = {
        f"hash_rank n={qn}": (b3_raw(qa), t["hash_rank"][0]),
        f"hash_rank n={JOIN_KEYS} (join)": (
            b3_raw(fa0_t), cuda_ms(lambda: tk.hash_rank(fa0_t, 42))),
        "hash_rank n=256 (one block)": (
            b3_raw(floor_v), cuda_ms(lambda: tk.hash_rank(floor_v, 42))),
        f"countsketch_scatter n={JOIN_KEYS} m={JOIN_M}": (
            raw("countsketch.countsketch", "_lib", "repro_countsketch",
                fa0_t.data_ptr(), JOIN_KEYS, JOIN_M, sb & 0xFFFFFFFF,
                ss & 0xFFFFFFFF, cs_o.data_ptr(), None),
            t["countsketch_scatter"][0]),
        f"intersect_estimate C={C} B={B} S={S}": (
            ie_raw("served"), t["intersect_estimate"][0]),
        f"intersect_estimate C=2 B={JOIN_BUCKETS} S={SLOTS} (join)": (
            ie_raw("join"), ie_join_ms),
        f"hash_rank_hist D=1 n={JOIN_KEYS} uniform (join)": (
            b1_raw(b1_v, 2),
            cuda_ms(lambda: tk.hash_rank_hist(b1_v, 42, variant="uniform"))),
        f"hash_rank_hist D=1 n={JOIN_KEYS} l2 (join)": (
            b1_raw(b1_v, 0), cuda_ms(lambda: tk.hash_rank_hist(b1_v, 42))),
        "hash_rank_hist D=1 n=256 l2 (one block)": (
            b1_raw(floor_v[None], 0),
            cuda_ms(lambda: tk.hash_rank_hist(floor_v[None], 42))),
        # a coordinate a thread of a whole 16-block cluster: the floor of
        # the cluster launch, its barrier and its exchange
        "hash_rank_hist D=1 n=16384 l2 (one cluster round)": (
            b1_raw(round_v, 0),
            cuda_ms(lambda: tk.hash_rank_hist(round_v, 42))),
        f"jl_rademacher n={JOIN_KEYS} m={JOIN_M}": (
            raw("jl_rademacher.jl_rademacher", "_lib", "repro_jl_rademacher",
                fa0_t.data_ptr(), jl_seeds32.data_ptr(), JOIN_KEYS, JOIN_M,
                jl_o.data_ptr()),
            t["jl_rademacher"][0]),
        f"jl_rademacher n={N} m={M} (parity)": (
            raw("jl_rademacher.jl_rademacher", "_lib", "repro_jl_rademacher",
                jl_main_v.data_ptr(), jl_main_seeds.data_ptr(), N, M,
                jl_main_o.data_ptr()),
            b9_shapes[f"main n={N} m={M}"][0]),
        f"radix_select D=1 n={qn} k={M + 1}": (
            raw("sketch_build.sketch_build", "_select_lib",
                "repro_radix_select", qs_keys.data_ptr(), None, None, M + 1,
                sel_o.data_ptr(), 1, qn),
            cuda_ms(lambda: tk.radix_select(qs_keys, M + 1))),
        f"radix_select D=1 n={MAT_N} k={MAT_M + 1} (store add)": (
            raw("sketch_build.sketch_build", "_select_lib",
                "repro_radix_select", store_keys.data_ptr(), None, None,
                MAT_M + 1, sel_o.data_ptr(), 1, MAT_N),
            cuda_ms(lambda: tk.radix_select(store_keys, MAT_M + 1))),
        f"radix_select D=1 n={JOIN_KEYS} k={fig_k} hist0": (
            raw("sketch_build.sketch_build", "_select_lib",
                "repro_radix_select", fig_keys.data_ptr(), fig_h0.data_ptr(),
                None, fig_k, sel_o.data_ptr(), 1, JOIN_KEYS),
            cuda_ms(lambda: tk.radix_select(fig_keys, fig_k, hist0=fig_h0))),
    }
    device_only = {what: {"device_ms": graph_ms(launch), "wrapper_ms": wrapper}
                   for what, (launch, wrapper) in small.items()}
    for what, (n9, m9) in ((f"jl_rademacher n={JOIN_KEYS} m={JOIN_M}",
                            (JOIN_KEYS, JOIN_M)),
                           (f"jl_rademacher n={N} m={M} (parity)", (N, M))):
        device_only[what]["bound_ms"] = jl_bound_ms(n9, m9)
    jl_sass = sass_loop(_build.lib_path("jl_rademacher"), _build.nvcc_path())
    # torch.kthvalue at B2's one-vector shapes, device-only as B2's own
    # times are (calls captured in a CUDA graph), beside B2's
    kth_d1 = {}
    for what, keys, k in (
            (f"radix_select D=1 n={MAT_N} k={MAT_M + 1} (store add)",
             store_keys, MAT_M + 1),
            (f"radix_select D=1 n={qn} k={M + 1}", qs_keys, M + 1),
            (f"radix_select D=1 n={JOIN_KEYS} k={fig_k} hist0", fig_keys,
             fig_k)):
        lib_ms = graph_ms(lambda keys=keys, k=k: torch.kthvalue(keys, k,
                                                                 dim=1))
        kth_d1[what] = {"kthvalue_ms": lib_ms,
                        "radix_select_device_ms":
                            device_only[what]["device_ms"],
                        "radix_select_over_kthvalue":
                            device_only[what]["device_ms"] / lib_ms}
    # B4 against both bounds at both shapes, device-only and through the
    # wrapper: each bound's time over the kernel's (a share)
    b4_keys = {"served": f"intersect_estimate C={C} B={B} S={S}",
               "join": f"intersect_estimate C=2 B={JOIN_BUCKETS} S={SLOTS} "
                       "(join)"}
    b4_bounds = {}
    for case, key in b4_keys.items():
        full_ms = b4_full[case] / HBM_BYTES_PER_S * 1e3
        need_ms = b4_need[case] / HBM_BYTES_PER_S * 1e3
        dev_ms, wrap_ms = (device_only[key][k]
                           for k in ("device_ms", "wrapper_ms"))
        b4_bounds[case] = {
            "full_stream_bytes": b4_full[case], "full_stream_ms": full_ms,
            "needed_bytes": b4_need[case], "needed_ms": need_ms,
            "device_ms": dev_ms, "wrapper_ms": wrap_ms,
            "device_share_of_full_stream": full_ms / dev_ms,
            "device_share_of_needed": need_ms / dev_ms,
            "wrapper_share_of_full_stream": full_ms / wrap_ms,
            "wrapper_share_of_needed": need_ms / wrap_ms}
    # B1's route boundary for one row (hash_rank.HIST_SPREAD_MAX_N = 2^17):
    # both routes device-only on each side of it, the batched one with the
    # fill of its histogram that the wrapper launches first
    b1_routes = {}
    for n1 in (1 << 17, 1 << 18):
        v1 = rand_block(1, n1)
        h1, r1 = torch.empty(n1, device=dev), torch.empty((1, n1), device=dev)
        hist1 = torch.zeros((1, 256), dtype=torch.int32, device=dev)
        b1_routes[n1] = {"takes_spread_route": spread_route(dev, 1, n1,
                                                            hist=True)}
        for spread in (1, 0):
            b1_routes[n1]["spread_ms" if spread else "batched_ms"] = graph_ms(
                raw("sketch_build.sketch_build", "_lib",
                    "repro_hash_rank_hist", v1.data_ptr(), h1.data_ptr(),
                    r1.data_ptr(), hist1.data_ptr(), 1, n1, 42, 0, spread))
        b1_routes[n1]["batched_fill_ms"] = graph_ms(hist1.zero_)
        del v1, h1, r1, hist1
    # each one-vector time beside its bound and the one-block floor
    for what, rec in device_only.items():
        if what.startswith(("hash_rank n=", "hash_rank_hist D=1")):
            n1 = int(what.split("n=")[1].split()[0])
            rec["bound_ms"] = one_vector_bound_ms(
                n1, what.startswith("hash_rank_hist"))
            rec["one_block_floor_ms"] = device_only[
                "hash_rank_hist D=1 n=256 l2 (one block)"
                if what.startswith("hash_rank_hist")
                else "hash_rank n=256 (one block)"]["device_ms"]
    b1_join = device_only[f"hash_rank_hist D=1 n={JOIN_KEYS} uniform (join)"]
    bounds = {}
    for kname, (ms, plain, lib, nbytes, _) in t.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (join_ops / FP32_OPS_PER_S * 1e3
                  if kname == "allpairs_estimate" else
                  jl_bound_ms(JOIN_KEYS, JOIN_M)
                  if kname == "jl_rademacher" else 0.0)
        bounds[kname] = (max(bytes_ms, ops_ms),
                         "operations" if ops_ms > bytes_ms else "bytes")
    # where one add_many block, one query and one merge_from spend their
    # time: each step of the calls, in order, host clock with the device
    # synchronised around each step (step_ms)
    add_steps, query_steps, merge_steps = {}, {}, {}
    rows = list(range(BLOCK_ROWS))
    mat = dense_rows(vidx, vval, rows)
    scratch = SketchIndex(M, n_buckets=N_BUCKETS, slots=SLOTS, seed=SEED,
                          initial_capacity=BLOCK_ROWS, device=dev)
    mat, add_steps["check_finite"] = step_ms(lambda: check_finite(mat, "m"))
    At, add_steps["host_to_device"] = step_ms(
        lambda: torch.as_tensor(mat).to(dev))
    sk, add_steps["build"] = step_ms(
        lambda: tk.build_priority_corpus(At, M, SEED, device=dev))
    bc, add_steps["bucketize"] = step_ms(
        lambda: tk.bucketize_corpus(sk, n_buckets=N_BUCKETS, slots=SLOTS))
    host, add_steps["device_to_host"] = step_ms(
        lambda: [x.cpu().numpy() for x in bc])
    scratch._idx[:BLOCK_ROWS], scratch._val[:BLOCK_ROWS] = host[0], host[1]
    scratch._tau[:BLOCK_ROWS] = host[2]

    def heads():
        for k in rows:
            nz = np.flatnonzero(mat[k])
            scratch._set_head_row(k, nz, mat[k, nz])

    _, add_steps["head_rows"] = step_ms(heads)
    _, add_steps["row_summaries"] = step_ms(
        lambda: scratch._refresh_row_stats(0, BLOCK_ROWS))
    qv_host = np.zeros(N, np.float32)
    qv_host[vidx[sources[1]]] = vval[sources[1]]
    qv_host, query_steps["check_vector"] = step_ms(
        lambda: check_vector(qv_host, "q", dim=N))
    qt, query_steps["host_to_device"] = step_ms(
        lambda: torch.as_tensor(qv_host, device=dev))
    sq, query_steps["sketch"] = step_ms(lambda: priority_sketch(qt, M, SEED))
    qb, query_steps["bucketize"] = step_ms(
        lambda: tk.bucketize(sq, n_buckets=N_BUCKETS, slots=SLOTS))
    est, query_steps["kernel"] = step_ms(lambda: tk.query_corpus(qb, corpus))
    _, query_steps["device_to_host_top_k"] = step_ms(
        lambda: np.argsort(est.cpu().numpy()[:D])[-5:])
    # merge_from's steps, replayed on the merge path's pre-merge state
    both, merge_steps["host_to_device"] = step_ms(lambda: (
        host_corpus([pre[k] for k in ("_idx", "_val", "_tau", "_dropped")]),
        host_corpus([a[:D] for a in (hi_ix._idx, hi_ix._val, hi_ix._tau,
                                     hi_ix._dropped)])))
    tau_m, merge_steps["merged_tau"] = step_ms(
        lambda: tk.merged_tau_bucketized(*both, SEED, m=M))
    merged, merge_steps["merge_kernel"] = step_ms(
        lambda: tk.merge_bucketized_corpora(*both, SEED, m=M, tau=tau_m))
    host, merge_steps["device_to_host"] = step_ms(
        lambda: [x.cpu().numpy() for x in merged])
    heads_ix = SketchIndex(M, n_buckets=N_BUCKETS, slots=SLOTS, seed=SEED,
                           initial_capacity=D, device=dev)
    heads_ix._idx[:D], heads_ix._val[:D], heads_ix._tau[:D] = host[:3]
    heads_ix._head_idx[:D] = pre["_head_idx"]
    heads_ix._head_val[:D] = pre["_head_val"]

    def merged_heads():
        for d in range(D):
            hm, ho = heads_ix._head_idx[d], hi_ix._head_idx[d]
            heads_ix._set_head_row(
                d, np.concatenate([hm[hm >= 0], ho[ho >= 0]]),
                np.concatenate([heads_ix._head_val[d][hm >= 0],
                                hi_ix._head_val[d][ho >= 0]]))

    _, merge_steps["head_rows"] = step_ms(merged_heads)
    _, merge_steps["row_summaries"] = step_ms(
        lambda: heads_ix._refresh_row_stats(0, D))

    # the store: B7 at its query shape (one query side read in place
    # against the 1024-sketch library), against its plain version; its
    # bound counts what this query's data needs: the query side and the
    # library's ids once, the probabilities and rows of the matched
    # library slots, the output once
    store_steps = {}
    Qh = matrix_pair(int(q_src[0]), dev)[1].cpu().numpy()
    Qh, store_steps["check_finite"] = step_ms(
        lambda: check_finite(Qh, "matrix"))
    Qt, store_steps["host_to_device"] = step_ms(
        lambda: torch.as_tensor(Qh, device=dev))
    sq, store_steps["sketch"] = step_ms(
        lambda: priority_matrix_sketch(Qt, MAT_M, SEED))
    qb, store_steps["bucketize"] = step_ms(
        lambda: tk.bucketize_matrix_sketches(sq, n_buckets=lib_buckets,
                                             slots=lib_slots))
    qp, store_steps["probabilities"] = step_ms(
        lambda: tk.matrix_slot_probs(qb))
    b7_args = (qb.idx, qb.rows, qp, lib_bc.idx, lib_bc.rows, lib_p)
    est, store_steps["kernel"] = step_ms(
        lambda: tk.matrix_products(*b7_args))
    _, store_steps["device_to_host"] = step_ms(lambda: est.cpu().numpy())
    store._invalidate()
    _, store_steps["library_relayout_once_per_change"] = step_ms(
        store._buckets)
    # the query's sketch, step by step (the d > 1 priority build)
    sketch_steps = {}
    Pq = Qt[None]
    W, sketch_steps["row_weight"] = step_ms(lambda: payload_weight(Pq, "l2"))
    hq, sketch_steps["hash"] = step_ms(lambda: hash_unit(
        SEED, torch.arange(MAT_N, dtype=torch.int32, device=dev)))
    rq, sketch_steps["ranks"] = step_ms(lambda: sampling_ranks(W, hq[None]))
    tq, sketch_steps["selection"] = step_ms(
        lambda: tk.kth_smallest_ranks(rq, MAT_M + 1))
    _, sketch_steps["pack"] = step_ms(
        lambda: pack_payloads(rq < tq[:, None], Pq, MAT_M))
    err["matrix_products"] = max(err["matrix_products"], assert_close(
        tk.matrix_products(*b7_args), matrix_products_ref(*b7_args),
        f"matrix_products store query vs C={lib_bc.idx.shape[0]}"))
    n_lib, n_slots = lib_bc.idx.shape[0], lib_buckets * lib_slots
    b7_matches = int(((qb.idx[0][None, :, :, None]
                       == lib_bc.idx[:, :, None, :])
                      & (qb.idx[0] != INVALID_IDX)[None, :, :, None]).sum())
    b7_out = n_lib * MAT_D * MAT_D * 4
    b7_bytes = (n_slots * (8 + 4 * MAT_D) + n_lib * n_slots * 4
                + b7_matches * (4 + 4 * MAT_D) + b7_out)
    b7_full_bytes = (n_slots + n_lib * n_slots) * (8 + 4 * MAT_D) + b7_out
    t["matrix_products"] = (
        cuda_ms(lambda: tk.matrix_products(*b7_args), iters=WRAPPER_ITERS),
        cuda_ms(lambda: matrix_products_ref(*b7_args), iters=3),
        None, b7_bytes, "bytes")
    # B7 device-only: raw launches at the store query's shape, the query
    # side broadcast (batch stride 0) against the library's pairs
    b7_o = torch.empty((n_lib, MAT_D, MAT_D), device=dev)
    b7_launch = raw("matrix_sketch.matrix_sketch", "_lib",
                    "repro_matrix_products", qb.idx.data_ptr(),
                    qb.rows.data_ptr(), qp.data_ptr(), lib_bc.idx.data_ptr(),
                    lib_bc.rows.data_ptr(), lib_p.data_ptr(), b7_o.data_ptr(),
                    n_lib, 0, lib_buckets, lib_slots, MAT_D, MAT_D)
    b7_launch()
    torch.cuda.synchronize()
    assert_bits(b7_o, tk.matrix_products(*b7_args),
                "matrix_products raw launch vs the wrapper")
    b7_device = {"shape": [n_lib, lib_buckets, lib_slots, MAT_D],
                 "device_ms": graph_ms(b7_launch),
                 "wrapper_ms": t["matrix_products"][0]}
    device_only[f"matrix_products P={n_lib} B={lib_buckets} S={lib_slots} "
                f"d={MAT_D} (store query)"] = b7_device
    # B7 at the products call's shape: 256 pairs of stored matrices, both
    # sides batched; its bound: both sides' ids, the matched slots'
    # probabilities and rows on both sides, the output
    b7p_args = tuple(x[torch.as_tensor(ix, device=dev)].contiguous()
                     for ix in (pair_ix[:, 0], pair_ix[:, 1])
                     for x in (lib_bc.idx, lib_bc.rows, lib_p))
    err["matrix_products"] = max(err["matrix_products"], assert_close(
        tk.matrix_products(*b7p_args), matrix_products_ref(*b7p_args),
        f"matrix_products products call P={MAT_PAIRS}"))
    b7p_o = torch.empty((MAT_PAIRS, MAT_D, MAT_D), device=dev)
    b7p_launch = raw("matrix_sketch.matrix_sketch", "_lib",
                     "repro_matrix_products",
                     *(x.data_ptr() for x in b7p_args), b7p_o.data_ptr(),
                     MAT_PAIRS, 1, lib_buckets, lib_slots, MAT_D, MAT_D)
    b7p_launch()
    torch.cuda.synchronize()
    assert_bits(b7p_o, tk.matrix_products(*b7p_args),
                "matrix_products products call: raw launch vs the wrapper")
    b7p_matches = int(((b7p_args[0][:, :, :, None]
                        == b7p_args[3][:, :, None, :])
                       & (b7p_args[0] != INVALID_IDX)[..., None]).sum())
    b7p_bytes = (2 * MAT_PAIRS * n_slots * 4
                 + b7p_matches * 2 * (4 + 4 * MAT_D)
                 + MAT_PAIRS * MAT_D * MAT_D * 4)
    device_only[f"matrix_products P={MAT_PAIRS} B={lib_buckets} "
                f"S={lib_slots} d={MAT_D} batched (products call)"] = {
        "device_ms": graph_ms(b7p_launch),
        "wrapper_ms": cuda_ms(lambda: tk.matrix_products(*b7p_args),
                              iters=WRAPPER_ITERS),
        "bound_ms": b7p_bytes / HBM_BYTES_PER_S * 1e3,
        "matches": b7p_matches}
    b7_device["bound_ms"] = b7_bytes / HBM_BYTES_PER_S * 1e3
    bytes_ms = b7_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * b7_matches * MAT_D * MAT_D / FP32_OPS_PER_S * 1e3
    bounds["matrix_products"] = (max(bytes_ms, ops_ms),
                                 "operations" if ops_ms > bytes_ms
                                 else "bytes")

    # the join-correlation path: the combined builds on one discovery
    # block (the kernel route, the same on the kernels' plain versions,
    # the legacy argsorts, the threshold build); their bound: the block
    # read once, the sketches written once
    A0 = jcp["disc"]["block0"]
    combined_build = {
        "block": [BLOCK_ROWS, DISC_UNIVERSE], "m": DISC_M,
        "priority_kernel_ms": cuda_ms(
            lambda: tk.build_combined_priority_corpus(
                A0, DISC_M, DISC_SEED, device=dev), warmup=1, iters=5),
        "priority_plain_ms": cuda_ms(
            lambda: tk.build_combined_priority_corpus(
                A0, DISC_M, DISC_SEED, device=dev, use_kernel=False),
            warmup=1, iters=3),
        "priority_legacy_ms": cuda_ms(
            lambda: combined_sketch_corpus(A0, DISC_M, DISC_SEED,
                                           backend="reference", device=dev),
            warmup=1, iters=1),
        "threshold_kernel_ms": cuda_ms(
            lambda: tk.build_combined_threshold_corpus(
                A0, DISC_M, DISC_SEED, device=dev), warmup=1, iters=3),
        "priority_bound_ms": (A0.numel() * 4 + BLOCK_ROWS * (DISC_M * 8 + 16))
        / HBM_BYTES_PER_S * 1e3}
    # correlation_matrix at D = 4096 step by step: bucketize with the
    # inclusion probabilities, B5's compaction, the moments join (a raw
    # launch, held against the wrapper's matrix), the Eq. 9 formula
    S_all = jcp["disc"]["S"]
    corr_steps = {}
    mi, corr_steps["bucketize_and_probabilities"] = step_ms(
        lambda: _bucketized_moment_inputs(S_all, DISC_BUCKETS,
                                          DISC_SLOTS)[:3])
    cm, corr_steps["compaction"] = step_ms(lambda: tk.allpairs_compact(*mi))
    mom_o = torch.empty((DISC_D, DISC_D, len(MOMENT_CHANNELS)), device=dev)
    mom_join = raw("intersect_estimate.intersect_estimate", "_lib",
                   "repro_allpairs_join", cm[0].data_ptr(), cm[1].data_ptr(),
                   cm[0].data_ptr(), cm[1].data_ptr(), mom_o.data_ptr(),
                   DISC_D, DISC_D, DISC_BUCKETS, DISC_SLOTS, 1)
    _, corr_steps["moments_join"] = step_ms(mom_join)
    assert_bits(mom_o, tk.allpairs_moments(*mi, *mi),
                "moments join raw launch vs the wrapper")
    moments = {k: mom_o[..., c] for c, k in enumerate(MOMENT_CHANNELS)}
    _, corr_steps["correlation_formula"] = step_ms(
        lambda: correlation_from_estimates(moments))
    _, corr_total_ms = step_ms(lambda: correlation_matrix(
        S_all, backend="kernel", n_buckets=DISC_BUCKETS, slots=DISC_SLOTS))
    # B5's moments mode device-only (raw launches in a CUDA graph) against
    # its bound: the corpus read once, the (D, D, 6) output written once;
    # or the compares its buckets need
    cm_o = (torch.empty_like(cm[0]), torch.empty_like(cm[1]))
    mom_compact = raw("intersect_estimate.intersect_estimate", "_lib",
                      "repro_allpairs_compact", mi[0].data_ptr(),
                      mi[1].data_ptr(), mi[2].data_ptr(), None,
                      cm_o[0].data_ptr(), cm_o[1].data_ptr(),
                      cm_o[1].shape[0], DISC_D, DISC_BUCKETS, DISC_SLOTS)
    def moments_bound(a_idx, b_idx, out_numel):
        """The moments join's bound: both corpora read once and the
        output written once, or the compares its buckets need."""
        per_a = (a_idx != INVALID_IDX).sum(dim=(0, 2)).double()
        per_b = (b_idx != INVALID_IDX).sum(dim=(0, 2)).double()
        nbytes = (a_idx.numel() + (0 if b_idx is a_idx else b_idx.numel())
                  ) * 12 + out_numel * 4
        compares = float((per_a * per_b).sum())
        ms = max(nbytes / HBM_BYTES_PER_S, compares / FP32_OPS_PER_S) * 1e3
        return {"bytes": nbytes, "compares": compares, "bound_ms": ms,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                >= compares / FP32_OPS_PER_S else "operations"}

    b5_moments = {
        "shape": [DISC_D, DISC_D, DISC_BUCKETS, DISC_SLOTS],
        "launch_shape": moments_join_shape(DISC_SLOTS),
        "compaction_device_ms": graph_ms(mom_compact, reps=10),
        "join_device_ms": graph_ms(mom_join, reps=5, replays=3),
        "wrapper_ms": cuda_ms(lambda: tk.allpairs_moments(*mi, *mi),
                              warmup=1, iters=3),
        "plain_ms": "not measured (the plain join at this shape holds "
                    "(64, 4096, 1024) intermediates per chunk pair)",
        **moments_bound(mi[0], mi[0], mom_o.numel())}
    b5_moments["device_ms"] = (b5_moments["compaction_device_ms"]
                               + b5_moments["join_device_ms"])
    # the 64-row query launch (64 x 4096, every tile joined: no mirror)
    # apart from the square one: the query rows compacted on their own
    mq = tuple(x[:64].contiguous() for x in mi)
    cq = tk.allpairs_compact(*mq)
    mq_o = torch.empty((64, DISC_D, len(MOMENT_CHANNELS)), device=dev)
    mq_join = raw("intersect_estimate.intersect_estimate", "_lib",
                  "repro_allpairs_join", cq[0].data_ptr(), cq[1].data_ptr(),
                  cm[0].data_ptr(), cm[1].data_ptr(), mq_o.data_ptr(), 64,
                  DISC_D, DISC_BUCKETS, DISC_SLOTS, 1)
    mq_join()
    assert_bits(mq_o, mom_o[:64], "moments query launch vs the square's rows")
    b5_moments["query_64_rows"] = {
        "shape": [64, DISC_D, DISC_BUCKETS, DISC_SLOTS],
        "join_device_ms": graph_ms(mq_join, reps=10),
        "wrapper_ms": cuda_ms(lambda: tk.allpairs_moments(*mq, *mi),
                              warmup=1, iters=5),
        **moments_bound(mq[0], mi[0], mq_o.numel())}
    del mom_o, moments, cm, cm_o, mi, mq, cq, mq_o
    # discovery: B5's tile launch at each corpus's shape (its first two
    # scan tiles) through estimate_tile_rows, as the scan takes it (with
    # the copy to the host), and device-only (the two compactions and the
    # join, raw; the join alone); each scan's wall time (p50 of
    # TOPK_REPS, summaries current) and the share of it the tiles' device
    # time explains; top_k_for_query and query p50 over TOPK_QUERIES
    # queries; all_pairs plus the sort at D = 8192 for contrast

    def tile_launch(ix, eng):
        c = ix._corpus()
        p = tk.slot_inclusion_probs(c)
        ru, rv = eng.tile_members(0), eng.tile_members(1)
        args = (c.idx, c.val, p, c.idx, c.val, p, ru, rv)
        sides = [[x.index_select(0, torch.as_tensor(r, device=dev))
                  for x in (c.idx, c.val, p)] for r in (ru, rv)]
        outs = [[torch.empty_like(y) for y in tk.allpairs_compact(*side)]
                for side in sides]
        tile_o = torch.empty((len(ru), len(rv)), device=dev)
        _, Bt, St = c.idx.shape
        steps = [raw("intersect_estimate.intersect_estimate", "_lib",
                     "repro_allpairs_compact",
                     *(x.data_ptr() for x in side), None, o[0].data_ptr(),
                     o[1].data_ptr(), o[1].shape[0], side[0].shape[0], Bt,
                     St)
                 for side, o in zip(sides, outs)]
        steps.append(raw("intersect_estimate.intersect_estimate", "_lib",
                         "repro_allpairs_join", outs[0][0].data_ptr(),
                         outs[0][1].data_ptr(), outs[1][0].data_ptr(),
                         outs[1][1].data_ptr(), tile_o.data_ptr(), len(ru),
                         len(rv), Bt, St, 0))

        def launch():
            for step in steps:
                step()

        launch()
        torch.cuda.synchronize()
        got = tk.estimate_tile_rows(*args)
        assert_bits(tile_o, got, "tile: raw launches vs the wrapper")
        shape = [len(ru), len(rv), Bt, St]
        tile_err = assert_close(
            got, tk.estimate_tile_rows(*args, use_kernel=False),
            f"tile {shape}: the wrapper vs its plain route")
        err["allpairs_estimate"] = max(err["allpairs_estimate"], tile_err)
        return {"shape": shape, "max_abs_err_vs_plain": tile_err,
                "wrapper_ms": cuda_ms(lambda: tk.estimate_tile_rows(*args)),
                "with_host_copy_ms": float(np.median([step_ms(
                    lambda: tk.estimate_tile_rows(*args).cpu().numpy())[1]
                    for _ in range(50)])),
                "device_ms": graph_ms(launch),
                "join_device_ms": graph_ms(steps[-1]),
                "plain_ms": cuda_ms(lambda: tk.estimate_tile_rows(
                    *args, use_kernel=False), iters=5),
                **moments_bound(sides[0][0], sides[1][0], tile_o.numel())}

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def batch_bound(lay, pairs):
        """The tile-list join's bound on these pairs: its inputs read once
        (the occupied entries of the distinct compacted tiles, 16 B each,
        their counts and the pair list), the (N, 64, 64) tiles written
        once; or the compares their buckets need."""
        Bt = lay.entries.shape[1]
        tiles = torch.as_tensor(np.unique(pairs), device=dev).long()
        nbytes = (int(lay.counts[tiles].sum()) * 16 + tiles.numel() * Bt * 4
                  + len(pairs) * (2 * 4 + 64 * 64 * 4))
        cnt = lay.counts.double()
        pt = torch.as_tensor(pairs, device=dev).long()
        compares = float((cnt[pt[:, 0]] * cnt[pt[:, 1]]).sum())
        ms = max(nbytes / HBM_BYTES_PER_S, compares / FP32_OPS_PER_S) * 1e3
        return {"bytes": nbytes, "compares": compares, "bound_ms": ms,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                >= compares / FP32_OPS_PER_S else "operations"}

    def batch_launch(eng):
        """The tile-list join at this corpus's scan layout: the first N
        tile pairs of the scan order (the skewed corpus's heaviest first)
        in one raw launch at the default groups, device-only (a CUDA
        graph), per launch and per tile, beside the bound, at N = 1, 8,
        132 and 528; the wall time of the batch through
        ``scan_tile_batch`` (pair list up, launch, pinned copy back, host
        tiles; p50 of 20); the first pair (the heaviest tile) at each
        groups setting; the plain version at N = 132."""
        lay = eng._prepare()
        Tc, Bt, cap, _ = lay.entries.shape
        uu, vv = scan_order(eng)
        rec = {"shape": [64, 64, Bt, cap // 64], "sms": sms}

        def launch_of(pairs, groups):
            pt = torch.as_tensor(pairs.astype(np.int32), device=dev)
            o = torch.empty((len(pairs), 64, 64), device=dev)
            f = raw("intersect_estimate.intersect_estimate", "_lib",
                    "repro_allpairs_join_tiles", lay.entries.data_ptr(),
                    lay.counts.data_ptr(), lay.entries.data_ptr(),
                    lay.counts.data_ptr(), pt.data_ptr(), o.data_ptr(),
                    len(pairs), Tc, Tc, Bt, cap // 64, groups)
            f.keep = (pt, o)
            return f

        for n in (1, 8, 132, 528):
            pairs = np.stack([uu[:n], vv[:n]], 1)
            g = auto_groups(n, sms)
            ms = graph_ms(launch_of(pairs, g), reps=max(2, min(50, 400 // n)))
            rec[f"n{n}"] = {
                "groups": g, "device_ms": ms, "device_ms_per_tile": ms / n,
                "batch_wall_ms": p50_ms(
                    [lambda p=pairs: tk.scan_tile_batch(lay, lay, p)] * 20),
                **batch_bound(lay, pairs)}
        heavy = np.stack([uu[:1], vv[:1]], 1)
        rec["heavy_tile"] = {
            "pair": heavy[0].tolist(), **batch_bound(lay, heavy),
            "device_ms_by_groups": {g: graph_ms(launch_of(heavy, g))
                                    for g in (1, 2, 4, 8, 16)}}
        p132 = torch.as_tensor(np.stack([uu[:132], vv[:132]], 1).astype(
            np.int32), device=dev)
        side = (lay.entries, lay.counts)
        rec["n132"]["plain_ms"] = cuda_ms(
            lambda: allpairs_join_tiles_ref(*side, *side, p132), warmup=1,
            iters=3)
        rec["n132"]["wrapper_ms"] = cuda_ms(
            lambda: tk.allpairs_join_tiles(*side, *side, p132))
        rec["layout_bytes"] = lay.nbytes
        return rec

    def p50_ms(calls) -> float:
        return float(np.median([step_ms(f)[1] for f in calls]))

    disc_t = {}
    for what, eng, ix, scans, qs in (
            ("skewed", dp["eng"], dp["index"], dp["scans"], dp["queries"]),
            ("flat", dp["feng"], index, dp["fscans"],
             [planted(qi, sources[qi]) for qi in range(TOPK_QUERIES)])):
        tl = tile_launch(ix, eng)
        rec = {"tile_launch": tl, "batch_launch": batch_launch(eng)}
        for mode, absolute in (("plain", False), ("absolute", True)):
            ms = p50_ms([lambda: eng.top_pairs(TOPK_K, absolute=absolute)]
                        * TOPK_REPS)
            n_t = scans[mode].stats.tiles_launched
            rec[mode] = {"scan_p50_ms": ms, "tiles_launched": n_t,
                         "ms_per_tile": ms / n_t}
        rec["top_k_for_query_p50_ms"] = p50_ms(
            [lambda q=q: eng.top_k_for_query(q, TOPK_K) for q in qs])
        rec["query_p50_ms"] = p50_ms(
            [lambda q=q: ix.query(q, top_k=TOPK_K) for q in qs])
        disc_t[what] = rec
    cheb_eng = DiscoveryEngine(dp["index"], tile=TOPK_TILE,
                               ceiling="chebyshev")
    cheb_eng.top_pairs(TOPK_K)
    disc_t["skewed"]["chebyshev"] = {
        "scan_p50_ms": p50_ms([lambda: cheb_eng.top_pairs(TOPK_K)]
                              * TOPK_REPS),
        "tiles_launched": dp["cheb"].stats.tiles_launched}
    est_t, ap_t_ms = step_ms(dp["index"].all_pairs)
    _, sort_t_ms = step_ms(lambda: true_top_pairs(
        est_t, dp["index"]._names, TOPK_K))
    disc_t["skewed"]["all_pairs_ms"] = ap_t_ms
    disc_t["skewed"]["all_pairs_sort_ms"] = sort_t_ms
    # where a scan's time goes: one scan of each corpus under
    # torch.profiler (the device's kernels against the wall time)
    for what, eng in (("skewed", dp["eng"]), ("flat", dp["feng"])):
        disc_t[what]["trace"] = trace_scan(lambda: eng.top_pairs(TOPK_K))
    # the tile-list join's row of the kernel table: the flat corpus's
    # batch of 132 tile pairs (one block an SM at one group)
    bl = disc_t["flat"]["batch_launch"]["n132"]
    t["allpairs_join_tiles"] = (bl["wrapper_ms"], bl["plain_ms"], None,
                                bl["bytes"], "ops")
    bounds["allpairs_join_tiles"] = (bl["bound_ms"], bl["bound_by"])
    del est_t
    # sharded serving beside the global index on the same rows, the calls
    # alternated (global, fan-out in 8 threads, fan-out in 1): top_pairs
    # p50 of TOPK_REPS, top_k_for_query p50 over the SHARD_QUERIES
    # queries, all_pairs; the flat index's scan once each
    shx, gix = shp["index"], dp["index"]
    fan = {"threads_8": shx._discovery,
           "threads_1": ShardedDiscoveryEngine(shx, tile=TOPK_TILE,
                                               max_workers=1)}
    fan["threads_1"].top_pairs(TOPK_K)
    scan_runs = collections.defaultdict(list)
    for _ in range(TOPK_REPS):
        scan_runs["global"].append(step_ms(
            lambda: dp["eng"].top_pairs(TOPK_K))[1])
        for key, eng in fan.items():
            scan_runs[key].append(step_ms(
                lambda eng=eng: eng.top_pairs(TOPK_K))[1])
    query_runs = collections.defaultdict(list)
    for q in shp["queries"]:
        query_runs["global"].append(step_ms(
            lambda: dp["eng"].top_k_for_query(q, TOPK_K))[1])
        for key, eng in fan.items():
            query_runs[key].append(step_ms(
                lambda eng=eng: eng.top_k_for_query(q, TOPK_K))[1])
    _, ap_global_ms = step_ms(gix.all_pairs)
    _, ap_sharded_ms = step_ms(shx.all_pairs)
    _, flat_global_ms = step_ms(lambda: dp["feng"].top_pairs(TOPK_K))
    _, flat_sharded_ms = step_ms(lambda: shp["flat"].top_pairs(TOPK_K))
    _, flat_serial_ms = step_ms(lambda: ShardedDiscoveryEngine(
        shp["flat"], tile=TOPK_TILE, max_workers=1).top_pairs(TOPK_K))
    sharded_t = {
        "top_pairs_p50_ms": {k: float(np.median(v))
                             for k, v in scan_runs.items()},
        "top_k_for_query_p50_ms": {k: float(np.median(v))
                                   for k, v in query_runs.items()},
        "tiles_launched": {
            "global": dp["scans"]["plain"].stats.tiles_launched,
            "sharded": shp["scans"]["plain"].stats.tiles_launched},
        "tiles_pruned": {
            "global": dp["scans"]["plain"].stats.tiles_pruned,
            "sharded": shp["scans"]["plain"].stats.tiles_pruned},
        "peak_bytes": {"global": dp["scans"]["plain"].stats.peak_bytes,
                       "sharded_merged":
                           shp["scans"]["plain"].stats.peak_bytes},
        "all_pairs_ms": {"global": ap_global_ms, "sharded": ap_sharded_ms},
        "flat_top_pairs_ms": {"global": flat_global_ms,
                              "threads_8": flat_sharded_ms,
                              "threads_1": flat_serial_ms,
                              "tiles_launched": shp["fscan"].stats
                              .tiles_launched}}
    # B2 at the union positions' shape (512, 2^18), k = m + 1: device-only,
    # through the wrapper, its plain version and torch.kthvalue
    q_o = torch.empty(BLOCK_ROWS, device=dev)
    q_launch = raw("sketch_build.sketch_build", "_select_lib",
                   "repro_radix_select", q_keys.data_ptr(), None, None,
                   DISC_M + 1, q_o.data_ptr(), *q_keys.shape)
    b2_union = {
        "shape": list(q_keys.shape), "k": DISC_M + 1,
        "device_ms": graph_ms(q_launch),
        "wrapper_ms": cuda_ms(lambda: tk.radix_select(q_keys, DISC_M + 1)),
        "plain_ms": cuda_ms(lambda: kth_smallest_ranks_ref(q_keys,
                                                          DISC_M + 1),
                            iters=3),
        "kthvalue_ms": cuda_ms(lambda: torch.kthvalue(q_keys, DISC_M + 1,
                                                      dim=1), iters=3),
        "bound_ms": (q_keys.numel() + BLOCK_ROWS) * 4 / HBM_BYTES_PER_S
        * 1e3}

    emit({"phase": "timing", "card": smi_line,
          "add_many_ms_per_block": float(np.mean(mp["block_ms"])),
          "add_many_block_ms": mp["block_ms"],
          "ingest_rows_per_s": D / mp["ingest_s"],
          "add_many_rows_per_s": D_BATCH / (sum(mp["block_ms"]) / 1e3),
          "query_p50_ms": float(np.percentile(mp["query_ms"], 50)),
          "query_p99_ms": float(np.percentile(mp["query_ms"], 99)),
          "all_pairs_ms": mp["all_pairs_ms"],
          "selection_ms": t["radix_select"][0],
          "selection_no_hist0_ms": selection_no_hist0_ms,
          "kthvalue_ms": t["radix_select"][2],
          "all_pairs_steps_ms": ap_steps,
          "allpairs_compact_and_join_ms": ap_ms,
          "allpairs_compact_ms": compact_ms,
          "allpairs_join_ms": join_ms,
          "allpairs_occupied_slots": occupied,
          "device_only_ms": device_only,
          "hash_rank_hist_routes": b1_routes,
          "threshold_path_block_ms": tp["block_ms"],
          "threshold_build_ms_per_block": threshold_ms,
          "threshold_build_plain_ms_per_block": threshold_plain_ms,
          "threshold_build_bound_ms":
              threshold_bytes / HBM_BYTES_PER_S * 1e3,
          "merge_from_ms": mg["merge_ms"],
          # the card's least time for the merge: both corpora read once,
          # the merged one written once (B6's bytes)
          "merge_from_bound_ms": bounds["merge_bucketized"][0],
          "add_many_block_steps_ms": add_steps,
          "query_steps_ms": query_steps,
          "merge_from_steps_ms": merge_steps,
          "store_C": MAT_C,
          "store_add_ms_p50": float(np.percentile(mx["add_ms"], 50)),
          "store_add_ms_p99": float(np.percentile(mx["add_ms"], 99)),
          "store_query_p50_ms": float(np.percentile(mx["query_ms"], 50)),
          "store_query_p99_ms": float(np.percentile(mx["query_ms"], 99)),
          "store_products_ms": mx["products_ms"],
          "store_products_pairs": MAT_PAIRS,
          "store_partitioned_ms": mx["part_ms"],
          "store_query_steps_ms": store_steps,
          "store_query_sketch_steps_ms": sketch_steps,
          "matrix_products_matches": b7_matches,
          "matrix_products_bound_all_inputs_ms":
              b7_full_bytes / HBM_BYTES_PER_S * 1e3,
          "allpairs_join_compares": join_ops,
          "join_size_path_s": jp["seconds"],
          "join_served_query_p50_ms": sv["query_ms"],
          "countsketch_ms_and_bound_by_shape": b8_shapes,
          "intersect_estimate_bounds": b4_bounds,
          "jl_rademacher_ms_and_bound_by_shape": b9_shapes,
          "jl_rademacher_sass_loop": {**jl_sass,
                                      "int_ops_bound_a_term": JL_INT_OPS},
          "kthvalue_at_one_vector": kth_d1,
          "int32_ops_per_s": INT32_OPS_PER_S,
          "path_seconds": {"main_path": mp["seconds"],
                           "threshold_path": tp["seconds"],
                           "merge_path": mg["seconds"],
                           "matrix_path": mx["seconds"],
                           "join_size_path": jp["seconds"],
                           "join_corr_path": jcp["seconds"],
                           "discovery_path": dp["seconds"],
                           "sharded_path": shp["seconds"]},
          "combined_build_ms_per_block": combined_build,
          "correlation_matrix_ms": corr_total_ms,
          "correlation_matrix_steps_ms": corr_steps,
          "allpairs_moments_b1024": b5_moments,
          "discovery": disc_t,
          "sharded": sharded_t,
          "radix_select_union_positions": b2_union,
          "store_add_column_p50_ms": float(np.percentile(
              jcp["store"]["add_ms"], 50)),
          "store_top_correlated_p50_ms": float(np.percentile(
              jcp["store"]["top_ms"], 50)),
          "kernel_ms": {k: v[0] for k, v in t.items()},
          "bound_ms": {k: v[0] for k, v in bounds.items()}})

    # --------------------------------------------------------------- kernels
    meta = {
        "hash_rank_hist": ("src/repro_torch/csrc/sketch_build.cu",
                           "src/repro/kernels/sketch_build/sketch_build.py:69",
                           "bit-equal"),
        "radix_select": ("src/repro_torch/csrc/radix_select.cu",
                         "src/repro/kernels/sketch_build/sketch_build.py:114",
                         "bit-equal"),
        "hash_rank_batched": ("src/repro_torch/csrc/sketch_build.cu",
                              "src/repro/kernels/hash_rank/hash_rank.py:111",
                              "bit-equal"),
        "hash_rank": ("src/repro_torch/csrc/sketch_build.cu",
                      "src/repro/kernels/hash_rank/hash_rank.py:75",
                      "bit-equal"),
        "intersect_estimate": (
            "src/repro_torch/csrc/intersect_estimate.cu",
            "src/repro/kernels/intersect_estimate/intersect_estimate.py:73",
            f"rtol={RTOL}"),
        "allpairs_compact": (
            "src/repro_torch/csrc/intersect_estimate.cu",
            "src/repro/kernels/intersect_estimate/intersect_estimate.py:150",
            "bit-equal"),
        "allpairs_estimate": (
            "src/repro_torch/csrc/intersect_estimate.cu",
            "src/repro/kernels/intersect_estimate/intersect_estimate.py:150",
            f"rtol={RTOL}"),
        "allpairs_join_tiles": (
            "src/repro_torch/csrc/intersect_estimate.cu",
            "src/repro/kernels/intersect_estimate/intersect_estimate.py:150",
            f"bit-equal to estimate_tile_rows; rtol={RTOL} to its plain "
            "version"),
        "merge_bucketized": (
            "src/repro_torch/csrc/sketch_merge.cu",
            "src/repro/kernels/sketch_merge/sketch_merge.py:84",
            "bit-equal"),
        "matrix_products": (
            "src/repro_torch/csrc/matrix_sketch.cu",
            "src/repro/kernels/matrix_sketch/matrix_sketch.py:70",
            f"rtol={RTOL}"),
        "countsketch_scatter": (
            "src/repro_torch/csrc/countsketch.cu",
            "src/repro/kernels/countsketch/countsketch.py:64",
            f"rtol=atol={CS_TOL}"),
        "jl_rademacher": (
            "src/repro_torch/csrc/jl_rademacher.cu",
            "src/repro/kernels/jl_rademacher/jl_rademacher.py:59",
            f"rtol={JL_TOL}, atol={JL_TOL} x max(1, max |out|)"),
    }
    # B8's and B9's library times are partial calls: they exclude the
    # hashes, so they do not compute the kernel's function
    library_call = {
        "radix_select": "torch.kthvalue (the same function)",
        "countsketch_scatter": "partial call, not the same function: "
                               "index_add_ of precomputed buckets and "
                               "signed values (hashes excluded)",
        "jl_rademacher": "partial call, not the same function: torch.mv "
                         "with the sign matrix materialised (hashes "
                         "excluded)"}
    # beside the bound: B4's full-stream bound, and the device-only times
    # of the kernels a wrapper's host time hides
    extra = {
        "intersect_estimate": {
            "bound_full_stream_ms": b4_bounds["served"]["full_stream_ms"],
            "device_ms": b4_bounds["served"]["device_ms"],
            "join_shape": b4_bounds["join"]},
        "countsketch_scatter": {"device_ms": device_only[
            f"countsketch_scatter n={JOIN_KEYS} m={JOIN_M}"]["device_ms"]},
        "hash_rank_hist": {
            "join_shape": b1_join,
            "join_shape_l2": device_only[
                f"hash_rank_hist D=1 n={JOIN_KEYS} l2 (join)"],
            "one_block": device_only[
                "hash_rank_hist D=1 n=256 l2 (one block)"]},
        "hash_rank": {
            "device_ms": device_only[f"hash_rank n={qn}"]["device_ms"],
            "join_shape": device_only[f"hash_rank n={JOIN_KEYS} (join)"],
            "one_block": device_only["hash_rank n=256 (one block)"]},
        "matrix_products": {
            "device_ms": b7_device["device_ms"], "device_only": b7_device,
            "products_call": device_only[
                f"matrix_products P={MAT_PAIRS} B={lib_buckets} "
                f"S={lib_slots} d={MAT_D} batched (products call)"]},
        "jl_rademacher": {
            "device_ms": device_only[
                f"jl_rademacher n={JOIN_KEYS} m={JOIN_M}"]["device_ms"],
            "parity_shape": device_only[f"jl_rademacher n={N} m={M} "
                                        "(parity)"],
            "sass_loop": jl_sass},
        "radix_select": {"library_ms_at_one_vector": kth_d1,
                         "union_positions_shape": b2_union},
        "allpairs_join_tiles": {
            "device_ms": bl["device_ms"], "groups": bl["groups"],
            "pairs": 132, "corpus": "flat",
            "batches": {w: r["batch_launch"] for w, r in disc_t.items()},
            "parity": jt_parity},
        "allpairs_estimate": {
            "moments_shape": b5_moments,
            "discovery_tiles": {w: r["tile_launch"]
                                for w, r in disc_t.items()},
            "discovery_heavy_rows_max_abs_err": dp["block_err"],
            "cross_shard_tile_max_abs_err": cross_err}}
    extra["hash_rank"]["flat_gradient"] = fg["hash_rank"]
    extra["hash_rank_hist"]["flat_gradient"] = fg["hash_rank_hist"]
    extra["radix_select"]["flat_gradient"] = {
        what: fg[f"radix_select_{what}"]
        for what in ("priority_tau", "threshold_cut")}
    rows = []
    for kname, (source, replaces, parity) in meta.items():
        ms, plain, lib, _, _ = t[kname]
        rows.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(v[kname] for v in launches.values()),
                     "launches_by_path": {p: v[kname]
                                          for p, v in launches.items()},
                     "max_abs_err": err[kname], "ms": ms, "plain_ms": plain,
                     "bound_ms": bounds[kname][0],
                     "bound_by": bounds[kname][1], "library_ms": lib,
                     "library_call": library_call.get(kname),
                     "parity": parity, **extra.get(kname, {})})
    check(all(r["launches"] > 0 for r in rows),
          f"a ported kernel never launched: {launches}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
