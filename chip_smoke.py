#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``vaq_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

from the root of the repository. It builds the port's CUDA kernels from
``vaq_tpu_torch/csrc`` with ``nvcc`` (into ``build/vaq_tpu_torch/``, one
``nvcc`` per source, all at once) and runs seventeen phases, printing progress
as it goes:

1. environment: the card's name and power limit, torch, CUDA and nvcc
   versions, and whether the native host module (``vaq_tpu_torch/native``)
   built;
2. build of the kernels, timed;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, timed with CUDA events after a warm-up, beside its bound
   (bytes over 3.35 TB/s or operations over the peak rate of their type,
   the larger) and one PyTorch call doing its dominant product where there
   is one: K1 at n = 1M codes and 512 queries, at M = 32, C = 256, d = 128
   with 128-row and with 64-row windows, at one 250,000-row shard's
   32-row windows ([shard] at S = 4), at 102,400 rows in 16-row windows
   ([cli]'s codes run), at the FAST "auto" shape
   (M = 64, C = 16, L = 2), and with 1024 queries in 512-row windows at
   M = 32, C = 256 and at M = 64, C = 16 ([bench]'s codes tier on its HEAP
   and FAST indexes), with its TFLOP/s and share of the bound; the
   tie-exact top-k helper and its forms beside ``torch.topk`` on K1's
   window scores at the port's selection widths; the decoded tier's
   selection of one batch (16 blocks of 512 × 65,536, kk = 200) as
   ``lowest_over_blocks``, tie-exact, and as the parent's running merge; K2 at the same codes, the rescore at 512 × 200 candidates; K5
   over the 1M probe buckets (1000 clusters of 1536 rows, 112 query slots,
   gs = 8) with int8 rows, at d = 96 (the shape of JAX's transposed K6),
   with bf16 rows, with about 51 of the 112 slots occupied (visit 0.1), at
   qcap = 512 (visit 1.0) and at [bench]'s qcap = 216 (1024 queries at
   visit 0.1), all occupied and about 102 occupied; K7 at 512 queries × 200
   windows of 8 rows, int8 and bf16, d = 128 and 96 (K8), and at [bench]'s
   1024 queries × 20 windows of 8 rows; K5 and K7 at the 100M probe's shapes (32 buckets of
   102,400 int8 rows at d = 96, gs = 256: K5 with 520 slots filled around
   256, K7 with 1024 queries × 20 windows, beside a bf16 ``bmm`` of the
   windows gathered beforehand); K3 (f32 LUT) and K4 (s8 LUT) at the FAST path's shape
   (M = 64, C = 16, 1M rows padded to 1,001,472, 512 queries, 256-row
   windows; the tensor-core form) and at M = 32, C = 256, 262,144 rows, 128
   queries, 512-row windows (the gather form), beside a tensor-core product
   of the codes' one-hot by the LUT (bf16 ``matmul`` / ``_int_mm``): K4's
   keys bit-equal to the plain version's, K3's too where the form adds to
   nearest, else within K3's packed-key tolerance with winners differing
   only on tied rows; before them, a probe of how the tensor cores round
   K3's f32 accumulation; K1 and K2 also at the ScalarLUTIndex shape
   (M' = 57, L = 1, C = 256); H1 (``popcount_dists``, xor and Jaccard) at
   512 queries × 1M rows × 8 words and at a probe block (10 clusters of
   4000 rows × 208 query slots), bit-equal to its plain version, beside
   its bound (the popcounts at 16 a clock per SM, or its bytes) and the
   ``_int_mm`` form of the same distances; D1 (``decoded_topk_scan``, the
   decoded tier's fused product and top-kk) at the benchmark cell's shape,
   1024 queries × 1M bf16 rows × 128 at k = 10 (kk = 26), and at [main]'s
   1000 queries × 1M × 128 at k = 100 and 200 (kk = 200 and 400, the
   geometries its searches launch), its merged candidates held to the
   plain blocked scan by ``kernel_check.d1_check``, beside the plain scan
   and a bf16 ``torch.mm`` then ``torch.topk``;
4. the codes path at SIFT1M shape, 1M × 128-d,
   ``VAQ256m32min7max8var1,HEAP`` on seeded synthetic data: train, encode,
   search on the decoded and on the codes tier (k = 100), then search 200
   and refine to 100, with times, QPS, peak device memory and recall against
   exact groundtruth, and a ``torch.profiler`` split of one 512-query codes
   batch by kernel, its busy share taken against the batch's unprofiled
   wall; K1/K2's launch counters are zeroed just before it and must have
   moved just after; then a codes search at k = 200 (64-row windows) with
   K1's counter zeroed just before it; then ``[kcheck]``: the package's
   kernel gate, ``kernel_check.kernel_parity_fields``, on this index with
   its first 128 queries (K1 at 64/32/16-row windows, K2 and K3, here in
   the gather form, on its first 65,536 codes; K5, K7 and H1 at their
   seeded shapes), every counter zeroed just before and read just after,
   ``kernel_parity_ok`` required; the same on the ``[fast]`` index after
   ``learn_quantization`` (K3 on the tensor cores, K4), its launches
   joining the kernels line's ``launches_by_path`` as ``"kcheck"``;
5. the TI/IVF path on the same index: ``attach_ivf`` with 1000 clusters
   over 16 subspaces (``bench.py:642-643``), searches at visit 0.25, 0.10,
   0.05 (the reference's Fig. 11 sweep) and 1.0, k = 100, and one search on
   the int8 ``decoded8`` tier, with the same numbers, a ``torch.profiler``
   split of one visit-0.1 batch by stage, and K5/K7's counters zeroed just
   before and read just after; at visit 1.0 the probe must reach the
   decoded tier's recall within 0.03;
6. ``[serve]``: ``SearchServer(backend="codes", k=100, max_batch=512,
   max_wait_ms=2, pipeline_depth=4)`` over the same index: 32 closed-loop
   client threads send 8000 single-row requests from the 1000 queries, then
   1000 requests of 16-row groups, with QPS, p50/p95/p99, mean batch fill,
   fetch seconds, batches and K1/K2's launches (zeroed before each load,
   each > 0); then ``bench.py``'s open-loop sweep of offered rates
   (``bench_torch.sweep_offered_rates``; 8 submitters of single rows, 4096
   requests a rate, doubling from 2000 a second until the server falls
   below 97% of it, midpoints between),
   its knee and p50/p95 at 80% of the knee; every answer held to
   ``search_device`` of the same rows in 512-query batches (ids up to near
   ties within fault 1's tolerance); the same with ``backend="decoded"``; a ``SearchHTTPServer`` answering
   200 POSTs from 16 threads the same way, ``/healthz`` and ``/stats``; the
   ``serve`` CLI as a subprocess at 102,400 synthetic rows on the codes
   tier, one ``/search``, then terminated;
7. ``[shard]``: ``VAQIndex.shard`` of the same index over S = 2 and 4
   shards of the one card (``make_mesh(devices=[cuda:0] * S)``), every
   tier: the decoded tier's distances rank by rank at most the unsharded
   tier's (each shard rescores its own 2k bf16-ranked candidates, a
   superset of one device's 2k), the codes tier (K1 at 64- and 32-row windows, K2) and
   the int8 tier within 0.02 avg_recall@100 of their unsharded readings,
   the probe at visit 0.1 with the exact second stage (K5/K7 per shard)
   within 0.03; QPS, recall and launch counts per tier and S;
   ``sharded_exact_search`` against ``exact_search``; ``lloyd_sharded`` at
   S = 2 against ``kmeans.lloyd``, step by step from the same centroids
   (the shards' per-cluster counts equal the unsharded ones, centroids
   within 1e-5 of the largest), the drift of ten chained iterations
   logged beside that of ``kmeans.lloyd`` on the same rows in another
   order;
8. ``[checks]``, the checks of JAX's root scripts through their port-side
   scripts: ``scripts/check_sharded_100k_torch.py``'s ``run`` on the first
   100,000 rows and 256 queries (``VAQ256m32min7max8var1,TI64m16``, visit
   1.0, k = 10) unsharded and over 8 shards of the one card, the sharded
   recall within 0.005 of the unsharded one, qcap holding every query on
   every shard, K5/K7 launched per shard and then held against their plain
   versions at those shards' shapes (8 buckets of 2560 int8 rows, qcap
   256, gs 16; 256 queries × 40 windows of 16 rows);
   ``scripts/compute_accuracy_torch.py``'s ``main`` on [main]'s decoded
   answers written as CSV and its groundtruth as ``.ivecs``, its three
   printed numbers equal to ``metrics``'; ``scripts/oracle_bisect_torch.py``'s
   ``run`` without the oracle at 20k rows, stage C (the f32 LUT gather) at
   least stage B (the decoded tier) − 0.01, stage D (the f64 host scan over
   the same codes) within 0.002 of C;
9. ``[crud]``, the same index and probe state mutated: ``add`` of 10,000
   rows of the base's own mixture, ``delete`` of 10,000 ids (the first 100
   queries' top-1 among them), then searches on the decoded, int8 and codes
   tiers (K1/K2's counters zeroed before, read after) and the probe at
   visit 0.1 (K5/K7's), each tier's recall against exact groundtruth over
   the live rows; no tier may return a deleted row, 256 added rows searched
   as queries must be their own top-1 on the decoded tier, the probe must
   never return an added row (its buckets predate the add, as in JAX), and
   the poisoned slots must be the deleted rows the buckets held; then the
   reference-format artifacts round trip (codes and centroids equal) and
   ``load(with_codes=False)``;
10. the FAST/LUT path on the same data, ``VAQ256m64min1max4var1,FAST``
   (``bench.py:603``'s FAST config at d = 128): train and encode twice
   (the two rotations, codebooks and codes must be bit-equal),
   ``search(backend="fast4")`` (K3), ``learn_quantization``, the same search
   again (K4), ``"lut_gather"``, ``"auto"`` (which the route sends to the
   codes tier: K1 must launch, K3/K4 must not), and a fast4 search of 200
   refined to 100, with a ``torch.profiler`` split of one fast4 batch with
   each LUT by stage (``fast.lut``, ``fast.scan``, ``fast.select``,
   ``fast.rescore``, ``fast.topk``) and its busy share of the unprofiled
   wall; K3's, K4's and K1's counters are zeroed before their steps and must
   have moved after them;
11. ``[wide]``: ``VAQ256m32min2max13var1,HEAP`` with the hierarchical
   k-means (up to 13-bit subspaces, int32 codes) on the same 1M rows:
   train and encode times, the decoded tier's recall and refine 200 → 100
   against the main groundtruth, then ``scripts/widebits_1m_torch.py``'s
   u16 gate on the first 131,072 rows and 128 queries (the f32 LUT-gather
   top-10 over the codes against the decoded tier's, overlap at least
   0.95); the codes tier must refuse it;
12. ``[binary]``, the BitVecEngine (``vaq_tpu_torch/binary.py``) on the
   main path's 1M rows, queries and groundtruth: ``BinaryIndex(256)``
   trained and encoded on the host, then ``query`` k = 100 through
   ``"auto"`` (the ``_int_mm`` form) and ``"packed"`` (kernel H1), which
   must agree exactly, with a ``torch.profiler`` table of each, Jaccard
   (H1), rerank ×10, ``query_naive`` L2 (equal to the groundtruth) and
   Manhattan, ``query_filtering`` over 4 sub-vectors and its heap variant
   on 16 queries, 1000 Hamming clusters probed at n_probe 100 and 1000 (at
   1000 the packed scan's distances row for row, ids apart only inside the
   k-th tie group, each id at its stated distance), H1 held against its
   plain version on one cluster block of that state, the streaming scan
   over the rows written as raw f32 (ids equal to the groundtruth), append
   and delete of 10,000 rows, a save/load round trip, and
   ``ScalarLUTIndex(256)`` on the codes tier (K1/K2 at M' = 57, L = 1)
   and refined; each step's wall, QPS, recall and peak memory; H1's
   launch count zeroed before each of its steps and K1/K2's before the
   codes tier, each required to move;
13. ``[cli]``: ``vaq_tpu_torch.cli.demo_vaq.main`` on 100,000 synthetic
   rows, ``--backend codes --refine 100,200``, its printed lines kept, and
   on 102,400 rows, where refine 100's search runs K1/K2 (counted; K1's
   16-row windows are held against the plain version in phase 3); then at
   1M × 128 ``demo_cluster`` (k = 100, 25 iterations, simple, fast and
   kmeans++, each cluster index within 1% of the same command's CPU
   reading), ``demo_boltcentroids --subspace 32`` (512 centroids of 4
   finite numbers) and ``demo_vaq_paramsearch`` on JAX's default grid (its
   seven rows; ``METHOD``'s within 0.005 of phase 4's decoded recall);
14. one index state searched on the card and through the port's CPU plain
   versions at n = 20k (the decoded and codes tiers, refine, an IVF state
   built on the card and copied to the CPU at d = 128 and d = 96, that
   state mutated alike on both by add and delete, the hierarchical and the
   binary-split configs trained on the card, with the binary split's
   training time, a FAST state through fast4 with and without its LUT
   quantizers and through ``"lut_gather"``, and a ``BinaryIndex(256)``
   state through packed, matmul, Jaccard, both filters and the cluster
   probe); the answers must agree, the binary ones identically;
15. ``[bench]``: ``python3 bench_torch.py --second-n 0 --no-oracle`` as a
   subprocess, ``bench.py``'s sections on the port at 1M × 128 (recall and
   refine, the headline five times, the kernel gate, the int8 and Hamming
   tiers, the codes tier on the HEAP and FAST indexes, the IVF probe at
   1000 clusters, the server's offered-load sweep on the decoded and codes
   tiers): its one stdout line within 1900 characters, no ``_error``
   field, ``kernel_parity_ok`` true, every QPS above 0, refine no worse
   than ADC; its sidecar's launches show the gate's counts and K1/K2 in the
   codes sections, K5/K7 in the IVF section, and join the kernels line's
   ``launches_by_path`` as ``"bench"``; its sidecar's kernel shapes must be
   those phase 3 holds for it (K1 at 1024 queries in 512-row windows on
   both indexes, K5 at qcap = 216, K7 at 1024 × 20 windows of 8 rows), and
   the launches at those shapes are those entries' ``launches``;
16. ``[deep100m]``: ``scripts/capacity_100m_torch.py``'s ``run()`` at the
   full DEEP-100M size, 100M × 96, ``VAQ256m32min5max8var1``, 1024 queries,
   k = 10: rows generated on the card, train, streamed encode, exact
   groundtruth@100, the codes tier (K1/K2's counters zeroed before, read
   after), the bf16 tier through ``search(backend="auto")`` (D1's counter
   zeroed before, read after) and D1 alone held against the plain scan on
   that tier by ``kernel_check.d1_check`` and timed beside its bound (the
   ``decoded_topk_scan_100m`` entry: 1024 queries × 100M × 96 at kk = 26,
   rows past 2^31 bytes; the tier released after), the int8 tier, refine
   100 and 500 → 10, the streamed probe build
   (1000 clusters, capacity 102,400, gs = 256) with the codes and the int8
   tier resident, and visit 0.25 / 0.10 / 0.05 (K5/K7's counters zeroed
   before the sweep, read after), each stage's wall, QPS, recall and peak
   memory, and a ``torch.profiler`` split of one visit-0.1 batch; recall
   at visit 0.25 must reach visit 0.05's, refine 500 refine 100's and
   refine 100 the int8 tier's. Then K1/K2 (on the resident 100M codes, the
   path's queries, table and 512-row windows) and K5/K7 (on the resident
   1000 buckets of 102,400 rows) are held against their plain versions,
   where their offsets pass 2^31.

Any failure ends the run with a non-zero exit and no result line. The last
two lines are a JSON object of per-kernel numbers and the card's
``nvidia-smi`` name and power limit; the very last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits at once.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 42
N_MAIN, D_MAIN, NQ_MAIN = 1_000_000, 128, 1000
METHOD = "VAQ256m32min7max8var1,HEAP"
# Kernel check at the main path's shapes.
KC_N, KC_M, KC_C, KC_L, KC_NQ, KC_BR, KC_KK = 1_000_000, 32, 256, 4, 512, 128, 200
RTOL_KERNEL = 1e-5   # f32 sums in another order: last-bit differences
# [bench]'s shapes (bench_torch.py's defaults: 1M × 128, one batch of 1024
# queries, k = 10): the codes tier's windows of 1M // (64·10) rows, capped
# at 512; the probe at visit 0.1 gives pick_qcap(1024, 100, 1000) = 216
# query slots a cluster, about 102 of them occupied (1024 · 100 / 1000),
# and K7 m = max(2k, 16) = 20 windows of gs = 8 rows a query
BENCH_NQ, BENCH_BR, BENCH_QCAP, BENCH_SLOTS, BENCH_WIN = 1024, 512, 216, 102, 20
# K1 at the codes path's shape, at the FAST "auto" shape (M = 64, C = 16,
# L = 2) and at 64-row windows (the codes tier at k = 200), each as
# (n, M, C, L, nq, block_rows). Its scores keep only the high 23 − idx_bits
# mantissa bits (the low ones hold the row index), so two last-bit-different
# sums can land one step of 2^(idx_bits − 23), relative, apart: 1.5e-5 at
# 128-row windows.
K1_SHAPES = ((KC_N, KC_M, KC_C, KC_L, KC_NQ, KC_BR),
             (KC_N, 64, 16, 2, KC_NQ, KC_BR),
             (KC_N, KC_M, KC_C, KC_L, KC_NQ, 64),
             (KC_N, 57, KC_C, 1, KC_NQ, KC_BR),
             (KC_N // 4, KC_M, KC_C, KC_L, KC_NQ, 32),
             (102_400, KC_M, KC_C, KC_L, KC_NQ, 16),
             (KC_N, KC_M, KC_C, KC_L, BENCH_NQ, BENCH_BR),
             (KC_N, 64, 16, 2, BENCH_NQ, BENCH_BR))
# The fourth K1 shape is [binary]'s ScalarLUTIndex(256) codes tier: M' = 57
# kept dimensions of one subspace each (L = 1), C = 256, 128-row windows; a
# 57-byte codes row is no multiple of 4 or 16 bytes and the depth pads to 64.
# The fifth is one shard of [shard]'s codes tier at S = 4: 250,000 rows in
# 32-row windows (K1 meets in global memory by atomicMin below 64 rows).
# The sixth is [cli]'s codes run: demo_vaq at 102,400 rows, whose refine
# 100 searches the codes tier in 16-row windows (refine 200's, at 8 rows,
# the decoded tier), so every K1 launch of that run is at this shape.
# The last two are [bench]'s codes tier on the HEAP index and on the FAST
# index (its fast4_qps): 1024 queries in 512-row windows.
LUT_M = K1_SHAPES[3][1]
# (width, k) of the port's selections at 1M rows, 512 queries: the rescored
# top-k of 2k candidates (codes, decoded, FAST, IVF second stage), the IVF
# row pick (200 windows of 8), FAST's window pick (3912 windows), the codes
# tier's (7813), the IVF merge (100 clusters × 192 groups) and the LUT
# gather scan's (k + 32,768)
SELECT_WIDTHS = ((200, 100), (1600, 200), (3912, 100), (7813, 200),
                 (19200, 200), (32868, 100))
N_CMP, NQ_CMP, K_CMP = 20_000, 200, 10
DEVICE = "cuda"
# The probe buckets of the 1M index (attach_ivf at 1000 clusters: capacity
# ceil(1.5·1M/1000) rounded to 512) and the slots pick_qcap(512, 100, 1000)
# gives at visit 0.1; K7 at 512 queries × m = 200 windows of gs = 8 rows.
KC_NCL, KC_CAP, KC_QCAP, KC_GS, KC_WIN = 1000, 1536, 112, 8, 200
# K5's other two checks: about 51 of the 112 slots occupied per cluster (the
# dispatch's fill at visit 0.1), and qcap = 512 (visit 1.0)
KC_SLOTS_MEAN, KC_QCAP_FULL = 51, 512
# [deep100m]: the reference's Fig. 11a deployment, DEEP-100M
# (ExperimentsParameters.txt:114-124), at full size through
# scripts/capacity_100m_torch.py: 100M × 96, VAQ256m32min5max8var1, 1024
# queries in one batch, k = 10, 1000 clusters over 16 subspaces at capacity
# factor 1.0 (102,400 slots a cluster, gs = 256), visit 0.25 / 0.10 / 0.05
DEEP_N, DEEP_D, DEEP_NQ, DEEP_K = 100_000_000, 96, 1024, 10
# K5/K7 at that path's shapes, on 32 of its clusters: visit 0.25's qcap
# (pick_qcap(1024, 250, 1000) = 520 slots) filled around its mean demand of
# 256 queries a cluster; K7 with m = max(2k, 16) = 20 windows of 256 rows a
# query
KD_NCL, KD_CAP, KD_GS, KD_QCAP, KD_SLOTS, KD_WIN = 32, 102_400, 256, 520, 256, 20
# K5 on the resident 100M buckets: live slots in the last 16 of the 1000
# clusters only
KD_LIVE = 16
# [serve]: SearchServer(k = 100, max_batch = 512, max_wait 2 ms, 4 batches
# in flight) over the 1M index; 32 closed-loop clients send 8000 single-row
# requests, then 1000 requests of 16 rows; 200 HTTP requests from 16
# threads; the serve CLI at 102,400 synthetic rows on the codes tier
SERVE_THREADS, SERVE_SINGLE, SERVE_GROUPS, SERVE_GROUP = 32, 8000, 1000, 16
SERVE_HTTP, SERVE_HTTP_THREADS = 200, 16
SERVE_CLI_ARGS = ["--synthetic", "102400", "--backend", "codes", "--k", "10",
                  "--port", "0"]
SERVE_CLI_LIMIT_S = 120
# The open-loop sweep of bench.py's serving_knee_fields: 8 submitters, 4096
# single-row requests a rate, offered by bench_torch.sweep_offered_rates
# (from 2000 a second doubling while the server keeps up, midpoint probes
# past the knee), then 80% of the knee; the cap is 4× bench.py's 32,000
SWEEP_SUBMITTERS, SWEEP_REQUESTS, SWEEP_CAP = 8, 4096, 128_000.0
# [shard]: the 1M index over S shards of the one card; at S = 4 the codes
# tier's per-shard windows are 250,000 // 6,400 → 32 rows; the probe at
# visit 0.1; the distributed Lloyd on the first 200k rows, 256 clusters
SHARDS, SHARD_VISIT = (2, 4), 0.10
KM_ROWS, KM_K, KM_ITERS = 200_000, 256, 10
# [checks]: scripts/check_sharded_100k_torch.py's check on [main]'s first
# 100k rows and 256 queries (VAQ256m32min7max8var1,TI64m16 at visit 1.0,
# k = 10) over 8 shards of the one card, the sharded recall within 0.005 of
# the unsharded one; scripts/oracle_bisect_torch.py without the oracle on
# [main]'s first 20k rows and its queries, k = 10, C (the f32 LUT gather)
# at least B (the decoded tier) − 0.01 and D (the f64 host scan over the
# same codes) within 0.002 of C
CHECK_N, CHECK_NQ, CHECK_SHARDS, CHECK_K = 100_000, 256, 8, 10
BISECT_N, BISECT_K = 20_000, 10
TI_CLUSTERS, TI_SEGMENTS = 1000, 16       # bench.py:642-643
VISITS = (0.25, 0.10, 0.05, 1.0)          # Fig. 11 (ExperimentsParameters.txt:114-124), then all
# K3/K4 at the FAST path's shape (M = 64, C = 16, 256-row windows, 512
# queries; n pads to 1,001,472 rows) and at one C = 256 shape.
KF_SHAPES = ((1_000_000, 64, 16, 512, 256), (262_144, 32, 256, 128, 512))
FAST_METHOD = "VAQ256m64min1max4var1,FAST"   # bench.py:603's FAST config at d = 128
# [crud]: rows added and ids deleted on the 1M index, and added rows searched
# as queries
N_ADD, N_DEL, N_SELF = 10_000, 10_000, 256
# [wide]: the wide-bits config of WIDEBITS_1M.json (hierarchical k-means up
# to 13 bits); at 20k also the binary-split k-means on a config with a few
# 9-bit subspaces: it runs one 2-means a node, ~17 ms each on the card, so
# 13 bits (~8k nodes a subspace) waits for the level-batched form (ROADMAP
# queue 2b, item 13)
WIDE_METHOD = "VAQ256m32min2max13var1,HEAP"
# scripts/widebits_1m_torch.py's u16 gate on [wide]'s index (its first
# 131,072 rows, 128 queries, k = 10): the f32 LUT-gather top-k must share
# at least this much with the decoded tier's (JAX read 0.9891 at 20k rows)
WIDE_GATE_MIN, WIDE_GATE_K = 0.95, 10
BINARY_METHOD = "VAQ96m16min5max9var1,HEAP"
# [cli]: demo_vaq's flags. At 100k rows the codes tier has windows of
# 100000 // (64·k) rows, 15 at k = 100 and 7 at k = 200: below 16 rows, so
# both refines are served by the decoded tier (JAX's rule), not by K1/K2.
CLI_ARGS = ["--synthetic", "100000", "--method", METHOD, "--refine", "100,200",
            "--backend", "codes"]
# The same command under VAQ_TPU_PLATFORM=cpu reads avg_recall 0.5788
# (refine 100) and 0.8131 (refine 200); the card must come within 0.02.
CLI_MIN_RECALL = (0.5588, 0.7931)
# At 102,400 rows the codes tier has 16-row windows at k = 100, so refine
# 100's search runs K1/K2 (refine 200's, at 8 rows, the decoded tier). The
# same command under VAQ_TPU_PLATFORM=cpu (the plain versions) reads
# CLI_CODES_CPU_RECALL; the card must come within 0.02.
CLI_CODES_ARGS = ["--synthetic", "102400", *CLI_ARGS[2:]]
CLI_CODES_CPU_RECALL = (0.5779, 0.8051)
# [cli]'s clustering demos at the main path's shape, 1M × 128, on their own
# synthetic rows (make_anisotropic_gaussian at seed 0, as JAX's demos draw
# them): demo_cluster k = 100, 25 iterations, silhouette, in three versions
# (kmeans++ seeds on the host, D² over all 1M rows), demo_boltcentroids over
# 32 subspaces, and demo_vaq_paramsearch on JAX's default grid over the main
# path's rows and queries (make_sift_like draws them at seed 42, k = 100).
CLUSTER_ARGS = ["--synthetic", "1000000", "--timeseries-size", "128", "--k",
                "100", "--iters", "25", "--silhouette"]
# The same commands under VAQ_TPU_PLATFORM=cpu read these cluster indexes
# (the same seeds; f32 sums in another order); the card must come within 1%.
CLUSTER_CPU_INDEX = {"simple": 24.430342, "fast": 26.231831,
                     "kmeanspp": 9.776003}
BOLT_ARGS = ["--synthetic", "1000000", "--timeseries-size", "128",
             "--subspace", "32"]
PARAMSEARCH_ARGS = ["--synthetic", "1000000", "--timeseries-size", "128",
                    "--queries-size", "1000", "--k", "100"]
# JAX's default grid (--subspaces 16,32,64 --min-bits 1,2,4,7 --max-bits 8)
# at budget 256: m = 16 cannot hold 256 bits, m = 64 cannot spend 7 a
# subspace, so these seven train, in this order. The (32, 7, 8) row is
# METHOD on [main]'s data: its recall must come within 0.005 of [main]'s
# decoded tier, the tier search(backend="auto") serves.
PARAMSEARCH_ROWS = [[32, 1, 8], [32, 2, 8], [32, 4, 8], [32, 7, 8],
                    [64, 1, 8], [64, 2, 8], [64, 4, 8]]
# [kcheck]: the package's kernel gate on [main]'s index and on [fast]'s
# after learn_quantization, with the first KCHECK_NQ queries
KCHECK_NQ = 128
# [binary]: the BitVecEngine at the main path's 1M × 128 rows, queries and
# groundtruth: BinaryIndex(256) (demo_binary.cpp's default budget, bench.py:567)
# trained and encoded on all rows, k = 100; the progressive filters over 4
# sub-vectors, the heap variant on 16 queries; 1000 Hamming clusters of 25
# k-means iterations probed at 100 and 1000; the streaming scan in chunks of
# 262,144 rows; 10,000 rows appended, 10,000 deleted.
BIN_BUDGET, BIN_SUBVECTORS, BIN_HEAP_NQ = 256, 4, 16
BIN_CLUSTERS, BIN_ITERS, BIN_PROBES = 1000, 25, (100, 1000)
BIN_STREAM_ROWS = 262_144
# H1 at 512 queries × the 1M rows' 8 words, and at a probe block: 10
# clusters of 4000 rows (a more skewed clustering than [binary]'s, whose
# largest of 1000 holds about 2200; [binary] checks its own block too)
# against the 208 query slots pick_qcap(1000, 100, 1000) gives.
KH_W, KH_PROBE = 8, (10, 208, 4000)
# [bench]: bench_torch.py as a user runs it, at its 1M defaults without the
# engine-vs-oracle slice (host numpy, ~20 minutes at 100k rows) and the 10M
# section; the kernel gate's launches of one call, which its
# kernel_parity section must show
BENCH_ARGS = ["--second-n", "0", "--no-oracle"]
BENCH_LIMIT_S = 420
# the QPS fields every such run prints; the serving knees print only where
# the sweep's first rate, 2000/s, was kept up with (bench.py's rule)
BENCH_QPS = ("decoded8_qps", "hamming_qps", "codes_qps", "fast4_qps",
             "ivf_qps")
BENCH_GATE_LAUNCHES = {"decode_window_scan": 3, "decode_rescore": 1,
                       "groupmin_window_scan": 4, "gather_rescore": 3,
                       "popcount_dists": 4, "decoded_topk_scan": 2}
# D1 at the benchmark's sift1m-heap.batch shape: (n, d, nq, k); and at
# [main]'s 1M × 128 with its 1000 queries at k = 100 (kk = 200: the decoded
# searches) and k = 200 (kk = 400: the "auto" search that refine fetches
# from), whose heaps leave room for fewer warps a block (16-query warps at
# kk = 400)
KD1_SHAPE = (1_000_000, 128, 1024, 10)
KD1_MAIN_SHAPES = ((N_MAIN, D_MAIN, NQ_MAIN, 100), (N_MAIN, D_MAIN, NQ_MAIN, 200))
# Published H100 SXM peaks (NVIDIA data sheet), for the bounds.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# H1's popcounts: 16 results a clock per SM for compute capability 9.0 (the
# CUDA C++ Programming Guide's arithmetic-instruction throughput table), at
# the card's maximum SM clock (nvidia-smi clocks.max.sm).
POPC_PER_CLOCK_PER_SM = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def _script(name: str):
    """The module of ``scripts/<name>.py`` (the port's scripts import
    ``vaq_tpu_torch`` and ``bench_torch``, never the JAX package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_environment() -> str:
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    from vaq_tpu_torch import _build
    nvcc = _run([_build._nvcc(), "--version"]).splitlines()[-1]
    log(f"[env] nvidia-smi: {smi}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")
    log(f"[env] nvcc: {nvcc}")
    from vaq_tpu_torch import native
    log(f"[env] native host module: "
        f"{'loaded' if native.get() is not None else 'not built, numpy paths'}")
    return smi


def _clocks() -> str:
    return _run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
                 "temperature.gpu", "--format=csv,noheader"]).splitlines()[0]


def phase_build() -> float:
    from vaq_tpu_torch import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    log(f"[build] {path.name} in {dt:.2f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry", "warning")):
            log(f"[build] {line.strip()}")
    return dt


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.cache
def _popc_per_s() -> float:
    """The card's popcount rate: POPC_PER_CLOCK_PER_SM × SMs × its maximum
    SM clock."""
    mhz = float(_run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                      "--format=csv,noheader,nounits"]).splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLOCK_PER_SM * sms * mhz * 1e6


def _bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate
    or operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = _popc_per_s() if kind == "popc" else PEAK_OPS_PER_S[kind]
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _entry(name, source, replaces, err, ms, plain_ms, bound, library_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": library_ms}


def _assert_within_terms(got, ref, scale, what, rtol=RTOL_KERNEL):
    """``kernel_check.scores_within``: same finite pattern, |got − ref| ≤
    rtol · scale elementwise, ``scale`` being the size of the terms each
    result sums (f64); returns the largest |got − ref|."""
    from vaq_tpu_torch.ops import kernel_check
    ok, detail = kernel_check.scores_within(got, ref, scale, rtol)
    assert ok, f"{what}: {detail}"
    fin = torch.isfinite(ref)
    return float((got[fin] - ref[fin]).abs().max())


def _probe_rows(gen, d, dtype, ncl=KC_NCL, cap=KC_CAP):
    """Probe buckets of ``ncl`` × ``cap`` rows (the 1M index's by default)
    filled with seeded rows: int8 of scale 32 (w = 1/32²) or their bf16
    values (w = 1); the last 3 slots of each bucket hold padding (the int8
    poison pattern / the 1e15 bf16 sentinel)."""
    from vaq_tpu_torch.ops import probe_scan
    dev = torch.device(DEVICE)
    x = torch.randn((ncl, cap, d), generator=gen, device=dev) * 32.0
    x = torch.clamp(torch.round(x), -127, 127)
    if dtype == "int8":
        x = x.to(torch.int8)
        x[:, -3:] = torch.as_tensor(probe_scan.poison_pattern(d), device=dev)
        w = torch.full((d,), 1.0 / 1024.0, device=dev)
    else:
        x = x.to(torch.bfloat16)
        x[:, -3:] = 1e15
        w = torch.ones((d,), device=dev)
    return x.view(ncl * cap, d), w


def _check_groupmin(gen, d: int, dtype: str, qcap: int = KC_QCAP,
                    slots_mean: int | None = None, ncl: int = KC_NCL,
                    cap: int = KC_CAP, gs: int = KC_GS, name: str | None = None,
                    tag: str = "kernels") -> dict:
    """K5 over ``ncl`` probe buckets of ``cap`` seeded rows (the 1M
    index's by default), all ``qcap`` slots occupied or, with
    ``slots_mean``, n_slots drawn around it per cluster (as the dispatch
    fills them), held against its plain version by :func:`_held_groupmin`;
    ``name`` replaces the entry's name built from the shape."""
    dev = torch.device(DEVICE)
    rows, w = _probe_rows(gen, d, dtype, ncl, cap)
    qsl = (-2.0 * torch.randn((ncl, qcap, d), generator=gen,
                              device=dev)).to(torch.bfloat16)
    n_slots = None
    if slots_mean is not None:
        n_slots = torch.clamp(torch.round(
            slots_mean + 12.0 * torch.randn((ncl,), generator=gen, device=dev)),
            0, qcap).to(torch.int32)
    k6 = d % 128 != 0
    name = name or ("groupmin_window_scan" + (f"_d{d}" if k6 else "")
                    + ("" if gs == KC_GS else f"_gs{gs}")
                    + ("" if dtype == "int8" else "_bf16")
                    + ("" if qcap == KC_QCAP else f"_q{qcap}")
                    + ("" if slots_mean is None else f"_slots{slots_mean}"))
    what = (f"d={d} {dtype} rows, qcap={qcap}"
            + ("" if gs == KC_GS and ncl == KC_NCL
               else f", {ncl} buckets of {cap} rows, gs={gs}"))
    return _held_groupmin((qsl, rows, w, ncl, cap, gs, n_slots), name, what,
                          tag)


def _held_groupmin(args, name: str, what: str, tag: str = "kernels",
                   library: bool = True, plain_reps: int = 3) -> dict:
    """K5 against its plain version on ``args`` (qsl, rows, w, ncl, cap, gs,
    n_slots); tolerance 1e-5 of the terms summed (bf16 × int8/bf16 products
    are exact in f32; only the order of the sums differs), checked on the
    clusters with live slots, the rest +inf in both. The bound counts what
    these inputs need: those clusters' rows, the live slots' slab, the
    minima, and the products of live slots only. The library yardstick
    (``library``) is one bf16 ``bmm`` of every slab against its bucket."""
    from vaq_tpu_torch.ops import kernel_check, probe_scan
    qsl, rows, w, ncl, cap, gs, n_slots = args
    qcap, d = qsl.shape[1:]
    got = probe_scan.groupmin_window_scan(*args)
    ref = probe_scan.groupmin_window_scan_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == (ncl, qcap, cap // gs)
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref)), name
    if n_slots is None:
        live_c, live = ncl, ncl * qcap
        scale = kernel_check.groupmin_term_scale(qsl, rows, w, ncl, cap, gs)
        err = _assert_within_terms(got, ref, scale, f"K5 {what}")
    else:
        held = torch.nonzero(n_slots > 0)[:, 0]
        live_c, live = held.numel(), int(n_slots.sum())
        sub_rows = rows.view(ncl, cap, d)[held].view(-1, d)
        scale = kernel_check.groupmin_term_scale(qsl[held], sub_rows, w,
                                                 live_c, cap, gs)
        err = _assert_within_terms(got[held], ref[held], scale, f"K5 {what}")
        del sub_rows
    del scale, ref
    ms = _time_ms(lambda: probe_scan.groupmin_window_scan(*args), 10)
    plain = _time_ms(lambda: probe_scan.groupmin_window_scan_ref(*args),
                     plain_reps)
    lib_ms = None
    if library:
        rows_bf = rows.view(ncl, cap, d).to(torch.bfloat16).transpose(1, 2)
        lib_ms = _time_ms(lambda: torch.bmm(qsl, rows_bf), 10)
        del rows_bf
    ng = cap // gs
    nbytes = (live_c * cap * d * rows.element_size() + live * d * 2 + d * 4
              + ncl * qcap * ng * 4)
    ops = 2.0 * live * cap * d + 3.0 * live_c * cap * d
    bound = _bound(nbytes, ops, "bf16")
    if n_slots is not None:
        what += f", {live / live_c:.1f} live slots in each of {live_c} clusters"
    log(f"[{tag}] K5 groupmin_window_scan {what}: max|Δ| {err:.3g}, kernel "
        f"{ms:.3f} ms ({100 * bound[0] / ms:.1f}% of the bound), plain "
        f"{plain:.3f} ms, "
        + (f"bf16 bmm {lib_ms:.3f} ms, " if lib_ms is not None else "")
        + f"bound {bound[0]:.4f} ms ({bound[1]})")
    return _entry(name, "vaq_tpu_torch/csrc/groupmin_window_scan.cu",
                  "vaq_tpu/ops/probe_pallas.py:" + ("205" if d % 128 else "158"),
                  err, ms, plain, bound, lib_ms)


def _check_rescore(gen, d: int, dtype: str, nq: int = KC_NQ,
                   win: int = KC_WIN, gs: int = KC_GS, ncl: int = KC_NCL,
                   cap: int = KC_CAP, suffix: str = "", name: str | None = None,
                   tag: str = "kernels") -> dict:
    """K7 on ``nq`` queries × ``win`` windows of ``gs`` rows drawn from
    ``ncl`` probe buckets of ``cap`` seeded rows (512 × 200 windows of 8
    rows from the 1M buckets by default), held against its plain version by
    :func:`_held_rescore`; ``suffix`` ends the entry's name, ``name``
    replaces it."""
    dev = torch.device(DEVICE)
    rows, w = _probe_rows(gen, d, dtype, ncl, cap)
    q = torch.randn((nq, d), generator=gen, device=dev)
    wblk = torch.randint(0, rows.shape[0] // gs, (nq, win), generator=gen,
                         device=dev, dtype=torch.int32)
    name = name or ("gather_rescore" + (f"_d{d}" if d % 128 else "")
                    + ("" if gs == KC_GS else f"_gs{gs}")
                    + ("" if dtype == "int8" else "_bf16") + suffix)
    return _held_rescore((q, w, rows, wblk, gs), name,
                         f"d={d} {dtype} rows, {nq} queries × {win} windows "
                         f"of {gs}", tag)


def _held_rescore(args, name: str, what: str, tag: str = "kernels") -> dict:
    """K7 against its plain version on ``args`` (q, w, rows, wblk, gs);
    tolerance 1e-5 of the terms summed."""
    from vaq_tpu_torch.ops import kernel_check, rescore
    q, w, rows, wblk, gs = args
    nq, win = wblk.shape
    d = rows.shape[1]
    n_blk = rows.shape[0] // gs
    got = rescore.gather_rescore(*args)
    ref = rescore.gather_rescore_ref(*args)
    torch.cuda.synchronize()
    assert got.shape == (nq, win, gs)
    err = _assert_within_terms(got, ref, kernel_check.rescore_term_scale(*args),
                               f"K7 {what}")
    del ref
    ms = _time_ms(lambda: rescore.gather_rescore(*args), 20)
    plain = _time_ms(lambda: rescore.gather_rescore_ref(*args), 5)
    gathered = nq * win * gs * d
    nbytes = (gathered * rows.element_size() + q.numel() * 4 + d * 4
              + wblk.numel() * 4 + got.numel() * 4)
    bound = _bound(nbytes, 4.0 * gathered, "bf16")
    # the product alone, on windows gathered beforehand: not K7's function
    # (the gather is left out), so it is logged and not the library time
    blk = rows.view(n_blk, gs, d)[wblk.long()].view(nq, win * gs, d).to(
        torch.bfloat16)
    q_bf = q.to(torch.bfloat16)[:, :, None]
    bmm = _time_ms(lambda: torch.bmm(blk, q_bf), 20)
    del blk
    log(f"[{tag}] K7 gather_rescore {what}: max|Δ| {err:.3g}, "
        f"kernel {ms:.4f} ms ({nbytes / (ms * 1e6):.0f} GB/s, "
        f"{100 * bound[0] / ms:.1f}% of the bound), plain {plain:.3f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]}); bf16 bmm of the windows gathered "
        f"beforehand {bmm:.4f} ms")
    return _entry(name, "vaq_tpu_torch/csrc/gather_rescore.cu",
                  "vaq_tpu/ops/rescore_pallas.py:" + ("39" if d % 128 else "105"),
                  err, ms, plain, bound, None)


def _check_fast4(rng, shape, int8: bool, rounding: str) -> dict:
    """K3 (f32 LUT) or K4 (s8 LUT) against its plain version, in the form
    the wrapper's shape rule picks (``scan_codes._fast4_form``). K4's keys,
    and K3's in the gather form or where the tensor cores add to nearest
    (``rounding``), must equal the plain version's bit for bit; otherwise
    K3 is held by ``kernel_check.k3_check``: scores within 1e-5 +
    2^(idx_bits − 23) relative, and a window's winner differs only where
    the two rows' sums agree to that in f64. The
    library yardstick multiplies a one-hot of the codes (built outside the
    timing) by the LUT on the tensor cores: bf16 ``matmul`` for K3,
    ``_int_mm`` for K4. The bound counts that one-hot form (2·nq·n·M·C
    operations) against the bytes of codes, LUT and keys."""
    from vaq_tpu_torch.ops import kernel_check, scan_codes
    dev = torch.device(DEVICE)
    n, m, c, nq, br = shape
    n_pad = n + (-n) % (scan_codes.W_PER_CELL * br)
    n_win = n_pad // br
    codes = torch.as_tensor(rng.integers(0, c, (n, m), dtype=np.uint8), device=dev)
    if int8:
        luts = torch.as_tensor(rng.integers(-128, 128, (nq, m, c), dtype=np.int8),
                               device=dev)
    else:
        luts = torch.as_tensor((rng.random((nq, m, c)) * 4.0).astype(np.float32),
                               device=dev)
    form = scan_codes._fast4_form(m, c, int8, nq, br).kind
    s_k, i_k = scan_codes.fast4_window_scan(codes, luts, br, n_win)
    s_r, i_r = scan_codes.fast4_window_scan_ref(codes, luts, br, n_win)
    torch.cuda.synchronize()
    name = "K4" if int8 else "K3"
    assert s_k.shape == (nq, n_win), (name, s_k.shape)
    if int8 or form == "gather" or rounding == "nearest":
        assert torch.equal(s_k, s_r) and torch.equal(i_k, i_r), \
            f"{name} keys differ from the plain version at {shape}"
        check = "keys equal"
    else:
        ok, detail = kernel_check.k3_check(codes, luts, br, (s_k, i_k),
                                           (s_r, i_r))
        assert ok, f"K3 at {shape}: {detail}"
        check = (f"scores within {kernel_check.k1_rtol(br):.3g} "
                 f"({detail['max_err_over_tol']:.3g} of it), "
                 f"{detail['id_mismatches']} id ties of {i_k.numel()}, "
                 f"max|Δscore| {float((s_k - s_r).abs().max()):.3g}")
    err = float((s_k.double() - s_r.double()).abs().max())
    ms = _time_ms(lambda: scan_codes.fast4_window_scan(codes, luts, br, n_win), 10)
    plain = _time_ms(lambda: scan_codes.fast4_window_scan_ref(codes, luts, br, n_win), 3)
    # the one-hot of the codes, (n_pad, M·C), padded rows all zero
    hot = torch.zeros((n_pad, m * c), dtype=torch.int8 if int8 else torch.bfloat16,
                      device=dev)
    hot[:n].scatter_(1, codes.long() + torch.arange(m, device=dev) * c, 1)
    lut_t = luts.reshape(nq, m * c).T      # (M·C, nq), column-major
    if int8:
        library = _time_ms(lambda: torch._int_mm(hot, lut_t), 10)
    else:
        lut_bf = lut_t.to(torch.bfloat16).contiguous()
        library = _time_ms(lambda: torch.matmul(hot, lut_bf), 10)
    del hot
    ops = 2.0 * nq * n_pad * m * c
    nbytes = n_pad * m + luts.numel() * luts.element_size() + nq * n_win * 4
    bound = _bound(nbytes, ops, "int8" if int8 else "bf16")
    log(f"[kernels] {name} fast4_window_scan n={n} M={m} C={c} nq={nq} br={br}, "
        f"{form} form: {check}, kernel {ms:.3f} ms ({ops / ms / 1e9:.1f} "
        f"{'TOP' if int8 else 'TFLOP'}/s, {100 * bound[0] / ms:.1f}% of the bound), "
        f"plain {plain:.3f} ms, {'_int_mm' if int8 else 'bf16 matmul'} of the "
        f"one-hot {library:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    entry = _entry("fast4_window_scan" + ("_int8" if int8 else "")
                   + ("" if c == 16 else f"_c{c}"),
                   "vaq_tpu_torch/csrc/fast4_window_scan.cu",
                   "vaq_tpu/ops/scan_pallas.py:" + ("155" if int8 else "123"),
                   err, ms, plain, bound, library)
    entry["form"] = form
    return entry


def _check_k1(rng, shape) -> tuple[dict, torch.Tensor]:
    """K1 on seeded codes, centroids and queries at one 1M shape (n, M, C,
    L, nq, block_rows), held against its plain version by :func:`_held_k1`.
    Returns the entry and the window scores."""
    from vaq_tpu_torch.ops import scan_codes
    dev = torch.device(DEVICE)
    n, m, c, l, nq, br = shape
    cents = rng.standard_normal((m, c, l)).astype(np.float32)
    codes = torch.as_tensor(rng.integers(0, c, (n, m), dtype=np.uint8), device=dev)
    qp = torch.as_tensor(rng.standard_normal((nq, m * l)).astype(np.float32),
                         device=dev)
    table = scan_codes.build_decode_table(cents, dev)
    return _held_k1(codes, table, qp, br, _k1_name(shape))[:2]


def _k1_name(shape) -> str:
    """The kernels-line name of K1's check at ``shape``."""
    _, m, c, _, nq, br = shape
    return ("decode_window_scan" + (f"_c{c}" if c != KC_C else
                                    f"_m{m}" if m != KC_M else "")
            + ("" if br == KC_BR else f"_br{br}")
            + ("" if nq == KC_NQ else f"_q{nq}"))


def _held_k1(codes, table, qp, br: int, name: str, tag: str = "kernels",
             library: bool = True, reps: int = 20, plain_reps: int = 3,
             of_terms: bool = False) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """K1 against its plain version on the given inputs by
    ``kernel_check.k1_check``: scores within 1e-5 + 2^(idx_bits − 23)
    relative, and ids differing only where the two rows tie to that in f64
    (the tensor cores sum the dot in another order, and the key keeps
    23 − idx_bits mantissa bits), on at most 1% of the windows. Relative to
    the score on seeded data, where a window's minimum is of the size of
    its terms; with ``of_terms``, relative to the size of the terms summed
    (``kernel_check.k1_terms``), as K5/K7 are held: on a real index a
    query's near rows score far below their norms, and f32 sums in another
    order differ by a fraction of the terms, not of the score. The library yardstick
    (``library``) is one bf16 GEMM of the queries against the decoded rows
    (decoded outside the timing). Returns the entry, the window scores and
    their row ids."""
    from vaq_tpu_torch.ops import kernel_check, scan_codes
    dev = codes.device
    n, m = codes.shape
    c, d = table.shape
    l, nq = d // m, qp.shape[0]
    s_k, i_k = scan_codes.decode_window_scan(codes, table, qp, br)
    s_r, i_r = scan_codes.decode_window_scan_ref(codes, table, qp, br)
    torch.cuda.synchronize()
    assert s_k.shape == (nq, -(-n // br)) and torch.isfinite(s_k).all(), name
    ok, detail = kernel_check.k1_check(codes, table, qp, (s_k, i_k),
                                       (s_r, i_r), br, of_terms=of_terms)
    assert ok, f"K1 {name}: {detail}"
    err = float((s_k - s_r).abs().max())
    rel = float(((s_k - s_r).abs() / s_r.abs().clamp_min(1e-30)).max())
    of = (f" ({detail['max_err_over_tol']:.3g} of the tolerance on the "
          "terms)" if of_terms else "")
    ties = detail["id_mismatches"]
    del s_r, i_r
    ms = _time_ms(lambda: scan_codes.decode_window_scan(codes, table, qp, br),
                  reps)
    plain = _time_ms(lambda: scan_codes.decode_window_scan_ref(codes, table, qp, br),
                     plain_reps)
    lib_ms = None
    if library:
        dec = table.view(c, m, l)[codes.long(), torch.arange(m, device=dev)]
        dec_t = dec.reshape(n, d).T
        q_bf = qp.to(torch.bfloat16)
        lib_ms = _time_ms(lambda: torch.matmul(q_bf, dec_t), 10)
        del dec, dec_t
    ops = 2.0 * nq * n * d
    bound = _bound(n * m + table.numel() * 2 + qp.numel() * 4 + s_k.numel() * 4,
                   ops, "bf16")
    log(f"[{tag}] K1 decode_window_scan n={n} M={m} C={c} L={l} nq={nq} br={br}: "
        f"max|Δscore| {err:.3g}, {rel:.3g} of the score{of}, {ties} id "
        f"ties of {i_k.numel()}, kernel "
        f"{ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s, {100 * bound[0] / ms:.1f}% "
        f"of the bound), plain {plain:.3f} ms, "
        + (f"bf16 matmul {lib_ms:.3f} ms, " if lib_ms is not None else "")
        + f"bound {bound[0]:.4f} ms ({bound[1]})")
    return _entry(name, "vaq_tpu_torch/csrc/decode_window_scan.cu",
                  "vaq_tpu/ops/scan_pallas.py:283", err, ms, plain, bound,
                  lib_ms), s_k, i_k


def _held_k2(codes, cand, rows, qp, name: str, tag: str = "kernels") -> dict:
    """K2 against its plain version: +inf exactly where the id is −1 or
    past n, finite elsewhere, and within 1e-5 relative."""
    from vaq_tpu_torch.ops import scan_codes
    n, m = codes.shape
    d = rows.shape[1]
    o_k = scan_codes.decode_rescore(codes, cand, rows, qp)
    o_r = scan_codes.decode_rescore_ref(codes, cand, rows, qp)
    torch.cuda.synchronize()
    valid = (cand >= 0) & (cand < n)
    assert torch.isinf(o_k[~valid]).all() and torch.isfinite(o_k[valid]).all(), name
    torch.testing.assert_close(o_k, o_r, rtol=RTOL_KERNEL, atol=1e-5)
    err = float((o_k[valid] - o_r[valid]).abs().max())
    ms = _time_ms(lambda: scan_codes.decode_rescore(codes, cand, rows, qp), 20)
    plain = _time_ms(lambda: scan_codes.decode_rescore_ref(codes, cand, rows, qp), 5)
    n_cand = cand.numel()
    nbytes = n_cand * (m + 4 + 4) + rows.numel() * 4 + qp.numel() * 4
    bound = _bound(nbytes, 3.0 * n_cand * d, "f32")
    log(f"[{tag}] K2 decode_rescore n={n} M={m} d={d} {tuple(cand.shape)} "
        f"candidates: max|Δ| {err:.3g}, kernel {ms:.4f} ms "
        f"({nbytes / (ms * 1e6):.0f} GB/s, {100 * bound[0] / ms:.1f}% of the "
        f"bound), plain {plain:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return _entry(name, "vaq_tpu_torch/csrc/decode_rescore.cu",
                  "vaq_tpu/ops/scan_pallas.py:477", err, ms, plain, bound, None)


def _held_h1(q, x, op: str, name: str, tag: str = "kernels") -> dict:
    """H1 against its plain version on the given words: bit-equal. Timed
    beside its bound (the popcounts over the card's popc rate, or the words
    read and the output written over the memory rate) and beside the
    library form: the words unpacked to int8 0/1 (outside the timing), one
    ``torch._int_mm`` and ``pop(q) + pop(x) − 2·inner`` (Jaccard: the same
    counts through JAX's f32 expression), which must equal H1 too."""
    from vaq_tpu_torch.binary import _unpack_words
    from vaq_tpu_torch.ops import hamming
    b, nq, w = q.shape
    n = x.shape[1]
    got = hamming.popcount_dists(q, x, op)
    ref = hamming.popcount_dists_ref(q, x, op)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), f"H1 {name}: differs from its plain version"
    err = float((got.double() - ref.double()).abs().max())
    del ref
    ms = _time_ms(lambda: hamming.popcount_dists(q, x, op), 10)
    plain = _time_ms(lambda: hamming.popcount_dists_ref(q, x, op), 2)
    lib_ms = None
    if b == 1:
        q01 = _unpack_words(q[0], w * 32)
        x01 = _unpack_words(x[0], w * 32)
        q_pop = q01.sum(1, dtype=torch.int32)[:, None]
        x_pop = x01.sum(1, dtype=torch.int32)[None, :]

        def library():
            inner = torch._int_mm(q01, x01.T)
            if op == "xor":
                return q_pop + x_pop - 2 * inner
            return hamming.jaccard_from_counts(inner, q_pop + x_pop - inner)

        assert torch.equal(library()[None], got), f"H1 {name}: _int_mm form"
        lib_ms = _time_ms(library, 5)
        del q01, x01
    pairs = b * nq * n
    ops = pairs * w + (b * (nq + n) * w if op == "jaccard" else 0)
    bound = _bound(b * (nq + n) * w * 4 + pairs * 4, ops, "popc")
    log(f"[{tag}] H1 popcount_dists {op} B={b} nq={nq} n={n} W={w}: bit-equal "
        f"to its plain version, kernel {ms:.3f} ms ({ops / ms / 1e9:.2f}e12 "
        f"popc/s, {100 * bound[0] / ms:.1f}% of the "
        f"bound at {_popc_per_s() / 1e12:.2f}e12 popc/s), plain {plain:.3f} ms, "
        + (f"_int_mm form {lib_ms:.3f} ms, " if lib_ms is not None else "")
        + f"bound {bound[0]:.4f} ms ({bound[1]})")
    return _entry(name, "vaq_tpu_torch/csrc/hamming_scan.cu",
                  "vaq_tpu/binary.py:121", err, ms, plain, bound, lib_ms)


def _held_d1(gen, shape=KD1_SHAPE, name: str = "decoded_topk_scan",
             tag: str = "kernels") -> dict:
    """D1 against the plain blocked scan on seeded bf16 rows: its splits'
    keys merged, then ``kernel_check.d1_check``. Timed beside its bound
    (the products at the bf16 peak, or the rows, norms and queries read
    and the keys written), the plain scan (``scan_decoded._scan_topk``)
    and a bf16 ``torch.mm`` then ``torch.topk`` of the kk lowest (timed
    only: it picks another set among ties)."""
    from vaq_tpu_torch.ops import kernel_check, scan_decoded
    n, d, nq, k = shape
    dev = torch.device(DEVICE)
    rows = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
    norms = torch.sum(rows.float() ** 2, dim=1)
    q = torch.randn((nq, d), generator=gen, device=dev).to(torch.bfloat16)
    kk = min(max(2 * k, k + 16), n)
    keys = scan_decoded.decoded_topk_scan(rows, norms, q, kk)
    got = scan_decoded._lowest_split_keys(keys, kk)
    want = scan_decoded._scan_topk(rows, norms, q.float(), kk)
    ok, detail = kernel_check.d1_check(rows, norms, q, got, want)
    assert ok, f"D1 {name}: {detail}"
    ms = _time_ms(lambda: scan_decoded.decoded_topk_scan(rows, norms, q, kk), 20)
    merge = _time_ms(lambda: scan_decoded._lowest_split_keys(keys, kk), 20)
    plain = _time_ms(lambda: scan_decoded._scan_topk(rows, norms, q.float(), kk), 3)
    library = _time_ms(lambda: torch.topk(norms[None, :] - 2.0 * torch.mm(q, rows.T).float(),
                                          kk, dim=1, largest=False), 5)
    nbytes = rows.numel() * 2 + n * 4 + q.numel() * 2 + keys.numel() * 8
    bound = _bound(nbytes, 2.0 * nq * n * d, "bf16")
    log(f"[{tag}] D1 decoded_topk_scan n={n} d={d} nq={nq} kk={kk} "
        f"{tuple(keys.shape)} keys: {detail}, kernel {ms:.4f} ms "
        f"({2.0 * nq * n * d / (ms * 1e9):.0f} TFLOP/s, {100 * bound[0] / ms:.1f}% of the "
        f"bound), the splits' merge {merge:.4f} ms, plain {plain:.3f} ms, "
        f"bf16 mm + topk {library:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    # the error is d1_check's: the largest f64 excess, over its tolerance,
    # of a row one side holds beyond the other side's kk-th (0 where every
    # query holds the same ids)
    entry = _entry(name, "vaq_tpu_torch/csrc/decoded_topk_scan.cu",
                   "none (XLA's GEMM and approx_max_k, vaq_tpu/ops/scan_decoded.py:48-76)",
                   detail.get("max_excess_over_tol", 0.0), ms, plain, bound, library)
    entry["queries_differing"] = detail["queries_differing"]
    return entry


def _time_selection(scores: torch.Tensor, k: int) -> None:
    """The tie-exact selection (``scan_codes._select_lowest``) and each of
    its forms beside ``torch.topk`` on one (nq, width) score matrix; all
    must give the helper's positions."""
    from vaq_tpu_torch.ops import scan_codes
    bits = scan_codes._ordered(scores)
    want = scan_codes._select_lowest(scores, k)[1]
    times = {"helper": _time_ms(lambda: scan_codes._select_lowest(scores, k), 20)}
    for form, fn in (("stable sort", scan_codes._lowest_sorted),
                     ("topk of (score, position)", scan_codes._lowest_keyed)):
        assert torch.equal(fn(bits, k), want), f"{form} differs"
        times[form] = _time_ms(lambda: fn(bits, k), 20)
    times["torch.topk"] = _time_ms(
        lambda: torch.topk(scores, k, dim=1, largest=False, sorted=True), 20)
    log(f"[kernels] select lowest {k} of {tuple(scores.shape)}: "
        + ", ".join(f"{f} {t:.4f} ms" for f, t in times.items()))


def _time_block_selection(gen, nq: int = KC_NQ, kk: int = 200,
                          block: int = 65536, n_blocks: int = 16) -> None:
    """The decoded tier's selection of one 512-query batch at 1M rows (16
    blocks of 65,536 columns, kk = 200) three ways: ``lowest_over_blocks``
    (each block's ``torch.topk`` of kk + TIE_SLACK, the check, one final
    sort), its tie-exact form (each block through ``_select_lowest``, as it
    runs where a tie group outruns the margin), and the parent's running
    merge (``torch.topk`` of the carried best and each block, not
    tie-exact). The first two must agree."""
    from vaq_tpu_torch.ops import distances, scan_codes
    dev = torch.device(DEVICE)
    scores = torch.randn((n_blocks, nq, block), generator=gen, device=dev)

    def blocks():
        return ((scores[i], i * block) for i in range(n_blocks))

    def exact():
        vals, ids = zip(*(scan_codes._select_lowest(scores[i], kk) for i in range(n_blocks)))
        v = torch.cat(vals, 1)
        i = torch.cat([p.to(torch.int32) + n * block for n, p in enumerate(ids)], 1)
        key = (scan_codes._ordered(v).to(torch.int64) << 32) | (i.to(torch.int64) + 1)
        order = torch.sort(key, dim=1).indices[:, :kk]
        return torch.gather(v, 1, order), torch.gather(i, 1, order)

    def running_merge():
        best_d = torch.empty((nq, 0), device=dev)
        best_i = torch.empty((nq, 0), dtype=torch.int32, device=dev)
        for n in range(n_blocks):
            cand_d = torch.cat([best_d, scores[n]], 1)
            cand_i = torch.cat([best_i, torch.arange(n * block, (n + 1) * block, dtype=torch.int32,
                                                     device=dev).expand(nq, -1)], 1)
            best_d, pos = torch.topk(cand_d, kk, dim=1, largest=False, sorted=True)
            best_i = torch.gather(cand_i, 1, pos)
        return best_d, best_i

    got = distances.lowest_over_blocks(blocks, kk)
    want = exact()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    times = {"lowest_over_blocks": _time_ms(lambda: distances.lowest_over_blocks(blocks, kk), 10),
             "tie-exact blocks": _time_ms(exact, 10),
             "running torch.topk merge (parent)": _time_ms(running_merge, 10)}
    del scores
    log(f"[kernels] decoded-tier selection, {n_blocks} blocks of {nq} × {block}, kk = {kk}: "
        + ", ".join(f"{f} {t:.4f} ms" for f, t in times.items()))


def phase_kernels() -> list[dict]:
    """Every kernel against its plain version on the card."""
    from vaq_tpu_torch.ops import scan_codes
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    kernels = []
    for shape in K1_SHAPES:
        entry, scores = _check_k1(rng, shape)
        kernels.append(entry)
        if shape == K1_SHAPES[0]:
            # on K1's window scores, at the widths the port selects from
            wide = torch.cat([scores] * 5, dim=1)
            for width, k in SELECT_WIDTHS:
                _time_selection(wide[:, :width].contiguous(), k)
            del wide
        del scores
        torch.cuda.empty_cache()
    d = KC_M * KC_L
    cents = rng.standard_normal((KC_M, KC_C, KC_L)).astype(np.float32)
    codes = torch.as_tensor(rng.integers(0, KC_C, (KC_N, KC_M), dtype=np.uint8),
                            device=dev)
    qp = torch.as_tensor(rng.standard_normal((KC_NQ, d)).astype(np.float32),
                         device=dev)
    rows = scan_codes.build_decode_rows(cents, dev)

    # K2
    cand = torch.as_tensor(rng.integers(0, KC_N, (KC_NQ, KC_KK), dtype=np.int32),
                           device=dev)
    cand[:, -3:] = -1
    kernels.append(_held_k2(codes, cand, rows, qp, "decode_rescore"))
    del codes
    # K2 at the ScalarLUTIndex shape (M' = 57, L = 1), the same candidates
    cents57 = rng.standard_normal((LUT_M, KC_C, 1)).astype(np.float32)
    codes57 = torch.as_tensor(rng.integers(0, KC_C, (KC_N, LUT_M), dtype=np.uint8),
                              device=dev)
    qp57 = torch.as_tensor(rng.standard_normal((KC_NQ, LUT_M)).astype(np.float32),
                           device=dev)
    kernels.append(_held_k2(codes57, cand, scan_codes.build_decode_rows(cents57, dev),
                            qp57, f"decode_rescore_m{LUT_M}"))
    del codes57, cand
    # H1 at the flat scan's shape (xor and jaccard) and at the probe's block
    words = rng.integers(0, 2 ** 32, (KC_N + KC_NQ, KH_W), dtype=np.uint32)
    x = torch.as_tensor(words[:KC_N].view(np.int32), device=dev)[None]
    q = torch.as_tensor(words[KC_N:].view(np.int32), device=dev)[None]
    kernels.append(_held_h1(q, x, "xor", "popcount_dists"))
    kernels.append(_held_h1(q, x, "jaccard", "popcount_dists_jaccard"))
    del x, q
    cb, qcap, cap = KH_PROBE
    words = rng.integers(0, 2 ** 32, (cb, qcap + cap, KH_W), dtype=np.uint32)
    kernels.append(_held_h1(
        torch.as_tensor(words[:, :qcap].view(np.int32), device=dev),
        torch.as_tensor(words[:, qcap:].view(np.int32), device=dev), "xor",
        "popcount_dists_probe"))
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels.append(_held_d1(gen))
    torch.cuda.empty_cache()
    for shape in KD1_MAIN_SHAPES:
        kernels.append(_held_d1(gen, shape, f"decoded_topk_scan_k{shape[3]}"))
        torch.cuda.empty_cache()
    _time_block_selection(gen)
    for d_k, dtype in ((D_MAIN, "int8"), (96, "int8"), (D_MAIN, "bf16")):
        kernels.append(_check_groupmin(gen, d_k, dtype))
        torch.cuda.empty_cache()
    # partly filled slots, as the dispatch leaves them at visit 0.1, the
    # qcap of visit 1.0 (pick_qcap gives nq = 512 there), and [bench]'s
    # 1024-query batch at visit 0.1, all slots occupied and as dispatched
    for qcap, mean in ((KC_QCAP, KC_SLOTS_MEAN), (KC_QCAP_FULL, None),
                       (BENCH_QCAP, None), (BENCH_QCAP, BENCH_SLOTS)):
        kernels.append(_check_groupmin(gen, D_MAIN, "int8", qcap, mean))
        torch.cuda.empty_cache()
    for d_k, dtype in ((D_MAIN, "int8"), (96, "int8"), (D_MAIN, "bf16")):
        kernels.append(_check_rescore(gen, d_k, dtype))
        torch.cuda.empty_cache()
    kernels.append(_check_rescore(gen, D_MAIN, "int8", BENCH_NQ, BENCH_WIN,
                                  suffix=f"_q{BENCH_NQ}_w{BENCH_WIN}"))
    torch.cuda.empty_cache()
    # the 100M probe's shapes ([deep100m]): 102,400-row buckets, gs = 256
    kernels.append(_check_groupmin(gen, DEEP_D, "int8", KD_QCAP, KD_SLOTS,
                                   KD_NCL, KD_CAP, KD_GS))
    torch.cuda.empty_cache()
    kernels.append(_check_rescore(gen, DEEP_D, "int8", DEEP_NQ, KD_WIN, KD_GS,
                                  KD_NCL, KD_CAP))
    torch.cuda.empty_cache()
    rounding = scan_codes.k3_accumulation_rounding(dev)
    log(f"[kernels] K3's tensor-core form: wgmma adds each k step to its f32 "
        f"accumulator rounding {rounding}")
    for shape in KF_SHAPES:
        for int8 in (False, True):
            kernels.append(_check_fast4(rng, shape, int8, rounding))
            torch.cuda.empty_cache()
    return kernels


def _step(name: str, fn, nq: int | None = None, tag: str = "main"):
    """Run one path step; log its time, QPS and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() / 2**20
    qps = f", {nq / dt:.0f} QPS" if nq else ""
    log(f"[{tag}] {name}: {dt:.3f} s{qps}, peak {mem:.0f} MiB")
    return out


def _batch_wall_ms(fn, reps: int = 9) -> float:
    """Median host milliseconds of one unprofiled call of ``fn`` ended by a
    device synchronize, over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def phase_main_path() -> tuple[dict, dict]:
    """The codes path; returns K1/K2's launches and what the IVF path
    reuses (the index, its data, the groundtruth, the decoded recall)."""
    import vaq_tpu_torch as vt
    from vaq_tpu_torch import data, metrics
    from vaq_tpu_torch.ops import distances, scan_codes, scan_decoded
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    base, queries = data.make_anisotropic_gaussian(N_MAIN, D_MAIN, NQ_MAIN,
                                                   seed=SEED)
    log(f"[main] data {base.shape} + {queries.shape[0]} queries: "
        f"{time.perf_counter() - t0:.1f} s (host)")
    gt_d, gt = _step("groundtruth@100 (exact_search)", lambda: distances.exact_search(
        torch.as_tensor(queries, device=dev), torch.as_tensor(base, device=dev), 100),
        NQ_MAIN)
    gt = gt.cpu().numpy()

    idx = vt.VAQIndex(vt.parse_method_string(METHOD), device=dev)
    _step("train", lambda: idx.train(base, verbose=True))
    log(f"[main] bits {idx.bits.tolist()}")
    _step("encode", lambda: idx.encode(base))
    scan_codes.decode_window_scan.launches = 0
    scan_codes.decode_rescore.launches = 0
    scan_decoded.decoded_topk_scan.launches = 0
    _step("search decoded k=100 (first call builds the decoded db)",
          lambda: idx.search(queries, 100, backend="decoded"), NQ_MAIN)
    _, l_dec = _step("search decoded k=100",
                     lambda: idx.search(queries, 100, backend="decoded"), NQ_MAIN)
    _step("search codes k=100 (first call)",
          lambda: idx.search(queries, 100, backend="codes"), NQ_MAIN)
    d_cod, l_cod = _step("search codes k=100",
                         lambda: idx.search(queries, 100, backend="codes"), NQ_MAIN)
    _, cand = _step("search k=200", lambda: idx.search(queries, 200), NQ_MAIN)
    d_ref, l_ref = _step("refine 200->100",
                         lambda: idx.refine(queries, cand, base, 100), NQ_MAIN)
    launches = {"decode_window_scan": scan_codes.decode_window_scan.launches,
                "decode_rescore": scan_codes.decode_rescore.launches,
                "decoded_topk_scan": scan_decoded.decoded_topk_scan.launches}
    log(f"[main] kernel launches during the main path: {launches}")
    _profile_split("main", "codes", lambda: idx.search(queries[:512], 100,
                                                     backend="codes"), ())
    # the codes tier at k = 200 takes 64-row windows: K1's third checked shape
    assert idx._codes_block_rows(200) == K1_SHAPES[2][5]
    scan_codes.decode_window_scan.launches = 0
    _step("search codes k=200 (64-row windows)",
          lambda: idx.search(queries, 200, backend="codes"), NQ_MAIN)
    launches["decode_window_scan_br64"] = scan_codes.decode_window_scan.launches
    log(f"[main] codes k=200: K1 launches {launches['decode_window_scan_br64']}")

    r_dec = metrics.avg_recall(l_dec, gt, 100)
    r_cod = metrics.avg_recall(l_cod, gt, 100)
    r_ref = metrics.avg_recall(l_ref, gt, 100)
    top1 = float((l_dec[:, 0] == l_cod[:, 0]).mean())
    log(f"[main] avg_recall@100 decoded {r_dec:.4f}, codes {r_cod:.4f}, "
        f"refined {r_ref:.4f}; recall@100 (true NN in top 100) refined "
        f"{metrics.recall_at_r(l_ref, gt, 100):.4f}; codes/decoded top-1 "
        f"agreement {top1:.4f} (block_rows {idx._codes_block_rows(100)})")
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
    assert l_cod.shape == (NQ_MAIN, 100) and np.isfinite(d_cod).all()
    assert np.isfinite(d_ref).all() and (l_ref >= 0).all()
    assert top1 >= 0.9, top1
    assert r_ref >= r_dec, (r_ref, r_dec)
    return launches, {"idx": idx, "base": base, "queries": queries, "gt": gt,
                      "r_dec": r_dec, "l_dec": l_dec}


def _device_split(prof, names) -> tuple[dict, float]:
    """(device ms of the kernels and copies inside each profiler range, as
    the ranges' spans on the device timeline place them, plus "other" for
    the rest; the device's busy ms). The ranges' own device spans include
    the gaps between their kernels, so they are not summed themselves."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(ev.name, ev.time_range.start, ev.time_range.end)
             for ev in prof.events() if ev.device_type == cuda and ev.name in names]
    out = {n: 0.0 for n in (*names, "other")}
    for ev in prof.events():
        if ev.device_type != cuda or ev.name in names:
            continue
        stage = next((n for n, t0, t1 in spans
                      if t0 <= ev.time_range.start < t1), "other")
        out[stage] += ev.time_range.elapsed_us() / 1e3
    return out, sum(out.values())


def _profile_split(tag: str, what: str, fn, stages, reps: int = 9) -> None:
    """One call of ``fn`` (a search batch) under ``torch.profiler``: the
    device ms inside each of the profiler ranges ``stages`` and the rest,
    the device's busy time and its share of the unprofiled batch wall (the
    median of ``reps`` calls; the profiler slows the host), and the device
    time by kernel."""
    wall = _batch_wall_ms(fn, reps)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    split, busy = _device_split(prof, stages)
    log(f"[{tag}] {what}, one batch: wall {wall:.3f} ms unprofiled "
        f"({prof_wall:.3f} ms under the profiler), device busy {busy:.3f} ms "
        f"({100 * busy / wall:.1f}% of the unprofiled wall); device ms by stage "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    log(f"[{tag}] top device ops:\n" + prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=12))


def _dispatch_counts(idx, queries, k: int) -> tuple[int, int]:
    """(active, dispatched) (query, cluster) entries of one probe batch: the
    static qcap drops the difference (vaq_tpu/ops/probe.py:139-144)."""
    from vaq_tpu_torch import pca
    from vaq_tpu_torch.ops import probe
    st = idx.ivf.state
    p_visit, p_max, qcap, _ = idx.ivf.params(k, len(queries))
    qp = pca.project(torch.as_tensor(queries, device=DEVICE), idx._eigvecs_device())
    cents = torch.as_tensor(st.centroids, device=DEVICE)
    cd = probe.cluster_sq_dists(qp[:, :st.seg_dims], cents)
    pr, active = probe.dynamic_probe(cd, st.sizes, k, p_visit, p_max)
    _, ok, _, _ = probe.dispatch_table(pr, active, st.ncl, min(qcap, len(queries)))
    return int(active.sum()), int(ok.sum())


def phase_ivf_path(ctx: dict) -> dict:
    """The TI/IVF path on the 1M index; returns K5/K7's launches."""
    from vaq_tpu_torch import ivf, metrics
    from vaq_tpu_torch.ops import probe_scan, rescore
    idx, queries, gt = ctx["idx"], ctx["queries"], ctx["gt"]
    probe_scan.groupmin_window_scan.launches = 0
    rescore.gather_rescore.launches = 0
    _step(f"attach_ivf ({TI_CLUSTERS} clusters over {TI_SEGMENTS} subspaces)",
          lambda: ivf.attach_ivf(idx, verbose=True, ti_cluster_num=TI_CLUSTERS,
                                 ti_segment_num=TI_SEGMENTS))
    assert idx.config.ti_cluster_num == -1  # the overrides leave it as it was
    recalls = {}
    for visit in VISITS:
        idx.ivf.visit = visit
        p = idx.ivf.params(100, 512)
        _step(f"search ivf visit={visit} k=100 (first call)",
              lambda: idx.search(queries, 100, backend="ivf"), NQ_MAIN)
        d_ivf, l_ivf = _step(f"search ivf visit={visit} k=100 "
                             f"(p_visit, p_max, qcap, gs) = {p}",
                             lambda: idx.search(queries, 100, backend="ivf"),
                             NQ_MAIN)
        assert (l_ivf >= 0).all() and np.isfinite(d_ivf).all(), visit
        recalls[visit] = metrics.avg_recall(l_ivf, gt, 100)
        active, dispatched = _dispatch_counts(idx, queries[:512], 100)
        log(f"[ivf] visit={visit}: avg_recall@100 {recalls[visit]:.4f}; first "
            f"batch: {dispatched} of {active} (query, cluster) entries "
            f"dispatched, {active - dispatched} dropped by qcap = {p[2]}")
    launches = {"groupmin_window_scan": probe_scan.groupmin_window_scan.launches,
                "gather_rescore": rescore.gather_rescore.launches}
    log(f"[ivf] kernel launches during the IVF path: {launches}")
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the IVF path"
    gap = abs(recalls[1.0] - ctx["r_dec"])
    log(f"[ivf] visit 1.0 vs decoded avg_recall@100: {recalls[1.0]:.4f} vs "
        f"{ctx['r_dec']:.4f} (|Δ| {gap:.4f})")
    assert gap < 0.03, (recalls[1.0], ctx["r_dec"])

    # the stage split of one 512-query batch at visit 0.1
    idx.ivf.visit = 0.10
    qb = queries[:512]
    _profile_split("ivf", "visit 0.1", lambda: idx.search(qb, 100, backend="ivf"),
                   ("ivf.probe", "ivf.groupmin", "ivf.merge", "ivf.rescore",
                    "ivf.second_stage"))

    d8, l8 = _step("search decoded8 k=100 (first call builds the int8 db)",
                   lambda: idx.search(queries, 100, backend="decoded8"), NQ_MAIN)
    d8, l8 = _step("search decoded8 k=100",
                   lambda: idx.search(queries, 100, backend="decoded8"), NQ_MAIN)
    r8 = metrics.avg_recall(l8, gt, 100)
    log(f"[ivf] decoded8 avg_recall@100 {r8:.4f}")
    assert np.isfinite(d8).all() and (l8 >= 0).all()
    assert abs(r8 - ctx["r_dec"]) < 0.03, (r8, ctx["r_dec"])
    return launches


def _check_answers(d, i, ref_d, ref_i, rtol: float, what: str) -> int:
    """Served (or sharded) answers against the reference's for the same
    rows: distances elementwise within ``rtol`` relative (+1e-5), ids equal
    as sets among the entries strictly inside each row's k-th distance less
    that tolerance (entries tied with the boundary may differ). Returns the
    rows whose ids differ anywhere (a near tie swapped)."""
    d, i, ref_d, ref_i = map(np.asarray, (d, i, ref_d, ref_i))
    assert d.shape == ref_d.shape and i.shape == ref_i.shape, what
    assert np.isfinite(d).all() and (i >= 0).all(), what
    np.testing.assert_allclose(d, ref_d, rtol=rtol, atol=1e-5, err_msg=what)
    edge = ref_d[:, -1:]
    inside = ref_d < edge - (rtol * np.abs(edge) + 1e-5)
    for q in np.flatnonzero((i != ref_i).any(axis=1)):
        assert set(i[q][inside[q]]) == set(ref_i[q][inside[q]]), (what, q)
    return int((i != ref_i).any(axis=1).sum())


def _check_no_worse(d, i, ref_d, ref_i, rtol: float, what: str
                    ) -> tuple[int, int]:
    """A sharded tier that rescores a superset of the unsharded tier's
    candidates (2k or more a shard where one device rescores 2k in all):
    every distance, rank by rank, at most the unsharded one (+ ``rtol``
    relative and 1e-5), ids valid. Returns (rows whose ids differ, rows
    with a distance strictly lower)."""
    d, i, ref_d, ref_i = map(np.asarray, (d, i, ref_d, ref_i))
    assert d.shape == ref_d.shape and np.isfinite(d).all(), what
    assert (i >= 0).all(), what
    assert (d <= ref_d + rtol * np.abs(ref_d) + 1e-5).all(), what
    lower = (d < ref_d - (rtol * np.abs(ref_d) + 1e-5)).any(axis=1)
    return int((i != ref_i).any(axis=1).sum()), int(lower.sum())


def _closed_loop(srv, queries, rows_of, n_requests: int, threads: int
                 ) -> list:
    """``threads`` clients, each submitting its share of the ``n_requests``
    requests one after another (closed loop); request r asks for the rows
    ``rows_of(r)`` of ``queries``. Returns (rows, distances, labels) per request; a
    failed future fails the run."""
    out = [None] * n_requests

    def client(t):
        for r in range(t, n_requests, threads):
            rows = rows_of(r)
            d, i = srv.submit(queries[rows]).result(120)
            out[r] = (rows, d, i)

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        for f in [pool.submit(client, t) for t in range(threads)]:
            f.result()
    return out


def _reset_server(srv) -> None:
    with srv._lock:
        srv.stats.reset()
        srv.batches_served = srv.queries_served = srv.sum_fill = 0
        srv.sum_fetch_s = 0.0


def _open_loop(srv, queries, rate: float, ref, rtol: float, what: str
               ) -> tuple[float, float, float]:
    """``bench.py``'s ``run_rate``: ``SWEEP_SUBMITTERS`` threads offer
    ``SWEEP_REQUESTS`` single rows at ``rate`` a second in all, each
    request at its own time whatever the earlier answers; every answer held
    to the reference's. Returns (achieved per second, p50 ms, p95 ms)."""
    n, subs = SWEEP_REQUESTS, SWEEP_SUBMITTERS
    per, spacing = n // subs, subs / rate
    futs = [None] * n
    _reset_server(srv)
    t0 = time.perf_counter()

    def submitter(t):
        for j in range(per):
            target = t0 + j * spacing + t * spacing / subs
            while (dt := target - time.perf_counter()) > 0:
                time.sleep(min(dt, 0.0005))
            futs[t * per + j] = srv.submit(queries[(t * per + j) % NQ_MAIN])

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(subs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    got = [f.result(120) for f in futs]
    wall = time.perf_counter() - t0
    rows = np.arange(n) % NQ_MAIN
    _check_answers(np.concatenate([d for d, _ in got]),
                   np.concatenate([i for _, i in got]), ref[0][rows],
                   ref[1][rows], rtol, what)
    s = srv.stats.summary()
    return n / wall, s["p50_ms"], s["p95_ms"]


def _knee_sweep(srv, queries, ref, rtol: float, what: str) -> None:
    """``bench_torch.sweep_offered_rates`` (``bench.py``'s offered-load
    rule) on a warm server, up to ``SWEEP_CAP``, every answer held to the
    reference's; then p50/p95 at 80% of the knee."""
    from bench_torch import sweep_offered_rates

    knee, points = sweep_offered_rates(
        lambda rate: _open_loop(srv, queries, rate, ref, rtol, what),
        SWEEP_CAP)
    log(f"[serve] {what}, open loop: {json.dumps(points)}")
    assert knee is not None, f"{what}: no offered rate was kept up"
    ach, p50, p95 = _open_loop(srv, queries, round(0.8 * knee, -2), ref,
                               rtol, what)
    log(f"[serve] {what}, open loop: knee {knee:.0f}/s"
        f"{' (the cap)' if knee >= SWEEP_CAP else ''}; at 80% of it "
        f"({round(0.8 * knee, -2):.0f}/s offered) achieved {ach:.1f}/s, p50 "
        f"{p50:.3f} / p95 {p95:.3f} ms; answers equal the reference's")


def _serve_load(srv, queries, what: str, rows_of, n_requests: int, ref,
                rtol: float) -> dict:
    """One closed-loop load on a warm server, its counters and K1/K2's
    launch counts zeroed just before it; logs QPS, latency percentiles,
    mean batch fill, fetch seconds and batches; holds every answer to the
    reference's for its rows."""
    from vaq_tpu_torch.ops import scan_codes
    _reset_server(srv)
    scan_codes.decode_window_scan.launches = 0
    scan_codes.decode_rescore.launches = 0
    t0 = time.perf_counter()
    got = _closed_loop(srv, queries, rows_of, n_requests, SERVE_THREADS)
    wall = time.perf_counter() - t0
    k1 = scan_codes.decode_window_scan.launches
    k2 = scan_codes.decode_rescore.launches
    rows = np.concatenate([r for r, _, _ in got])
    swaps = _check_answers(np.concatenate([d for _, d, _ in got]),
                           np.concatenate([i for _, _, i in got]),
                           ref[0][rows], ref[1][rows], rtol, what)
    with srv._lock:
        s = srv.stats.summary()
        fill = srv.sum_fill / max(srv.batches_served, 1)
        fetch, batches = srv.sum_fetch_s, srv.batches_served
    log(f"[serve] {what}: {len(rows)} queries in {n_requests} requests from "
        f"{SERVE_THREADS} threads, {wall:.3f} s wall: {s['qps']:.0f} QPS, "
        f"p50 {s['p50_ms']:.3f} / p95 {s['p95_ms']:.3f} / p99 "
        f"{s['p99_ms']:.3f} ms, mean batch fill {fill:.1f} of "
        f"{srv.max_batch}, fetch {fetch:.3f} s, {batches} batches; K1/K2 "
        f"launches {k1}/{k2}; answers equal the reference's, {swaps} rows "
        f"with a near tie swapped")
    return {"qps": s["qps"], "k1": k1, "k2": k2}


def _http_json(url: str, body=None):
    import urllib.request
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _serve_cli() -> None:
    """``python -m vaq_tpu_torch.cli.serve`` as a subprocess: wait for its
    ``serving on`` line, send one /search, then terminate it."""
    cmd = [sys.executable, "-m", "vaq_tpu_torch.cli.serve", *SERVE_CLI_ARGS]
    env = {k: v for k, v in os.environ.items() if k != "VAQ_TPU_PLATFORM"}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    try:
        lines, url = [], None
        while time.perf_counter() - t0 < SERVE_CLI_LIMIT_S:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.rstrip())
            m = re.search(r"serving on (http://\S+)", line)
            if m:
                url = m.group(1)
                break
        for line in lines:
            log(f"[serve] cli: {line}")
        assert url is not None, f"serve printed no 'serving on' line: {lines}"
        up = time.perf_counter() - t0
        q = np.random.default_rng(SEED).standard_normal(D_MAIN)
        out = _http_json(url + "/search", {"query": q.tolist()})
        labels = np.asarray(out["labels"])
        assert labels.shape == (1, 10) and (labels >= 0).all(), out
        assert np.isfinite(np.asarray(out["distances"])).all()
        log(f"[serve] cli: {' '.join(SERVE_CLI_ARGS)}: serving after "
            f"{up:.1f} s, /search answered {labels[0].tolist()}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def phase_serve(ctx: dict) -> dict:
    """``SearchServer`` over the 1M index: closed-loop single-row and
    group loads and the open-loop sweep on the codes tier (K1/K2) and on
    the decoded tier, each answer held to ``search_device`` of the same
    rows in 512-query batches;
    the HTTP front end; the ``serve`` CLI. Returns K1/K2's launches under
    the codes tier's loads."""
    from vaq_tpu_torch.serving import SearchServer
    from vaq_tpu_torch.serving_http import SearchHTTPServer
    idx, queries = ctx["idx"], ctx["queries"]
    qdev = torch.as_tensor(queries, device=DEVICE)
    # fault 1: the codes tier's winners are picked on K1's packed scores
    br = idx._codes_block_rows(100)
    rtol_codes = RTOL_KERNEL + 2.0 ** ((br - 1).bit_length() - 23)
    launches = {}
    for backend in ("codes", "decoded"):
        parts = [idx.search_device(qdev[s:s + 512], 100, backend=backend)
                 for s in range(0, NQ_MAIN, 512)]
        ref = (torch.cat([p[0] for p in parts]).cpu().numpy(),
               torch.cat([p[1] for p in parts]).cpu().numpy())
        rtol = rtol_codes if backend == "codes" else RTOL_KERNEL
        srv = SearchServer(idx, k=100, max_batch=512, max_wait_ms=2,
                           backend=backend, pipeline_depth=4)
        try:
            srv.search(queries[0])                       # warm
            single = _serve_load(
                srv, queries, f"{backend} tier, single rows", lambda r: np.array(
                    [r % NQ_MAIN]), SERVE_SINGLE, ref, rtol)
            group = _serve_load(
                srv, queries, f"{backend} tier, {SERVE_GROUP}-row groups",
                lambda r: (r * SERVE_GROUP + np.arange(SERVE_GROUP)) % NQ_MAIN,
                SERVE_GROUPS, ref, rtol)
            _knee_sweep(srv, queries, ref, rtol, f"{backend} tier")
            if backend == "codes":
                for load in (single, group):
                    assert load["k1"] > 0 and load["k2"] > 0, load
                launches = {"serve": {
                    "decode_window_scan": single["k1"] + group["k1"],
                    "decode_rescore": single["k2"] + group["k2"]}}
                http = SearchHTTPServer(srv, host="127.0.0.1", port=0).start()
                try:
                    _serve_http(http, queries, ref, rtol)
                finally:
                    http.close()
        finally:
            srv.close()
    _serve_cli()
    return launches


def _serve_http(http, queries, ref, rtol: float) -> None:
    """``SERVE_HTTP`` POST /search requests from ``SERVE_HTTP_THREADS``
    threads, each answer held to the reference's; /healthz and /stats."""
    host, port = http.address[:2]
    root = f"http://{host}:{port}"
    assert _http_json(root + "/healthz") == {"ok": True}

    def one(r):
        out = _http_json(root + "/search",
                         {"query": queries[r % NQ_MAIN].tolist()})
        return r % NQ_MAIN, out

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(SERVE_HTTP_THREADS) as pool:
        got = list(pool.map(one, range(SERVE_HTTP)))
    wall = time.perf_counter() - t0
    rows = np.array([r for r, _ in got])
    swaps = _check_answers(
        np.concatenate([np.asarray(o["distances"], np.float32)
                        for _, o in got]),
        np.concatenate([np.asarray(o["labels"], np.int32) for _, o in got]),
        ref[0][rows], ref[1][rows], rtol, "http")
    stats = _http_json(root + "/stats")
    assert stats["queries_served"] >= SERVE_HTTP, stats
    log(f"[serve] http: {SERVE_HTTP} POST /search from {SERVE_HTTP_THREADS} "
        f"threads in {wall:.3f} s ({SERVE_HTTP / wall:.0f} requests/s), "
        f"answers equal the reference's ({swaps} near-tie swaps); /healthz "
        f"ok; /stats {json.dumps(stats)}")


def phase_shard(ctx: dict) -> dict:
    """``VAQIndex.shard`` over S shards of the one card (S = 2, 4): the
    decoded, int8 and codes tiers and the probe at visit 0.1, held to the
    unsharded tiers; ``sharded_exact_search`` to ``exact_search``;
    ``lloyd_sharded`` at S = 2 to ``kmeans.lloyd``. Returns the launches of
    K1/K2 (codes) and K5/K7 (probe) per S, and K1's at the 32-row windows
    of S = 4."""
    from vaq_tpu_torch import kmeans, metrics
    from vaq_tpu_torch.ops import distances, probe_scan, rescore, scan_codes
    from vaq_tpu_torch.parallel import make_mesh, sharded_exact_search
    from vaq_tpu_torch.parallel.dist_kmeans import lloyd_sharded, shard_rows_for
    from vaq_tpu_torch.parallel.sharded import _shard_span
    idx, queries, gt, base = ctx["idx"], ctx["queries"], ctx["gt"], ctx["base"]
    dev = torch.device(DEVICE)
    idx.ivf.visit = SHARD_VISIT
    tiers = ("decoded", "decoded8", "codes", "ivf")
    ref = {b: idx.search(queries, 100, backend=b) for b in tiers}
    rec = {b: metrics.avg_recall(ref[b][1], gt, 100) for b in tiers}
    counters = {"decode_window_scan": scan_codes.decode_window_scan,
                "decode_rescore": scan_codes.decode_rescore,
                "groupmin_window_scan": probe_scan.groupmin_window_scan,
                "gather_rescore": rescore.gather_rescore}
    launches = {}
    for s in SHARDS:
        sidx = copy.copy(idx)        # the tiers stay shared, the mesh is the copy's
        mesh = make_mesh(devices=[dev] * s)
        _step(f"shard S={s} tiers={tiers}",
              lambda: sidx.shard(mesh, tiers=tiers), tag="shard")
        br = sidx._codes_block_rows(100, sidx._sharded_codes.shard_rows)
        for c in counters.values():
            c.launches = 0
        got = {}
        for b in tiers:
            sidx.search(queries, 100, backend=b)          # first call
            got[b] = _step(f"S={s} search {b} k=100", lambda: sidx.search(
                queries, 100, backend=b), NQ_MAIN, tag="shard")
        counts = {n: c.launches for n, c in counters.items()}
        differ, lower = _check_no_worse(*got["decoded"], *ref["decoded"],
                                        1e-5, f"decoded S={s}")
        r = {b: metrics.avg_recall(got[b][1], gt, 100) for b in tiers}
        log(f"[shard] S={s}: avg_recall@100 " + ", ".join(
            f"{b} {r[b]:.4f} (unsharded {rec[b]:.4f})" for b in tiers)
            + f"; decoded distances rank by rank no worse than the "
            f"unsharded tier's, ids differing in {differ} of {NQ_MAIN} rows, "
            f"{lower} rows with a lower distance; codes windows {br} rows; "
            f"launches {counts}")
        assert abs(r["codes"] - rec["codes"]) <= 0.02, (r, rec)
        assert abs(r["decoded8"] - rec["decoded8"]) <= 0.02, (r, rec)
        assert abs(r["ivf"] - rec["ivf"]) <= 0.03, (r, rec)
        assert all(n > 0 for n in counts.values()), counts
        launches[f"shard S={s}"] = counts
        if br == 32:
            launches["decode_window_scan_br32"] = counts["decode_window_scan"]
        del sidx, mesh
        torch.cuda.empty_cache()

    # the sharded groundtruth generator and the distributed Lloyd
    x = torch.as_tensor(base, device=dev)
    qd = torch.as_tensor(queries, device=dev)
    mesh = make_mesh(devices=[dev] * SHARDS[-1])
    d_1, i_1 = distances.exact_search(qd, x, 100)
    d_s, i_s = _step(f"sharded_exact_search S={SHARDS[-1]} k=100",
                     lambda: sharded_exact_search(
                         shard_rows_for(mesh, x), qd, 100, N_MAIN, mesh),
                     NQ_MAIN, tag="shard")
    swaps = _check_answers(d_s.cpu(), i_s.cpu(), d_1.cpu(), i_1.cpu(), 1e-6,
                           "sharded_exact_search")
    log(f"[shard] sharded_exact_search: ids equal exact_search's but {swaps} "
        f"rows with a near tie swapped")
    xk = x[:KM_ROWS]
    c0 = xk[torch.as_tensor(np.random.default_rng(SEED).choice(
        KM_ROWS, KM_K, replace=False), device=dev)]
    m2 = make_mesh(devices=[dev] * 2)
    x_sh = shard_rows_for(m2, xk)

    def rel(a, b):
        return float(((a - b).abs() / b.abs().max()).max())

    c_ref = _step(f"kmeans.lloyd {KM_ROWS} x {D_MAIN}, k={KM_K}, "
                  f"{KM_ITERS} iters", lambda: kmeans.lloyd(xk, c0, KM_ITERS),
                  tag="shard")
    c_sh = _step("lloyd_sharded S=2", lambda: lloyd_sharded(
        x_sh, c0, KM_ROWS, KM_ITERS, m2), tag="shard")
    # Step by step from the same centroids: the per-cluster counts that the
    # shards' _cluster_sums give (what lloyd_sharded reduces) must equal
    # one process's, and the new centroids agree within 1e-5. Over many
    # steps sums in another order (last bits) can tip a near tie and the
    # runs part; that drift is logged beside kmeans.lloyd's own on the same
    # rows in another order (one process, one block: only the order of the
    # sums differs), not held.
    shards = [p[:_shard_span(x_sh, j, KM_ROWS)[1]]
              for j, p in enumerate(x_sh.parts[0])]
    c, worst, flips, count_diff = c0, 0.0, 0, 0
    for _ in range(KM_ITERS):
        n_1 = kmeans._cluster_sums(xk[None], c[None])[1][0]
        n_s = sum(kmeans._cluster_sums(p[None], c[None])[1][0] for p in shards)
        count_diff += int((n_s - n_1).abs().sum())
        nxt = kmeans.lloyd(xk, c, 1)
        worst = max(worst, rel(lloyd_sharded(x_sh, c, KM_ROWS, 1, m2), nxt))
        flips += int((kmeans.assign_clusters(xk, nxt)
                      != kmeans.assign_clusters(xk, c)).sum())
        c = nxt
    c_perm = kmeans.lloyd(xk.roll(KM_ROWS // 2, 0), c0, KM_ITERS)
    log(f"[shard] lloyd_sharded vs kmeans.lloyd, each of {KM_ITERS} steps "
        f"from the same centroids: per-cluster counts differ by "
        f"{count_diff} rows in all ({flips} reassignments over the steps), "
        f"max |Δ| {worst:.3g} of the largest centroid; after {KM_ITERS} "
        f"chained iterations each: max |Δ| {rel(c_sh, c_ref):.3g}; "
        f"kmeans.lloyd on the rows rolled by {KM_ROWS // 2}, {KM_ITERS} "
        f"iterations: max |Δ| {rel(c_perm, c_ref):.3g}")
    assert count_diff == 0, count_diff
    assert worst <= 1e-5, worst
    del x, qd, xk
    torch.cuda.empty_cache()
    return launches


def phase_checks(ctx: dict) -> tuple[dict, list[dict]]:
    """The checks of JAX's root scripts through their port-side scripts:
    ``check_sharded_100k_torch.run`` on [main]'s first CHECK_N rows and
    CHECK_NQ queries over CHECK_SHARDS shards of the one card (|Δrecall| <
    0.005, qcap ≥ the queries on every shard), then K5 and K7 held against
    their plain versions at the shapes its shards launch them;
    ``compute_accuracy_torch.main`` on [main]'s decoded answers written as
    CSV and its groundtruth as ``.ivecs`` (the three printed numbers equal
    to ``metrics``'); ``oracle_bisect_torch.run`` without the oracle at
    BISECT_N rows. Returns the launches of K5/K7 in the sharded search,
    under the entries' names, and the entries."""
    from vaq_tpu_torch import io as vio
    from vaq_tpu_torch import metrics
    base, queries = ctx["base"], ctx["queries"]
    s = CHECK_SHARDS
    t_phase = time.perf_counter()

    # the sharded probe at visit 1.0
    check = _script("check_sharded_100k_torch")
    _kernel_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec, sidx = check.run(base[:CHECK_N], queries[:CHECK_NQ], s, CHECK_K,
                          device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    log(f"[checks] sharded visit-1.0 check, {CHECK_N} rows, {CHECK_NQ} "
        f"queries, S = {s} on the one card: {json.dumps(rec)}; {wall:.1f} s, "
        f"launches {counts}")
    assert rec["recalls_agree"], rec
    _, _, qcap, gs = rec["sharded_p_visit_p_max_qcap_gs"]
    assert qcap >= CHECK_NQ and rec["unsharded_p_visit_p_max_qcap_gs"][2] >= \
        CHECK_NQ, rec
    sharded = rec["sharded_launches"]
    assert sharded.get("groupmin_window_scan", 0) > 0, rec
    assert sharded.get("gather_rescore", 0) > 0, rec
    assert counts["groupmin_window_scan"] >= sharded["groupmin_window_scan"]
    del sidx
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    names = (f"groupmin_window_scan_shard{s}_v1", f"gather_rescore_shard{s}_v1")
    entries = [
        _check_groupmin(gen, rec["d"], "int8", qcap, ncl=rec["clusters_per_shard"],
                        cap=rec["cap"], gs=gs, name=names[0], tag="checks"),
        _check_rescore(gen, rec["d"], "int8", CHECK_NQ, rec["sharded_windows"],
                       gs, rec["clusters_per_shard"], rec["cap"], name=names[1],
                       tag="checks")]
    torch.cuda.empty_cache()
    launches = {names[0]: sharded["groupmin_window_scan"],
                names[1]: sharded["gather_rescore"]}

    # the CSV accuracy checker on [main]'s answers
    accuracy = _script("compute_accuracy_torch")
    lab, gt = ctx["l_dec"], ctx["gt"]
    with tempfile.TemporaryDirectory() as tmp:
        answers, truth = os.path.join(tmp, "answers.csv"), \
            os.path.join(tmp, "gt.ivecs")
        np.savetxt(answers, lab, fmt="%d", delimiter=",")
        vio.write_ivecs(truth, gt)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = accuracy.main([answers, truth, "--k", "100"])
    want = [f"avg_recall: {metrics.avg_recall(lab, gt, 100):.6f}",
            f"recall@R:   {metrics.recall_at_r(lab, gt, 100):.6f}",
            f"MAP:        {metrics.mean_average_precision(lab, gt, 100):.6f}"]
    log(f"[checks] compute_accuracy_torch on [main]'s decoded answers: "
        f"{out.getvalue().splitlines()}")
    assert rc == 0 and out.getvalue().splitlines() == want, (out.getvalue(),
                                                             want)

    # the engine-vs-oracle bisection, the oracle left out
    bisect = _script("oracle_bisect_torch")
    t0 = time.perf_counter()
    rec = bisect.run(base[:BISECT_N], queries, BISECT_K, METHOD, oracle=False,
                     device=DEVICE)
    log(f"[checks] oracle bisection at {BISECT_N} rows without the oracle: "
        f"{json.dumps(rec)}; {time.perf_counter() - t0:.1f} s")
    b, c, d = (rec["B_engine_exact_topk"], rec["C_engine_f32_adc"],
               rec["D_oracle_scan_engine_codes"])
    assert rec["A_engine_default"] == b, rec
    assert c >= b - 0.01 and abs(d - c) <= 0.002, rec
    log(f"[checks] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, entries


def _live_groundtruth(rows: torch.Tensor, dead: np.ndarray, queries, k: int
                      ) -> np.ndarray:
    """Exact top-k ids of ``queries`` over the rows not in ``dead``, on the
    card, as global ids."""
    from vaq_tpu_torch.ops import distances
    live = np.setdiff1d(np.arange(rows.shape[0]), dead)
    live_dev = torch.as_tensor(live, device=DEVICE)
    _, i = distances.exact_search(torch.as_tensor(queries, device=DEVICE),
                                  rows[live_dev], k)
    return live[i.cpu().numpy()]


def phase_crud(ctx: dict) -> dict:
    """The 1M index and its probe state, mutated: add, delete, every tier
    searched, the artifacts round trip; returns the tiers' kernel launches
    (logged apart from the main path's)."""
    from vaq_tpu_torch import data, metrics
    from vaq_tpu_torch.ops import probe_scan, rescore, scan_codes
    import vaq_tpu_torch as vt
    idx, base, queries = ctx["idx"], ctx["base"], ctx["queries"]
    dev = torch.device(DEVICE)
    n0 = idx.n_rows
    # rows of the base's own mixture: the generator with the base's seed
    # draws the same centres and mixing, and fresh noise for 10k rows (rows
    # of another seed come from another mixture, which the trained
    # codebooks do not cover, and would not find themselves)
    added, _ = data.make_anisotropic_gaussian(N_ADD, D_MAIN, 0, seed=SEED)
    ids = _step(f"add {N_ADD} rows", lambda: idx.add(added), tag="crud")
    assert ids[0] == n0 and len(ids) == N_ADD and idx.n_rows == n0 + N_ADD
    _, top1 = idx.search(queries[:100], 1, backend="decoded")
    rng = np.random.default_rng(SEED)
    others = rng.permutation(n0 + N_ADD)
    others = others[~np.isin(others, np.concatenate([top1[:, 0],
                                                     ids[:N_SELF]]))]
    dead = np.unique(top1[:, 0])
    dead = np.concatenate([dead, others[:N_DEL - len(dead)]])
    st = idx.ivf.state
    held = int(torch.isin(st.bucket_ids, torch.as_tensor(dead, device=dev)).sum())
    dead_slots = int((st.bucket_ids == -1).sum())
    _step(f"delete {N_DEL} ids", lambda: idx.delete(dead), tag="crud")
    poisoned = int((st.bucket_ids == -1).sum()) - dead_slots
    log(f"[crud] poisoned slots {poisoned}, deleted rows the buckets held "
        f"{held} (of {N_DEL}; {int((dead >= n0).sum())} were added rows)")
    assert poisoned == held == int((dead < n0).sum())

    rows = torch.cat([torch.as_tensor(base, device=dev),
                      torch.as_tensor(added, device=dev)])
    gt = _step("groundtruth@100 over the live rows (exact_search)",
               lambda: _live_groundtruth(rows, dead, queries, 100), NQ_MAIN,
               "crud")
    del rows
    idx.ivf.visit = 0.10
    counters = {"decoded": (), "decoded8": (),
                "codes": (scan_codes.decode_window_scan,
                          scan_codes.decode_rescore),
                "ivf": (probe_scan.groupmin_window_scan,
                        rescore.gather_rescore)}
    launches, labels = {}, {}
    for tier, kernels in counters.items():
        _step(f"search {tier} k=100 (first call)",
              lambda: idx.search(queries, 100, backend=tier), NQ_MAIN, "crud")
        for kern in kernels:
            kern.launches = 0
        d, lab = _step(f"search {tier} k=100",
                       lambda: idx.search(queries, 100, backend=tier),
                       NQ_MAIN, "crud")
        launches.update({f"{kern.__name__} ({tier})": kern.launches
                         for kern in kernels})
        assert lab.shape == (NQ_MAIN, 100) and (lab >= 0).all(), tier
        assert np.isfinite(d).all(), tier
        assert not np.isin(lab, dead).any(), f"{tier} returned a deleted row"
        labels[tier] = lab
        log(f"[crud] {tier}: avg_recall@100 {metrics.avg_recall(lab, gt, 100):.4f} "
            f"over the live rows")
    log(f"[crud] kernel launches: {launches}")
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the mutated index"
    assert (labels["ivf"] < n0).all(), "the probe returned an added row"
    _, own = idx.search(added[:N_SELF], 10, backend="decoded")
    hits = float((own[:, 0] == ids[:N_SELF]).mean())
    _, own_ivf = idx.search(added[:N_SELF], 10, backend="ivf")
    log(f"[crud] added rows as queries: own top-1 on the decoded tier "
        f"{hits:.4f}; probe answers among added rows "
        f"{int((own_ivf >= n0).sum())}")
    assert hits == 1.0, hits
    assert (own_ivf < n0).all(), "the probe returned an added row"

    with tempfile.TemporaryDirectory() as tmp:
        cp, kp = os.path.join(tmp, "centroids.bin"), os.path.join(tmp, "codes.bin")
        _step("export_reference_artifacts",
              lambda: idx.export_reference_artifacts(cp, kp), tag="crud")
        back = _step("from_reference_artifacts (rotation retrained)",
                     lambda: vt.VAQIndex.from_reference_artifacts(
                         idx.config, cp, kp, base, device=dev), tag="crud")
        assert torch.equal(back.codes, idx.codes), "codes differ"
        assert np.array_equal(back.centroids, idx.centroids), "centroids differ"
        del back
        path = os.path.join(tmp, "index.npz")
        _step("save", lambda: idx.save(path), tag="crud")
        bare = _step("load(with_codes=False)",
                     lambda: vt.VAQIndex.load(path, device=dev, with_codes=False),
                     tag="crud")
        assert bare.codes is None and bare.n_rows == idx.n_rows
        assert np.array_equal(bare.deleted_ids, idx.deleted_ids)
    log("[crud] artifacts round trip: codes and centroids equal; "
        "load(with_codes=False) holds no codes")
    return launches


def _fast_search(idx, queries, gt, what: str, k: int = 100, **kw):
    """One timed FAST-path search (after a first call that is not timed
    apart); logs avg_recall@100 and returns the result."""
    from vaq_tpu_torch import metrics
    d, l = _step(f"search {what}", lambda: idx.search(queries, k, **kw),
                 NQ_MAIN, "fast")
    assert l.shape == (NQ_MAIN, k) and (l >= 0).all() and np.isfinite(d).all(), what
    log(f"[fast] {what}: avg_recall@100 "
        f"{metrics.avg_recall(l[:, :100], gt, 100):.4f}")
    return d, l


def phase_fast_path(ctx: dict) -> dict:
    """The FAST/LUT path at 1M × 128 on FAST_METHOD: K3 before the LUT
    quantization is learned, K4 after it, the LUT gather scan, "auto" (the
    codes tier, K1/K2, by the route JAX takes on an accelerator) and refine
    from a fast4 search; returns K3's and K4's launches and K1's under
    "auto"."""
    import vaq_tpu_torch as vt
    from vaq_tpu_torch import metrics
    from vaq_tpu_torch.ops import scan_codes
    base, queries, gt = ctx["base"], ctx["queries"], ctx["gt"]
    counts = scan_codes.fast4_window_scan.launches
    dev = torch.device(DEVICE)
    idx = vt.VAQIndex(vt.parse_method_string(FAST_METHOD), device=dev)
    _step("train", lambda: idx.train(base), tag="fast")
    log(f"[fast] bits {idx.bits.tolist()}")
    _step("encode", lambda: idx.encode(base), tag="fast")
    # training is deterministic on the card: a second index from the same
    # config, data and seed has the same centroids and codes, bit for bit
    twin = vt.VAQIndex(vt.parse_method_string(FAST_METHOD), device=dev)
    _step("train again (same config, data and seed)", lambda: twin.train(base),
          tag="fast")
    _step("encode again", lambda: twin.encode(base), tag="fast")
    same = (np.array_equal(twin.eigvecs, idx.eigvecs)
            and np.array_equal(twin.centroids, idx.centroids)
            and torch.equal(twin.codes, idx.codes))
    log(f"[fast] two trainings: rotation, centroids and codes bit-equal: {same}")
    assert same, "two trainings of one config, data and seed differ"
    del twin
    fast_stages = ("fast.lut", "fast.scan", "fast.select", "fast.rescore",
                   "fast.topk")

    counts.update(K3=0, K4=0)
    _step("search fast4, f32 LUT (K3), first call",
          lambda: idx.search(queries, 100, backend="fast4"), NQ_MAIN, "fast")
    _fast_search(idx, queries, gt, "fast4, f32 LUT (K3)", backend="fast4")
    k3 = counts["K3"]
    assert k3 > 0 and counts["K4"] == 0, counts
    _profile_split("fast", "fast4, f32 LUT (K3)",
                   lambda: idx.search(queries[:512], 100, backend="fast4"), fast_stages)

    _step("learn_quantization(base, 0.1)",
          lambda: idx.learn_quantization(base, 0.1), tag="fast")
    counts.update(K3=0, K4=0)
    _step("search fast4, u8 LUT (K4), first call",
          lambda: idx.search(queries, 100, backend="fast4"), NQ_MAIN, "fast")
    _fast_search(idx, queries, gt, "fast4, u8 LUT (K4)", backend="fast4")
    _fast_search(idx, queries, gt, "lut_gather, dequantized LUT",
                 backend="lut_gather")
    k4 = counts["K4"]
    assert k4 > 0 and counts["K3"] == 0, counts
    _profile_split("fast", "fast4, u8 LUT (K4)",
                   lambda: idx.search(queries[:512], 100, backend="fast4"), fast_stages)

    # "auto" on a quantized FAST index: "lut", which JAX's accelerator rule
    # serves from the codes tier when enough windows form
    counts.update(K3=0, K4=0)
    scan_codes.decode_window_scan.launches = 0
    _step("search auto, first call", lambda: idx.search(queries, 100),
          NQ_MAIN, "fast")
    _fast_search(idx, queries, gt, "auto (codes tier)")
    k1 = scan_codes.decode_window_scan.launches
    log(f"[fast] auto: K1 launches {k1}, K3/K4 {counts}")
    assert k1 > 0, "auto did not run K1"
    assert counts == {"K3": 0, "K4": 0}, counts
    # K1's second checked shape (C = 16, 128-row windows)
    assert (idx._codes_block_rows(100), int(idx.bits.max())) == \
        (K1_SHAPES[1][5], K1_SHAPES[1][2].bit_length() - 1)
    _profile_split("fast", "auto (codes tier)",
                   lambda: idx.search(queries[:512], 100), ())

    counts.update(K3=0, K4=0)
    _, cand = _fast_search(idx, queries, gt, "fast4 k=200 (K4)", k=200,
                           backend="fast4")
    d_ref, l_ref = _step("refine 200->100",
                         lambda: idx.refine(queries, cand, base, 100), NQ_MAIN,
                         "fast")
    k4 += counts["K4"]
    assert counts["K4"] > 0 and counts["K3"] == 0, counts
    assert np.isfinite(d_ref).all() and (l_ref >= 0).all()
    log(f"[fast] refined 200->100 avg_recall@100 "
        f"{metrics.avg_recall(l_ref, gt, 100):.4f}")
    launches = {"fast4_window_scan": k3, "fast4_window_scan_int8": k4,
                "decode_window_scan_c16": k1}
    log(f"[fast] kernel launches during the FAST path: {launches}")
    ctx["fast_idx"] = idx           # quantized: [kcheck]'s second index
    return launches


def phase_wide(ctx: dict) -> None:
    """WIDE_METHOD with the hierarchical k-means at 1M × 128."""
    import vaq_tpu_torch as vt
    from vaq_tpu_torch import metrics
    base, queries, gt = ctx["base"], ctx["queries"], ctx["gt"]
    cfg = dataclasses.replace(vt.parse_method_string(WIDE_METHOD),
                              hierarchical_kmeans=True)
    idx = vt.VAQIndex(cfg, device=DEVICE)
    _step("train (hierarchical k-means above 8 bits)",
          lambda: idx.train(base, verbose=True), tag="wide")
    log(f"[wide] bits {idx.bits.tolist()}, {int((idx.bits > 8).sum())} above 8")
    _step("encode", lambda: idx.encode(base, verbose=True), tag="wide")
    assert idx.codes.dtype == torch.int32 and int(idx.bits.max()) == 13
    _step("search decoded k=100 (first call builds the decoded db)",
          lambda: idx.search(queries, 100, backend="decoded"), NQ_MAIN, "wide")
    d, lab = _step("search decoded k=100",
                   lambda: idx.search(queries, 100, backend="decoded"),
                   NQ_MAIN, "wide")
    _, cand = _step("search decoded k=200",
                    lambda: idx.search(queries, 200, backend="decoded"),
                    NQ_MAIN, "wide")
    d_ref, l_ref = _step("refine 200->100",
                         lambda: idx.refine(queries, cand, base, 100), NQ_MAIN,
                         "wide")
    r_dec = metrics.avg_recall(lab, gt, 100)
    r_ref = metrics.avg_recall(l_ref, gt, 100)
    log(f"[wide] avg_recall@100 decoded {r_dec:.4f}, refined 200->100 "
        f"{r_ref:.4f} (main path's decoded {ctx['r_dec']:.4f})")
    assert np.isfinite(d).all() and (lab >= 0).all()
    assert np.isfinite(d_ref).all() and r_ref >= r_dec
    gate = _script("widebits_1m_torch")
    overlap, l_lut, _ = _step(
        f"u16 gate: the f32 LUT-gather top-{WIDE_GATE_K} over the first "
        f"{gate.GATE_ROWS} rows' codes, {gate.GATE_QUERIES} queries, against "
        f"the decoded tier's", lambda: gate.u16_gate(idx, queries, WIDE_GATE_K),
        tag="wide")
    log(f"[wide] u16_gate_overlap {overlap:.4f} (JAX 0.9891 at 20k rows; "
        f"required >= {WIDE_GATE_MIN})")
    assert l_lut.shape == (gate.GATE_QUERIES, WIDE_GATE_K)
    assert overlap >= WIDE_GATE_MIN, overlap
    try:
        idx.search(queries[:8], 100, backend="codes")
    except vt.ConfigError as e:
        log(f"[wide] backend='codes' refused: {e}")
    else:
        raise AssertionError("the codes tier served >8-bit codes")


def _launched(counter, what: str, fn, tag: str = "binary"):
    """Run ``fn`` with the kernel wrapper ``counter``'s launch count set to
    0 just before; fail unless it moved. Returns (result, launches)."""
    counter.launches = 0
    out = fn()
    n = counter.launches
    assert n > 0, f"{what}: {counter.__name__} was never launched"
    log(f"[{tag}] {what}: {counter.__name__} launches {n}")
    return out, n


def _check_probe_answer(bidx, queries, d_p, i_p, d_f, i_f) -> int:
    """The probe over every cluster against the flat packed scan: equal
    distances row for row, the same ids below each row's k-th distance, and
    every returned id at its stated Hamming distance (recomputed from the
    words). Returns how many entries' ids differ (all in k-th tie groups)."""
    from vaq_tpu_torch.ops import hamming
    np.testing.assert_array_equal(d_p, d_f)
    for q in range(d_p.shape[0]):
        inside = d_f[q] < d_f[q, -1]
        assert set(i_p[q][inside]) == set(i_f[q][inside]), q
    qw = bidx._query_words(queries).long()
    rows = bidx.packed[torch.as_tensor(i_p, device=DEVICE).long()]
    true = hamming._popcount(rows ^ qw[:, None, :]).sum(2)
    assert torch.equal(true.cpu(), torch.as_tensor(d_p, dtype=torch.int64))
    return int((i_p != i_f).sum())


def phase_binary(ctx: dict) -> tuple[dict, list[dict]]:
    """The BitVecEngine at the main path's 1M × 128 rows, 1000 queries and
    exact groundtruth@100: BinaryIndex(256) searched every way, the Hamming
    cluster probe, the streaming scan, CRUD and ScalarLUTIndex(256) on the
    codes tier. Returns the launches of H1 (over the searches) and of K1/K2
    (over the ScalarLUT codes tier), and H1 held against its plain version
    on one cluster block of the path's own state."""
    from vaq_tpu_torch import binary, metrics
    from vaq_tpu_torch.ops import hamming, scan_codes
    base, queries, gt = ctx["base"], ctx["queries"], ctx["gt"]
    dev = torch.device(DEVICE)
    h1 = hamming.popcount_dists
    bidx = binary.BinaryIndex(bit_budget=BIN_BUDGET, device=dev)
    _step("train BinaryIndex(256) on the 1M rows (host numpy)",
          lambda: bidx.train(base, verbose=True), tag="binary")
    _step("encode (host numpy; packed, db01, db_pop to the card)",
          lambda: bidx.encode(base), tag="binary")
    used = int((bidx.bits > 0).sum())
    log(f"[binary] {used} dimensions used, {bidx.total_bits} bits, "
        f"{bidx.packed.shape[1]} words a row; packed "
        f"{bidx.packed.numel() * 4 / 1e6:.0f} MB, db01 "
        f"{bidx.db01.numel() / 1e6:.0f} MB")
    assert bidx.total_bits == BIN_BUDGET and bidx.packed.shape == (N_MAIN, KH_W)
    recall = {}

    def search(what, fn, nq=NQ_MAIN, counted=True):
        run = (lambda: _step(what, fn, nq, "binary"))
        out, n = _launched(h1, what, run) if counted else (run(), 0)
        if out[1].shape[1] == 100 and out[1].shape[0] == NQ_MAIN:
            recall[what] = metrics.avg_recall(out[1], gt, 100)
            log(f"[binary] {what}: avg_recall@100 {recall[what]:.4f}")
        return out, n

    h1_launches = h1.launches = 0
    _step("query auto (matmul, _int_mm) k=100, first call",
          lambda: bidx.query(queries, 100), NQ_MAIN, "binary")
    (d_a, i_a), _ = search("query auto (matmul, _int_mm) k=100",
                           lambda: bidx.query(queries, 100), counted=False)
    assert h1.launches == 0, "the matmul backend launched H1"
    (d_p, i_p), n = search("query packed (H1) k=100",
                           lambda: bidx.query(queries, 100, backend="packed"))
    h1_launches += n
    np.testing.assert_array_equal(d_a, d_p)
    np.testing.assert_array_equal(i_a, i_p)
    assert d_p.dtype == np.int32 and (np.diff(d_p, axis=1) >= 0).all()
    tie = float(np.mean(d_p[:, 99] == d_p[:, 98]))
    log(f"[binary] auto and packed: identical ids and distances; the 100th "
        f"place ties the 99th in {tie:.3f} of the rows")
    for backend in ("packed", "matmul"):
        _profile_split("binary", f"query {backend} k=100, {NQ_MAIN} queries",
                       lambda: bidx.query(queries, 100, backend=backend), (),
                       reps=3)
    (d_j, i_j), n = search("query jaccard (H1) k=100",
                           lambda: bidx.query(queries, 100, metric="jaccard"))
    h1_launches += n
    assert d_j.dtype == np.float32 and ((d_j >= 0) & (d_j <= 1)).all()
    (d_r, i_r), _ = search("query_rerank factor=10 (matmul, then exact L2)",
                           lambda: bidx.query_rerank(queries, base, 100, factor=10),
                           counted=False)
    assert recall["query_rerank factor=10 (matmul, then exact L2)"] >= \
        recall["query packed (H1) k=100"]
    (d_l2, i_l2), _ = search("query_naive l2", lambda: bidx.query_naive(
        queries, base, 100), counted=False)
    np.testing.assert_array_equal(i_l2, gt)
    log("[binary] query_naive l2 ids equal the groundtruth")
    (d_m, i_m), _ = search("query_naive manhattan", lambda: bidx.query_naive(
        queries, base, 100, metric="manhattan"), counted=False)
    assert np.isfinite(d_m).all() and (np.diff(d_m, axis=1) >= 0).all()
    (d_f, i_f), n = search(f"query_filtering {BIN_SUBVECTORS} sub-vectors k=100",
                           lambda: bidx.query_filtering(queries, 100,
                                                        BIN_SUBVECTORS))
    h1_launches += n
    assert (d_f < binary.FAR).all()
    (sub, i_h), n = search(f"query_filtering_heap {BIN_SUBVECTORS} sub-vectors "
                           f"k=100, {BIN_HEAP_NQ} queries",
                           lambda: bidx.query_filtering_heap(
                               queries[:BIN_HEAP_NQ], 100, BIN_SUBVECTORS),
                           nq=BIN_HEAP_NQ)
    h1_launches += n
    assert sub.shape == (BIN_HEAP_NQ, 100, BIN_SUBVECTORS)
    keys = [tuple(v) for v in sub[0]]
    assert keys == sorted(keys)

    state = _step(f"build_hamming_clusters {BIN_CLUSTERS} clusters, "
                  f"{BIN_ITERS} iterations", lambda: binary.build_hamming_clusters(
                      bidx, base, BIN_CLUSTERS, iters=BIN_ITERS, device=dev),
                  tag="binary")
    sizes = state.sizes.cpu().numpy()
    log(f"[binary] clusters: cap {state.cap} (mean {sizes.mean():.0f}, min "
        f"{sizes.min()}), buckets {state.bucket_words.numel() * 4 / 1e6:.0f} MB")
    for n_probe in BIN_PROBES:
        (d_c, i_c), n = search(f"query_hamming_clusters n_probe={n_probe} k=100",
                               lambda: binary.query_hamming_clusters(
                                   bidx, state, queries, 100, n_probe))
        h1_launches += n
    differ = _check_probe_answer(bidx, queries, d_c, i_c, d_p, i_p)
    log(f"[binary] n_probe={BIN_PROBES[-1]}: distances equal the packed scan's "
        f"row for row; {differ} of {i_c.size} ids differ, all inside the "
        f"k-th distance's tie group")
    # H1 on one cluster block of this state: the 208 query slots of visit
    # n_probe 100 against the first clusters' buckets
    qcap = KH_PROBE[1]
    cb = min(BIN_CLUSTERS, max(1, binary.PROBE_BLOCK_ELEMS // (qcap * state.cap)))
    qw = bidx._query_words(queries[:qcap])
    entry = _held_h1(qw[None].expand(cb, qcap, KH_W).contiguous(),
                     state.bucket_words[:cb].contiguous(), "xor",
                     "popcount_dists_probe_1m", tag="binary")
    del state
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "base.f32")
        base.astype(np.float32).tofile(path)
        d_s, i_s = _step(f"query_naive_streaming batch_rows={BIN_STREAM_ROWS} "
                         f"(raw f32 file)", lambda: binary.query_naive_streaming(
                             path, D_MAIN, queries, 100,
                             batch_rows=BIN_STREAM_ROWS, device=dev),
                         NQ_MAIN, "binary")
    np.testing.assert_array_equal(i_s, gt)
    log("[binary] query_naive_streaming ids equal the groundtruth")

    rng = np.random.default_rng(SEED)
    x_new = base[:N_ADD] + 0.01 * rng.standard_normal(
        (N_ADD, D_MAIN)).astype(np.float32)
    new_ids = _step(f"append {N_ADD} rows", lambda: bidx.append(x_new),
                    tag="binary")
    np.testing.assert_array_equal(new_ids, np.arange(N_MAIN, N_MAIN + N_ADD))
    np.testing.assert_array_equal(bidx.get_bitv(new_ids[:N_SELF]),
                                  bidx.encode_queries(x_new[:N_SELF]))
    (d_self, _), n = _launched(h1, "appended rows as queries", lambda: bidx.query(
        x_new[:N_SELF], 1, backend="packed"))
    h1_launches += n
    assert (d_self[:, 0] == 0).all()
    dead = rng.choice(N_MAIN + N_ADD, N_DEL, replace=False)
    _step(f"delete {N_DEL} ids", lambda: bidx.delete(dead), tag="binary")
    assert bidx.n_rows == N_MAIN and bidx.packed.shape[0] == N_MAIN
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "binary.npz")
        _step("save", lambda: bidx.save(path), tag="binary")
        back = _step("load", lambda: binary.BinaryIndex.load(path, device=dev),
                     tag="binary")
    assert torch.equal(back.packed, bidx.packed) and torch.equal(back.db01, bidx.db01)
    (d_b, i_b), n = _launched(h1, "query packed after the round trip",
                              lambda: back.query(queries, 100, backend="packed"))
    h1_launches += n
    d_o, i_o = bidx.query(queries, 100, backend="packed")
    np.testing.assert_array_equal(d_b, d_o)
    np.testing.assert_array_equal(i_b, i_o)

    lut = binary.ScalarLUTIndex(BIN_BUDGET, device=dev)
    _step("ScalarLUTIndex(256) train (host numpy)",
          lambda: lut.train(base, verbose=True), tag="binary")
    _step("ScalarLUTIndex encode", lambda: lut.encode(base), tag="binary")
    vq = lut._vaq
    log(f"[binary] ScalarLUT: M' = {vq.highest_subs}, L = {vq.subs_len}, "
        f"bits {vq.bits.tolist()}, windows of {vq._codes_block_rows(100)} rows")
    assert (vq.highest_subs, vq.subs_len) == (LUT_M, 1), \
        "phase 3 checked K1/K2 at another M'"
    _step("ScalarLUT query codes k=100, first call",
          lambda: lut.query(queries, 100, backend="codes"), NQ_MAIN, "binary")
    scan_codes.decode_rescore.launches = 0
    (d_u, i_u), k1 = _launched(scan_codes.decode_window_scan,
                               "ScalarLUT query codes k=100 (K1/K2)",
                               lambda: _step("ScalarLUT query codes k=100",
                                             lambda: lut.query(queries, 100,
                                                               backend="codes"),
                                             NQ_MAIN, "binary"))
    k2 = scan_codes.decode_rescore.launches
    assert k2 > 0, "the ScalarLUT codes tier never launched K2"
    r_lut = metrics.avg_recall(i_u, gt, 100)
    d_q, i_q = _step("ScalarLUT query_refine factor=10",
                     lambda: lut.query_refine(queries, base, 100), NQ_MAIN, "binary")
    r_q = metrics.avg_recall(i_q, gt, 100)
    log(f"[binary] ScalarLUT avg_recall@100 codes {r_lut:.4f}, refined "
        f"{r_q:.4f}")
    assert np.isfinite(d_u).all() and (i_u >= 0).all() and r_q >= r_lut
    launches = {"popcount_dists": h1_launches,
                f"decode_window_scan_m{LUT_M}": k1,
                f"decode_rescore_m{LUT_M}": k2}
    log(f"[binary] kernel launches during the binary path: {launches}")
    return launches, [entry]


def _demo(module, argv: list[str]) -> str:
    """One demo's ``main`` on the card, its lines logged under [cli];
    returns what it printed."""
    os.environ.pop("VAQ_TPU_PLATFORM", None)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    dt = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log(f"[cli] {line}")
    log(f"[cli] {module.__name__.rsplit('.', 1)[-1]} {' '.join(argv)}: "
        f"exit {rc}, {dt:.3f} s")
    assert rc == 0, rc
    return out.getvalue()


def _demo_vaq(argv: list[str]) -> tuple[list[float], int, int]:
    """demo_vaq on the card; returns its avg_recall lines and K1/K2's
    launches (counters zeroed just before)."""
    from vaq_tpu_torch.cli import demo_vaq
    from vaq_tpu_torch.ops import scan_codes
    scan_codes.decode_window_scan.launches = 0
    scan_codes.decode_rescore.launches = 0
    out = _demo(demo_vaq, argv)
    k1 = scan_codes.decode_window_scan.launches
    k2 = scan_codes.decode_rescore.launches
    recalls = [float(v) for v in
               re.findall(r"precision\(avg_recall\): ([0-9.]+)", out)]
    log(f"[cli] demo_vaq: K1/K2 launches {k1}/{k2}")
    assert len(recalls) == 2, recalls
    assert recalls[0] <= recalls[1] <= 1.0, recalls   # refine 100, 200
    return recalls, k1, k2


def _cluster_demos(r_main: float) -> None:
    """demo_cluster (simple, fast, kmeanspp), demo_boltcentroids and
    demo_vaq_paramsearch at 1M × 128 on the card: each cluster index within
    1% of its CPU reading, 32 × 16 Bolt centroids of 4 finite numbers,
    paramsearch's seven rows with METHOD's within 0.005 of ``r_main``."""
    from vaq_tpu_torch.cli import (demo_boltcentroids, demo_cluster,
                                   demo_vaq_paramsearch)
    for version, want in CLUSTER_CPU_INDEX.items():
        out = _demo(demo_cluster, CLUSTER_ARGS + ["--version", version])
        ci = float(re.search(r"sqdist\): ([0-9.]+)", out).group(1))
        sil = float(re.search(r"silhouette: ([0-9.-]+)", out).group(1))
        log(f"[cli] demo_cluster {version}: cluster index {ci:.6f} (CPU "
            f"{want:.6f}, {100 * (ci - want) / want:+.3f}%), silhouette "
            f"{sil:.6f}")
        assert abs(ci - want) <= 0.01 * want, (version, ci, want)
        assert -1.0 <= sil <= 1.0, sil
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bolt.csv")
        _demo(demo_boltcentroids, BOLT_ARGS + ["--save", path])
        cents = np.loadtxt(path, delimiter=",", ndmin=2)
        assert cents.shape == (32 * 16, 4) and np.isfinite(cents).all(), \
            cents.shape
        path = os.path.join(tmp, "paramsearch.csv")
        _demo(demo_vaq_paramsearch, PARAMSEARCH_ARGS + ["--out", path])
        rows = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    assert rows[:, :3].astype(int).tolist() == PARAMSEARCH_ROWS, rows
    rec = float(rows[PARAMSEARCH_ROWS.index([32, 7, 8]), 3])
    log(f"[cli] demo_vaq_paramsearch m=32 min=7 max=8: avg_recall {rec:.4f}, "
        f"[main] decoded {r_main:.4f} ({'equal' if rec == r_main else 'differ'}"
        f", |Δ| {abs(rec - r_main):.4f})")
    assert abs(rec - r_main) <= 0.005, (rec, r_main)


def phase_cli(r_main: float) -> dict:
    """demo_vaq at 100k rows (the decoded tier serves both refines) and at
    102,400 (refine 100's search on K1/K2), then the clustering demos;
    returns the second demo_vaq's launches."""
    recalls, _, _ = _demo_vaq(CLI_ARGS)
    assert all(r >= lo for r, lo in zip(recalls, CLI_MIN_RECALL)), \
        (recalls, CLI_MIN_RECALL)
    recalls, k1, k2 = _demo_vaq(CLI_CODES_ARGS)
    assert k1 > 0 and k2 > 0, (k1, k2)
    assert all(abs(r - c) <= 0.02 for r, c in zip(recalls,
                                                  CLI_CODES_CPU_RECALL)), \
        (recalls, CLI_CODES_CPU_RECALL)
    _cluster_demos(r_main)
    return {"cli": {"decode_window_scan": k1, "decode_rescore": k2}}


def _ivf_card_vs_cpu(gpu, cpu, queries, ti_segments: int) -> None:
    """One IVF state built on the card, copied to the CPU, searched on both
    with the decoded tier resident (nq ≤ 256: qcap = nq, nothing drops)."""
    import dataclasses

    from vaq_tpu_torch import ivf
    ivf.attach_ivf(gpu, ti_cluster_num=64, ti_segment_num=ti_segments,
                   visit=0.25)
    st = gpu.ivf.state
    st_cpu = dataclasses.replace(
        st, bucket_rows=st.bucket_rows.cpu(), bucket_ids=st.bucket_ids.cpu(),
        sizes=st.sizes.cpu(), dim_scales=st.dim_scales.cpu())
    cpu.ivf = ivf.IVFSearcher(st_cpu, 0.25)
    for idx in (gpu, cpu):
        idx._ensure_decoded()
    dg, ig = gpu.search(queries, K_CMP, backend="ivf")
    dc, ic = cpu.search(queries, K_CMP, backend="ivf")
    agree = float(np.mean([len(set(ig[q]) & set(ic[q])) / K_CMP
                           for q in range(len(queries))]))
    # The probe returns ‖q‖² − score (JAX's formula), a difference of terms
    # of the size of ‖q‖² that cancels: hold it to 1e-4 of those terms.
    qp = queries @ cpu.eigvecs[:, :cpu.total_dim]
    terms = np.abs(dc) + (qp * qp).sum(axis=1)[:, None]
    rel = float(np.max(np.abs(dg - dc) / terms))
    log(f"[cmp] ivf d={st.d_full}: top-{K_CMP} id agreement card vs cpu "
        f"{agree:.4f}, max |Δdist| {float(np.max(np.abs(dg - dc))):.3g} = "
        f"{rel:.3g} of the terms (max rel Δdist "
        f"{float(np.max(np.abs(dg - dc) / dc)):.3g})")
    assert (ig >= 0).all() and agree >= 0.99, agree
    assert rel <= 1e-4, rel


def _agreement(ig, ic, k: int = K_CMP) -> float:
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(ig, ic)]))


def _crud_card_vs_cpu(gpu, cpu, queries) -> None:
    """The 20k index and its probe state (from _ivf_card_vs_cpu) mutated
    alike on the card and on the CPU: 500 added rows, 400 deleted ids (the
    first 20 queries' top-1 among them); then the decoded, codes and IVF
    tiers searched on both."""
    from vaq_tpu_torch import data
    added, _ = data.make_anisotropic_gaussian(500, D_MAIN, 0, seed=SEED + 1)
    _, top1 = cpu.search(queries[:20], 1, backend="decoded")
    rng = np.random.default_rng(SEED)
    dead = np.unique(np.concatenate([top1[:, 0], rng.choice(N_CMP + 500, 380,
                                                            replace=False)]))
    for idx in (gpu, cpu):
        idx.add(added)
        idx.delete(dead)
    assert torch.equal(gpu.ivf.state.bucket_ids.cpu(), cpu.ivf.state.bucket_ids)
    assert torch.equal(gpu.ivf.state.sizes.cpu(), cpu.ivf.state.sizes)
    for backend in ("decoded", "codes", "ivf"):
        dg, ig = gpu.search(queries, K_CMP, backend=backend)
        dc, ic = cpu.search(queries, K_CMP, backend=backend)
        agree = _agreement(ig, ic)
        log(f"[cmp] crud {backend}: top-{K_CMP} id agreement card vs cpu "
            f"{agree:.4f}, deleted ids returned {int(np.isin(ig, dead).sum())}")
        assert agree >= 0.99, (backend, agree)
        assert not np.isin(ig, dead).any() and not np.isin(ic, dead).any()
        if backend == "ivf":
            assert (ig < N_CMP).all() and (ic < N_CMP).all()


def _wide_card_vs_cpu(method: str, kmeans_flag: str) -> None:
    """A 20k index of ``method`` trained on the card with the hierarchical
    or binary-split k-means, its decoded tier searched on the card and on
    the CPU."""
    import vaq_tpu_torch as vt
    from vaq_tpu_torch import data
    from vaq_tpu_torch.convert import index_from_numpy
    base, queries = data.make_anisotropic_gaussian(N_CMP, D_MAIN, NQ_CMP,
                                                   seed=SEED + 4)
    cfg = dataclasses.replace(vt.parse_method_string(method),
                              **{kmeans_flag: True})
    trained = vt.VAQIndex(cfg, device=DEVICE)
    _step(f"train {method} ({kmeans_flag}) at {N_CMP} rows",
          lambda: trained.train(base), tag="cmp")
    assert (trained.bits > 8).any(), trained.bits   # the wide fit ran
    trained.encode(base)
    arrays, meta = trained.state()
    gpu = index_from_numpy(arrays, meta, DEVICE)
    cpu = index_from_numpy(arrays, meta, "cpu")
    dg, ig = gpu.search(queries, K_CMP, backend="decoded")
    dc, ic = cpu.search(queries, K_CMP, backend="decoded")
    agree = _agreement(ig, ic)
    log(f"[cmp] {kmeans_flag} {method}: bits {trained.bits.tolist()}; top-{K_CMP} "
        f"id agreement card vs cpu {agree:.4f}, max rel Δdist "
        f"{float(np.max(np.abs(dg - dc) / dc)):.3g}")
    assert agree >= 0.99, (method, agree)
    np.testing.assert_allclose(dg, dc, rtol=1e-4)


def _bitalloc_card_vs_cpu(method: str) -> None:
    """A reading, not a check (ROADMAP fault 14): the rotation of ``method``
    trained on the card and on the CPU from the 20k rows of
    ``_wide_card_vs_cpu``, with the last cumulative variance, which the
    min-bits bound compares with percent_var_explained = 1.0, the smallest
    eigenvalue and the bits each device's spectrum gives."""
    import vaq_tpu_torch as vt
    from vaq_tpu_torch import bitalloc, data
    base, _ = data.make_anisotropic_gaussian(N_CMP, D_MAIN, NQ_CMP,
                                             seed=SEED + 4)
    cfg = vt.parse_method_string(method)
    for dev in (DEVICE, "cpu"):
        idx = vt.VAQIndex(cfg, device=dev)
        idx._train_rotation(base)
        cum = idx.cum_var_per_subs[: idx.highest_subs]
        bits = bitalloc.allocate_bits(
            idx.var_per_subs[: idx.highest_subs], cfg.bit_budget,
            cfg.min_bits, cfg.max_bits, cum_var=cum,
            percent_var_explained=cfg.percent_var_explained)
        log(f"[cmp] bit allocation {method} on {dev}: last cum_var - 1 = "
            f"{float(cum[-1]) - 1.0!r}, eigvals min {float(idx.eigvals.min())!r}"
            f" max {float(idx.eigvals.max())!r}, bits {bits.tolist()}")


def _fast_card_vs_cpu() -> None:
    """A 20k FAST state, its LUT quantizers learned on the card, searched on
    the card and on the CPU through fast4 (K3 without the quantizers, K4
    with them) and the LUT gather scan."""
    import vaq_tpu_torch as vt
    from vaq_tpu_torch import data
    from vaq_tpu_torch.convert import index_from_numpy
    base, queries = data.make_anisotropic_gaussian(N_CMP, D_MAIN, NQ_CMP,
                                                   seed=SEED + 3)
    trained = vt.VAQIndex(vt.parse_method_string(FAST_METHOD),
                          device=DEVICE).build(base)
    trained.learn_quantization(base, 0.1)
    arrays, meta = trained.state()
    plain = {k: v for k, v in arrays.items() if not k.startswith("lut_")}
    for what, state, backend in (("fast4 K3", plain, "fast4"),
                                 ("fast4 K4", arrays, "fast4"),
                                 ("lut_gather", arrays, "lut_gather")):
        gpu = index_from_numpy(state, meta, DEVICE)
        cpu = index_from_numpy(state, meta, "cpu")
        dg, ig = gpu.search(queries, K_CMP, backend=backend)
        dc, ic = cpu.search(queries, K_CMP, backend=backend)
        agree = float(np.mean([len(set(ig[q]) & set(ic[q])) / K_CMP
                               for q in range(NQ_CMP)]))
        log(f"[cmp] FAST {what}: top-{K_CMP} id agreement card vs cpu "
            f"{agree:.4f}, ids equal on {float((ig == ic).mean()):.4f} of "
            f"entries, max rel Δdist {float(np.max(np.abs(dg - dc) / dc)):.3g}")
        assert (ig >= 0).all() and agree >= 0.99, (what, agree)
        np.testing.assert_allclose(dg, dc, rtol=1e-4)


def _binary_card_vs_cpu() -> None:
    """One BinaryIndex(256) state at 20k, trained on the host, searched on
    the card and on the CPU: packed, matmul, Jaccard, both filters and the
    cluster probe (built on the card, copied to the CPU) return identical
    ids and distances."""
    from vaq_tpu_torch import binary, data
    from vaq_tpu_torch.convert import (binary_index_from_numpy,
                                       hamming_clusters_from_numpy)
    base, queries = data.make_anisotropic_gaussian(N_CMP, D_MAIN, NQ_CMP,
                                                   seed=SEED + 4)
    gpu = binary.BinaryIndex(bit_budget=BIN_BUDGET, device=DEVICE).train(base)
    gpu.encode(base)
    cpu = binary_index_from_numpy(*gpu.state(), "cpu")
    st = binary.build_hamming_clusters(gpu, base, 64, iters=10, device=DEVICE)
    st_cpu = hamming_clusters_from_numpy({
        "centroids": st.centroids, "cap": st.cap,
        "bucket_words": st.bucket_words.cpu().numpy().view(np.uint32),
        "bucket_ids": st.bucket_ids.cpu().numpy(),
        "sizes": st.sizes.cpu().numpy()}, "cpu")
    runs = {
        "packed": lambda i: i.query(queries, 100, backend="packed"),
        "matmul": lambda i: i.query(queries, 100, backend="matmul"),
        "jaccard": lambda i: i.query(queries, 100, metric="jaccard"),
        "filtering": lambda i: i.query_filtering(base[:NQ_CMP], 10, 4),
        "filtering_heap": lambda i: i.query_filtering_heap(base[:NQ_CMP], 10, 4),
    }
    for n_probe in (4, 64):
        runs[f"probe n_probe={n_probe}"] = (
            lambda i, n_probe=n_probe: binary.query_hamming_clusters(
                i, st if i is gpu else st_cpu, queries, 100, n_probe))
    for what, run in runs.items():
        g, c = run(gpu), run(cpu)
        for a, b in zip(g, c):
            np.testing.assert_array_equal(a, b)
        log(f"[cmp] binary {what}: ids and distances identical card vs cpu")


def phase_card_vs_cpu() -> None:
    """One converted state searched on the card and on the CPU."""
    import vaq_tpu_torch as vt
    from vaq_tpu_torch import data
    from vaq_tpu_torch.convert import index_from_numpy
    base, queries = data.make_anisotropic_gaussian(N_CMP, D_MAIN, NQ_CMP,
                                                   seed=SEED + 1)
    trained = vt.VAQIndex(vt.parse_method_string(METHOD), device=DEVICE).train(base)
    trained.encode(base)
    arrays, meta = trained.state()
    gpu = index_from_numpy(arrays, meta, DEVICE)
    cpu = index_from_numpy(arrays, meta, "cpu")
    for backend in ("decoded", "codes"):
        dg, ig = gpu.search(queries, K_CMP, backend=backend)
        dc, ic = cpu.search(queries, K_CMP, backend=backend)
        agree = float(np.mean([len(set(ig[q]) & set(ic[q])) / K_CMP
                               for q in range(NQ_CMP)]))
        log(f"[cmp] {backend}: top-{K_CMP} id agreement card vs cpu {agree:.4f}, "
            f"max rel Δdist {float(np.max(np.abs(dg - dc) / dc)):.3g}")
        assert agree >= 0.99, (backend, agree)
        np.testing.assert_allclose(dg, dc, rtol=1e-4)
    _, cand = cpu.search(queries, 2 * K_CMP)
    dg, ig = gpu.refine(queries, cand, base, K_CMP)
    dc, ic = cpu.refine(queries, cand, base, K_CMP)
    np.testing.assert_allclose(dg, dc, rtol=1e-4)
    log(f"[cmp] refine: ids equal on {float((ig == ic).mean()):.4f} of entries")
    _ivf_card_vs_cpu(gpu, cpu, queries, 16)
    _crud_card_vs_cpu(gpu, cpu, queries)
    # d = 96, the shape JAX stored transposed for its K6/K8
    base96, queries96 = data.make_anisotropic_gaussian(N_CMP, 96, NQ_CMP,
                                                       seed=SEED + 2)
    m96 = "VAQ192m24min7max8var1,HEAP"
    trained = vt.VAQIndex(vt.parse_method_string(m96), device=DEVICE).build(base96)
    arrays, meta = trained.state()
    _ivf_card_vs_cpu(index_from_numpy(arrays, meta, DEVICE),
                     index_from_numpy(arrays, meta, "cpu"), queries96, 24)
    _fast_card_vs_cpu()
    _wide_card_vs_cpu(WIDE_METHOD, "hierarchical_kmeans")
    _wide_card_vs_cpu(BINARY_METHOD, "binary_kmeans")
    _bitalloc_card_vs_cpu("VAQ128m16min7max9var1,HEAP")
    _binary_card_vs_cpu()


def _kernel_counts(zero: bool = False) -> dict:
    """Every kernel's launch counter, by the counter names of the kernels
    line (K3 and K4 apart); with ``zero``, set them to 0 first."""
    from vaq_tpu_torch.ops import (hamming, probe_scan, rescore, scan_codes,
                                   scan_decoded)
    fns = {"decode_window_scan": scan_codes.decode_window_scan,
           "decode_rescore": scan_codes.decode_rescore,
           "groupmin_window_scan": probe_scan.groupmin_window_scan,
           "gather_rescore": rescore.gather_rescore,
           "popcount_dists": hamming.popcount_dists,
           "decoded_topk_scan": scan_decoded.decoded_topk_scan}
    f4 = scan_codes.fast4_window_scan.launches
    if zero:
        for fn in fns.values():
            fn.launches = 0
        f4.update(K3=0, K4=0)
    return {**{n: fn.launches for n, fn in fns.items()},
            "fast4_window_scan": f4["K3"], "fast4_window_scan_int8": f4["K4"]}


def _counter_of(name: str) -> str:
    """The launch counter of a kernels-line entry: its kernel's."""
    if name.startswith("fast4_window_scan"):
        return "fast4_window_scan" + ("_int8" if "_int8" in name else "")
    return next(n for n in _kernel_counts() if name.startswith(n))


def phase_kcheck(idx, queries, what: str, form: str) -> dict:
    """``kernel_check.kernel_parity_fields`` on ``idx`` with its first
    KCHECK_NQ queries: every kernel against its plain version on the card
    (K1 at 64/32/16-row windows, K2, K3 in ``form``, K4 where the index
    learned its LUT quantization, K5 at JAX's four shapes, K7 at its three,
    H1 xor and Jaccard, D1 at kk = 26 and 200); its fields logged,
    ``kernel_parity_ok`` required.
    Returns the launches, counted from 0 around the call."""
    from vaq_tpu_torch.ops import kernel_check, scan_codes
    m, c = idx.centroids.shape[:2]
    assert scan_codes._fast4_form(m, c, False, KCHECK_NQ, 64).kind == form
    _kernel_counts(zero=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fields = kernel_check.kernel_parity_fields(idx, queries[:KCHECK_NQ])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _kernel_counts()
    log(f"[kcheck] {what}: {json.dumps(fields)}")
    log(f"[kcheck] {what}: {dt:.3f} s, K3 in the {form} form, launches {counts}")
    assert fields["kernel_parity_ok"] is True, fields
    want = {"decode_window_scan": 3, "decode_rescore": 1,
            "groupmin_window_scan": 4, "gather_rescore": 3,
            "popcount_dists": 4, "decoded_topk_scan": 2,
            "fast4_window_scan_int8": int(idx.lut_offsets is not None)}
    assert {n: counts[n] for n in want} == want, counts
    assert counts["fast4_window_scan"] >= 1, counts
    return counts


def phase_bench() -> tuple[dict, dict]:
    """``python3 bench_torch.py`` with BENCH_ARGS as a subprocess: its one
    stdout line must parse within 1900 characters with no ``_error`` field,
    ``kernel_parity_ok`` true, every QPS above 0 and refine no worse than
    ADC recall; its sidecar must show the gate's launches in
    ``kernel_parity``, K1/K2 in ``capacity`` and ``serving_codes`` and K5/K7
    in ``ivf``, and its codes and IVF steps at the shapes phase 3 holds
    (K1_SHAPES' last two, K5 at BENCH_QCAP, K7 at BENCH_NQ × BENCH_WIN).
    Returns the run's launches by kernel, and those steps' launches by the
    name of phase 3's entry at their shape."""
    root = os.path.dirname(os.path.abspath(__file__))
    sidecar = os.path.join(root, ".bench_cache", "torch", "last_full.json")
    if os.path.exists(sidecar):
        os.remove(sidecar)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "bench_torch.py", *BENCH_ARGS],
                          cwd=root, capture_output=True, text=True,
                          timeout=BENCH_LIMIT_S)
    dt = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"[bench] {line}")
    assert proc.returncode == 0, f"bench_torch.py exited {proc.returncode}"
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1 and len(lines[0]) <= 1900, lines
    log(f"[bench] line: {lines[0]}")
    line = json.loads(lines[0])
    assert not [k for k in line if k.endswith("_error")], line
    assert line["kernel_parity_ok"] is True, line
    qps = {k: v for k, v in line.items() if k.endswith("_qps")}
    assert set(BENCH_QPS) <= set(qps) and min(qps.values()) > 0 and \
        line["value"] > 0, qps
    assert line["recall_at_10_refined"] >= line["recall_at_10"], line
    with open(sidecar) as f:
        full = json.load(f)
    # a sweep without a knee (the first 2000/s not kept up with) has no knee
    # field; the sweep itself must be there
    assert "serving_sweep" in full and "codes_serving_sweep" in full
    by_section = full["launches_by_section"]
    log(f"[bench] {' '.join(BENCH_ARGS)}: exit 0 in {dt:.1f} s; sections "
        f"(s): {json.dumps(full['section_s'])}")
    log(f"[bench] launches by section: {json.dumps(by_section)}")
    gate = by_section["kernel_parity"]
    assert {n: gate.get(n, 0) for n in BENCH_GATE_LAUNCHES} == \
        BENCH_GATE_LAUNCHES and gate.get("fast4_window_scan", 0) >= 1, gate
    for section, kernels in (("capacity", ("decode_window_scan",
                                           "decode_rescore")),
                             ("serving_codes", ("decode_window_scan",
                                                "decode_rescore")),
                             ("ivf", ("groupmin_window_scan",
                                      "gather_rescore"))):
        assert all(by_section[section].get(n, 0) > 0 for n in kernels), \
            (section, by_section[section])
    shapes = full["kernel_shapes"]
    log(f"[bench] kernel shapes: {json.dumps(shapes)}")
    at_shape = {}
    for step, shape in (("codes", K1_SHAPES[6]), ("fast4", K1_SHAPES[7])):
        got = shapes[step]
        assert tuple(got[k] for k in ("n", "M", "C", "L", "nq", "block_rows")
                     ) == shape, (step, got)
        at_shape[_k1_name(shape)] = got["launches"].get("decode_window_scan", 0)
    (visit,) = shapes["ivf"]["visits"]
    assert (visit["ncl"], visit["cap"], visit["d"], visit["rows_dtype"],
            visit["nq"], visit["qcap"], visit["gs"], visit["windows"]) == \
        (KC_NCL, KC_CAP, D_MAIN, "torch.int8", BENCH_NQ, BENCH_QCAP, KC_GS,
         BENCH_WIN), visit
    ivf = shapes["ivf"]["launches"]
    at_shape[f"groupmin_window_scan_q{BENCH_QCAP}"] = \
        ivf.get("groupmin_window_scan", 0)
    at_shape[f"gather_rescore_q{BENCH_NQ}_w{BENCH_WIN}"] = \
        ivf.get("gather_rescore", 0)
    assert min(at_shape.values()) > 0, at_shape
    return full["launches"], at_shape


def phase_deep100m() -> tuple[dict, list[dict]]:
    """DEEP-100M through ``scripts/capacity_100m_torch.py``'s ``run()``;
    returns the launches of K1/K2 (counted over the codes tier), D1 (over
    the ``auto`` tier) and K5/K7 (over the visit sweep), and the entries of
    those kernels held against their plain versions on the path's own
    data (D1's by ``run()`` itself, on the bf16 tier it then released)."""
    from vaq_tpu_torch import ivf
    capacity = _script("capacity_100m_torch")
    t0 = time.perf_counter()
    out, idx, state, qp = capacity.run(n=DEEP_N, d=DEEP_D, queries=DEEP_NQ,
                                       k=DEEP_K, batch=DEEP_NQ, device=DEVICE)
    wall = time.perf_counter() - t0
    st = out["stages"]
    log(f"[deep100m] wall {wall:.1f} s; stages (s): " + ", ".join(
        f"{name} {rec['wall_s']:.2f}" for name, rec in st.items()))
    for name, rec in st.items():
        if "qps" in rec or "recall_at_k" in rec:
            log(f"[deep100m] {name}: " + (f"{rec['qps']:.1f} QPS, "
                                          if "qps" in rec else "")
                + f"avg_recall@{DEEP_K} {rec['recall_at_k']:.4f}, peak "
                f"{rec['peak_bytes'] / 2**30:.2f} GiB")
    b = st["ivf_build"]
    gs = ivf.pick_gs(state.cap)
    log(f"[deep100m] probe build: cap {b['cap']} (gs {gs}), live sizes "
        f"{b['sizes_min']}-{b['sizes_max']}, {b['spilled']} rows spilled "
        f"outside their 4 nearest clusters; passes: k-means "
        f"{b['centroids_s']:.2f} s, nearest clusters {b['candidates_s']:.2f} s, "
        f"capacity fill and slots {b['assign_s']:.2f} s, int8 fill "
        f"{b['fill_s']:.2f} s")
    res = out["resident_bytes"]
    peak = max(st[f"ivf_visit{v}"]["peak_bytes"] for v in (0.25, 0.1, 0.05))
    log(f"[deep100m] resident during the sweep: codes {res['codes'] / 1e9:.2f} "
        f"GB, int8 tier {res['decoded8'] / 1e9:.2f} GB, buckets "
        f"{res['buckets'] / 1e9:.2f} GB; peak with K5's output "
        f"{peak / 2**30:.2f} GiB")
    log(f"[deep100m] {json.dumps(out)}")
    launches = out["launches"]
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the 100M path"
    assert idx.codes is not None and idx.decoded8 is not None
    assert gs == KD_GS and b["cap"] == state.cap == KD_CAP, (gs, b)
    rec = {name: r["recall_at_k"] for name, r in st.items() if "recall_at_k" in r}
    assert all(0.0 < r <= 1.0 for r in rec.values()), rec
    assert rec["ivf_visit0.25"] >= rec["ivf_visit0.05"], rec
    assert rec["refine500"] >= rec["refine100"] >= rec["decoded8"], rec
    d1_entry = _deep100m_d1_entry(st["d1"], idx.codes.shape[0], qp.shape[0])
    # every structure still resident; one visit-0.1 batch split by stage
    _profile_split("deep100m", f"visit 0.1, {qp.shape[0]} queries",
                   lambda: ivf.IVFSearcher(state, 0.10).search(idx, qp, DEEP_K),
                   ("ivf.probe", "ivf.groupmin", "ivf.merge", "ivf.rescore",
                    "ivf.second_stage"), reps=5)
    entries = [d1_entry] + _check_deep100m_kernels(idx, state, qp)
    return ({"decode_window_scan_100m": launches["decode_window_scan"],
             "decode_rescore_100m": launches["decode_rescore"],
             "decoded_topk_scan_100m": launches["decoded_topk_scan"],
             f"groupmin_window_scan_d{DEEP_D}_gs{KD_GS}":
                 launches["groupmin_window_scan"],
             f"gather_rescore_d{DEEP_D}_gs{KD_GS}": launches["gather_rescore"]},
            entries)


def _deep100m_d1_entry(held: dict, n: int, nq: int) -> dict:
    """The kernels entry of D1 on the 100M path's bf16 tier from ``run()``'s
    ``d1`` stage: its check must hold and have found rows past 2^31 bytes;
    timed beside its bound (the products at the bf16 peak, or the rows,
    norms and queries read, whichever is longer) and the plain scan. No
    library time: a bf16 ``torch.mm`` of 1024 × 100M needs a 205 GB
    output."""
    detail = held["d1_detail"]
    assert held["d1_check"], f"D1 at 100M: {detail}"
    assert held["rows_past_2_31_bytes"] > 0, held
    kk = held["kk"]
    ops = 2.0 * nq * n * DEEP_D
    bound = _bound(n * DEEP_D * 2 + n * 4 + nq * DEEP_D * 2, ops, "bf16")
    log(f"[deep100m] D1 decoded_topk_scan n={n} d={DEEP_D} nq={nq} kk={kk} "
        f"on the bf16 tier: {detail}, {held['rows_past_2_31_bytes']} "
        f"candidates past 2^31 bytes, kernel {held['d1_ms']:.3f} ms "
        f"({100 * bound[0] / held['d1_ms']:.1f}% of the bound), plain "
        f"{held['plain_ms']:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    entry = _entry("decoded_topk_scan_100m",
                   "vaq_tpu_torch/csrc/decoded_topk_scan.cu",
                   "none (XLA's GEMM and approx_max_k, vaq_tpu/ops/scan_decoded.py:48-76)",
                   detail.get("max_excess_over_tol", 0.0), held["d1_ms"],
                   held["plain_ms"], bound, None)
    entry["queries_differing"] = detail["queries_differing"]
    return entry


def _check_deep100m_kernels(idx, state, qp) -> list[dict]:
    """K1/K2/K5/K7 held against their plain versions on the 100M path's
    resident codes and buckets, where row × M and slot × d offsets pass
    2^31 (3.2 GB of codes, 9.8 GB of int8 rows), with the path's queries,
    decode table, 512-row windows, k and visit-0.25 slots:

    - K1 over all 100M codes and the 1024 queries, held to the size of
      its terms (no library time: one GEMM against the 19.2 GB bf16 decode
      and its 1024 × 100M output does not fit beside the resident tiers);
    - K2 on the candidates the codes tier rescores (each query's top-2k
      windows' winners), one column replaced by the database's last rows
      and one by −1;
    - K5 over all 1000 buckets with live slots only in the last
      ``KD_LIVE`` clusters (n_slots 0 elsewhere, as a cluster no query
      probes), so the f64 term sizes stay affordable; the slabs are the
      path's scale-folded queries;
    - K7 on m = max(2k, 16) windows a query over all 400,000 windows, one
      column the last windows of the buckets."""
    from vaq_tpu_torch import ivf
    from vaq_tpu_torch.ops import scan_codes
    dev = qp.device
    nq = qp.shape[0]
    n = idx.codes.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    table, rows = idx._codes_tier()
    br = idx._codes_block_rows(DEEP_K)
    entry, scores, ids = _held_k1(idx.codes, table, qp, br,
                                  "decode_window_scan_100m", tag="deep100m",
                                  library=False, reps=5, plain_reps=1,
                                  of_terms=True)
    entries = [entry]
    scores = torch.where(ids >= n, torch.inf, scores)
    _, pos = scan_codes._select_lowest(scores, 2 * DEEP_K)
    cand = torch.gather(ids, 1, pos).contiguous()
    del scores, ids
    cand[:, -2] = n - 1 - torch.arange(nq, device=dev, dtype=torch.int32)
    cand[:, -1] = -1
    entries.append(_held_k2(idx.codes, cand, rows, qp, "decode_rescore_100m",
                            tag="deep100m"))
    torch.cuda.empty_cache()

    ncl, cap = state.bucket_ids.shape
    d = state.d_full
    _, _, qcap, gs = ivf.IVFSearcher(state, 0.25).params(DEEP_K, nq)
    q_eff = (qp / state.dim_scales[None, :]).contiguous()
    w = 1.0 / (state.dim_scales * state.dim_scales)
    rows_flat = state.bucket_rows.view(ncl * cap, d)
    n_slots = torch.zeros((ncl,), dtype=torch.int32, device=dev)
    n_slots[-KD_LIVE:] = torch.clamp(torch.round(
        KD_SLOTS + 12.0 * torch.randn((KD_LIVE,), generator=gen, device=dev)),
        1, qcap).to(torch.int32)
    who = torch.randint(0, nq, (ncl, qcap), generator=gen, device=dev)
    qsl = (-2.0 * q_eff)[who].to(torch.bfloat16)
    del who
    entries.append(_held_groupmin(
        (qsl, rows_flat, w, ncl, cap, gs, n_slots),
        f"groupmin_window_scan_d{d}_gs{gs}_100m",
        f"the resident {ncl} buckets of {cap} int8 rows, d={d}, gs={gs}, "
        f"qcap={qcap}", tag="deep100m", library=False, plain_reps=1))
    del qsl
    torch.cuda.empty_cache()
    n_blk = ncl * cap // gs
    m = max(2 * DEEP_K, 16)
    wblk = torch.randint(0, n_blk, (nq, m), generator=gen, device=dev,
                         dtype=torch.int32)
    wblk[:, 0] = n_blk - 1 - torch.arange(nq, device=dev, dtype=torch.int32) % 64
    entries.append(_held_rescore(
        (q_eff, w, rows_flat, wblk, gs), f"gather_rescore_d{d}_gs{gs}_100m",
        f"the resident buckets, d={d} int8 rows, {m} windows of {gs}",
        tag="deep100m"))
    torch.cuda.empty_cache()
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test runs only on a CUDA card", file=sys.stderr)
        return 2
    smi = phase_environment()
    phase_build()
    log(f"[kernels] clocks.sm, clocks.max.sm, power.draw, temperature: {_clocks()}")
    kernels = phase_kernels()
    log(f"[kernels] clocks.sm, clocks.max.sm, power.draw, temperature: {_clocks()}")
    launches, ctx = phase_main_path()
    r_main = ctx["r_dec"]
    kcheck = phase_kcheck(ctx["idx"], ctx["queries"], "HEAP", "gather")
    launches.update(phase_ivf_path(ctx))
    by_path = phase_serve(ctx)
    shard = phase_shard(ctx)
    assert "decode_window_scan_br32" in shard, "no shard count gave 32-row windows"
    launches["decode_window_scan_br32"] = shard.pop("decode_window_scan_br32")
    by_path.update(shard)
    torch.cuda.empty_cache()
    check_launches, check_kernels = phase_checks(ctx)
    launches.update(check_launches)
    kernels += check_kernels
    torch.cuda.empty_cache()
    phase_crud(ctx)
    ctx["idx"] = None
    torch.cuda.empty_cache()
    launches.update(phase_fast_path(ctx))
    fast_kcheck = phase_kcheck(ctx.pop("fast_idx"), ctx["queries"], "FAST",
                               "mma")
    kcheck = {n: kcheck[n] + fast_kcheck[n] for n in kcheck}
    torch.cuda.empty_cache()
    phase_wide(ctx)
    torch.cuda.empty_cache()
    bin_launches, bin_kernels = phase_binary(ctx)
    launches.update(bin_launches)
    kernels += bin_kernels
    del ctx
    torch.cuda.empty_cache()
    by_path.update(phase_cli(r_main))
    # every K1 launch of [cli]'s codes run is at 16-row windows
    launches["decode_window_scan_br16"] = by_path["cli"]["decode_window_scan"]
    phase_card_vs_cpu()
    torch.cuda.empty_cache()
    bench, bench_at_shape = phase_bench()
    # the launches of [bench]'s codes and IVF steps, at the shapes of phase
    # 3's entries of those names
    launches.update(bench_at_shape)
    deep_launches, deep_kernels = phase_deep100m()
    launches.update(deep_launches)
    kernels += deep_kernels
    for kern in kernels:
        # a d = 96, bf16 or C = 256 check is the same kernel as the main
        # path's: the longest counter name that prefixes the check's
        name = max((n for n in launches if kern["name"].startswith(n)), key=len)
        kern["launches"] = launches[name]
        # the serving, sharded and CLI paths' launches of the main path's
        # kernels, each counted from 0 around its path
        if kern["name"] in ("decode_window_scan", "decode_rescore",
                            "groupmin_window_scan", "gather_rescore"):
            kern["launches_by_path"] = {
                path: counts[kern["name"]] for path, counts in by_path.items()
                if kern["name"] in counts}
        # the gate's launches of the entry's kernel, at the gate's shapes
        kern.setdefault("launches_by_path", {})["kcheck"] = \
            kcheck[_counter_of(kern["name"])]
        # bench_torch.py's, over its whole run (its own gate call included)
        kern["launches_by_path"]["bench"] = \
            bench.get(_counter_of(kern["name"]), 0)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
