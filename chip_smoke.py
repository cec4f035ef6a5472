"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel under ptranking_tpu_torch/ops/csrc/ with nvcc
     (all started together);
  3. kernels: each kernel against its plain torch version on the card, at the
     shapes the serving and training paths give it and at edge shapes, with
     times for the kernel, the plain version and one PyTorch library call of
     the same function where there is one: the flash attention forward (bf16
     and fp32, against the plain blockwise attention and against the explicit
     plain forward with its row statistics), its backward (dk/dv and dq
     kernels, against autograd through the plain blockwise attention and
     against the explicit plain backward), at head dims up to 128 (fp32: the
     forward and backward on 3xTF32 tensor-core products; the fp32 forward
     also at every d of 1..128, the same bits twice) and, through the wide
     kernels, above; the packed backward of bf16 lists of at most 64
     docs at head dims above 128 (dq, dk, dv of several lists a block, one
     launch) and the list backward (the same on a 128-row tile of one list
     of 65..128 docs) against both explicit plain backwards, the same bits
     twice, timed beside the wide pair they replace and SDPA's backward; the
     long backward (one list of 129..256 docs a block, its keys in two
     halves) likewise; the packed forward of bf16 lists of at most 128 docs
     at head dims above 128 (S once a tile) and the long forward (lists of
     129..256 docs, S once in two halves of keys) against both explicit
     plain forwards and their row statistics, the same bits twice, timed
     beside the wide forward they replace and SDPA; the fp32 packed forward
     and backward (lists of at most 64 docs at head dims above 128, 3xTF32
     tensor-core products), the fp32 list and long backward (lists of
     65..256 docs, one a block, 3xTF32) and the fp32 list forward (lists of
     65..256 docs, one a 128- or 256-row tile, S once in slices of 64 keys,
     3xTF32) likewise, timed beside the fp32 wide kernels and SDPA in fp32
     (TF32 off); the fp32 wide forward and dk/dv and dq kernels (3xTF32,
     every fp32 list past 256 docs at d > 128: a block's 64 rows and all of
     their output columns, S and dP once a tile) at 257..1536 docs x
     d = 129..700 with a one-doc and an all-padded list against both plain
     versions, the same bits twice, and timed beside SDPA at the one-head
     MSLR-WEB30K listsf's shapes and at d = 350 and 384; the bf16
     forward and backward run on the tensor cores; no instantiation of an
     attention kernel may spill; the fused
     pairwise lambda loss (forward and backward, LambdaRank and RankNet, the
     same bits on two runs); shapes past grid.y's 65535 (attention at
     B*H = 65538 in two launches of whole lists, the pairwise loss at
     B = 70000 folded into grid.x); and the Sinkhorn half-step (both orientations, then 20
     iterations of scalings);
  4. serve: the flagship ranker (F=136 DASALC listsf, 6 layers, 2 heads, bf16,
     flash_attn=True) from a seeded init, saved as a .pt checkpoint, served over
     HTTP on a local port; the answers are held against the same ranker with
     dense torch attention, and the kernel's launch count must grow by 6 per
     served batch; then score_file writes a TREC run from a LETOR file;
  5. train: the same model trained with LambdaRank through the fused loss
     (model_paras use_pallas=True), Adagrad at lr 1e-3: (a) one step's
     gradients through the kernels against dense attention and the dense
     loss; (b) timed steps at 32 lists of 1408 docs, with exact launch counts
     per step, in bf16 and in fp32 (the fp32 forward and backward on
     3xTF32); (c) one
     train_epoch over ragged lists; (d) save, restore into a
     second ranker, and one more step on both;
  6. wassrank: the same model trained with WassRank (SinkhornOT, 20
     iterations, lam 0.1, the `eg` cost), every Sinkhorn half-step through
     the kernel: (a) one step's gradients against the same step on the plain
     half-step; (b) timed steps at 32 lists of 1408 docs with exact launch
     counts (40 half-steps per step); (c) evaluate (nDCG, nERR, AP, P at
     each k) on ragged lists, one train_epoch, evaluate again; (d) save,
     restore, one more step on both;
  7. wide: the same DASALC listsf at head dims above 128 (the wide attention
     kernels): at Yahoo! LTR's 700 features (2 heads of 350, and of 384
     under lane_align) and at 136 features with one head (136), LambdaRank
     through the fused loss: served over HTTP, one step's gradients against
     dense attention (in the 128-doc bucket, and Yahoo!'s also at 32 docs),
     timed steps of 32,768 docs in each of Yahoo!'s buckets of 16 to 256 docs
     (the one-head model: 256 lists of 128) with exact launch counts (the
     packed forward up to FWD_PACK_MAX_N docs, the long forward up to
     LONG_MAX_N, the wide forward above; the packed backward up to
     PACK_MAX_N docs, the list backward up to LIST_MAX_N, the long backward
     up to LONG_MAX_N, the wide pair above), save, restore and step; the
     one-head model's fp32 gradients also at 512 docs and its fp32 steps
     timed at 32 lists of 1408 docs with exact launch counts (the fp32 wide
     forward and dk/dv and dq kernels, 3xTF32);
     then the Yahoo! model at d = 350 in fp32, timed in the buckets of 16 to
     256 docs (the fp32 packed forward and backward up to F32_PACK_MAX_N
     docs; the fp32 list forward up to F32_FWD_LIST_MAX_N and
     F32_FWD_LONG_MAX_N docs, through the packed and the long forward's
     wrappers; the fp32 list backward up to F32_LIST_MAX_N docs, the long
     backward up to F32_LONG_MAX_N);
  8. resident: the flagship ranker on device-resident data: (a) 1,024
     synthetic lists of 20..1408 docs at F=136 uploaded once (bf16
     features), two epochs at 32 x 1408 docs a batch trained from the
     resident buckets (each batch gathered on the card from an index chunk)
     and, from the same seed, streamed from the host: the same losses and
     params, exact launch counts; epoch time, lists/s, idle share and the
     host->device copies and bytes of one profiled epoch each way (the
     resident one's: the index chunks the host copied and nothing else, one
     of them missed at most, `profile_index_copies`), and
     the same at the CLI's 100 docs a batch; (b) `python -m
     ptranking_tpu_torch.ltr` (its main) on LETOR files at F=136, 2 folds
     x 2 epochs, validation on: finite CV metrics in the run's log, the
     launches the batches predict, and a run stopped after fold 1's first
     epoch and resumed gives the same metrics, bit for bit; (c) the bf16
     linear_apply (bf16 x bf16 products with fp32 accumulation, the dtype
     overload of torch.mm) against its fp32 plain version at the
     flagship's and Yahoo!'s layer shapes: the output within one bf16 ulp,
     dx and dw within the bf16 backward gate;
  9. serving_rest: (a) the flagship checkpoint of phase 4 served with
     `-quantize int8` over HTTP and through score_file (int8 weights,
     per-token activation scales, `torch._int_mm`): the card's scores
     against the CPU plain int8 path at the served-score gate, their
     distance from the bf16 served scores, 6 forward launches a batch, every
     linear an `aten::_int_mm` and no floating-point product in a profiled
     batch, ms a batch int8 beside bf16; (b) the same checkpoint exported
     (`ptranking_tpu_torch.export`, plain and int8, for cuda, the buckets of
     32..512 docs) and served the request's lists of at most 400 docs over
     HTTP and through score_file: the checkpoint's scores within the
     gate, the forward kernel's launches during the replay, export time and
     size; (c) the native GBDT at MSLR-WEB30K's width (F = 136, 64 bins,
     depth 8) on about 2.26 M docs: two fits from the same binned data grow
     the same trees, s a tree (host objective, card growth), the idle share
     of a profiled tree, a dyadic tree equal to the CPU plain path's, and
     `ltr.main -model LightGBMLambdaMART` end to end; (d) the native LETOR
     parser: equal to the Python parser, used by load_letor_file, its rows/s
     and `data.stats`;
 10. diversification, at the JAX package's widths for the branch (D = 100,
     the pointsf 5 x 100, the listsf AttnDIN 6 layers x 6 heads on 300, fp32,
     8 queries a batch): (a) the pointsf, listsf, listsf_co, pointsf at K = 5
     and as a cluster of 5, card against CPU on the same params (mus, vars,
     cocos, the three sort modes); (b) one step's gradients of every
     DIV_LOSSES key (opt_ideal=False for SuperSoft and LambdaPairCLS), card
     against CPU; (c) DALETOR (listsf) and DivProbRanker (SuperSoft-aNDCG,
     pointsf) trained two epochs from device-resident buckets and streamed
     from the host, 512 SyntheticDiv queries of 10..250 docs presorted on
     the card: the same losses and params bit for bit, queries/s each way,
     the idle share and host->device copies of DALETOR's profiled resident
     epoch (the index chunks the host copied, one missed at most); (d) aNDCG,
     ERR-IA, nERR-IA on the card against the CPU on the same scores, ndeval
     built by the port's builder on the trained ranker's run and qrels, and
     its alpha-nDCG against the card's; (e) `ltr.main -model DALETOR -sf_id
     listsf` and `-model DivProbRanker` on SyntheticDiv -debug, finite CV
     metrics, a run file a fold, -reproduce the same bits. No kernel of
     ops/csrc launches in it (the JAX branch reaches no pl.pallas_call);
 11. adversarial, the six minimax machines (IRGAN and IRFGAN, point / pair
     / list) at the JAX package's widths for the branch (the pointsf 5 x
     100, ReLU, no batch norm; Adam lr 1e-3; S = 5, top_k = 5; F = 136, 512
     docs a batch): (a) every sampler's empirical frequencies over 2^20
     draws against its analytic distribution (TV distance within
     2 * sqrt(K / n)), no pad drawn, all-pad rows drawing, the same seed the
     same bits, the flattened pair axis of two 1,408-doc lists; (b) each
     machine's D and G step (IRFGAN_Pair: the joint step) on the card
     against the exact fp64 step on the CPU from the same params with the
     same draws: loss, gradients, params; (c) 512 synthetic queries of
     20..250 docs (from `--seed`, default 11) uploaded once, a DG round of
     every machine resident and streamed, queries/s, a profiled resident
     IRGAN_Point round (idle share; host->device copies and bytes: the
     index chunks the host copied and nothing else, one missed at most); (d) `ltr.main -model
     IRGAN_Point` and `-model IRFGAN_List` on SyntheticMQ -debug, 2 epochs:
     finite G and D CV nDCG in the run directories JAX names, the epochs
     each fold ran (a fold whose fresh G scores 0 stops at the G guard after
     epoch 1; at least one fold of each runs both), `-mesh data=2` on one
     card refused (two NCCL ranks need two cards; nothing drops to fewer
     ranks). No kernel of ops/csrc launches in it (the JAX branch reaches no
     pl.pallas_call);
 12. parallel, data parallelism (ptranking_tpu_torch/parallel/): (a) the
     flagship (LambdaRank through the fused loss, dropout 0) as a
     DistributedTrainer in a one-rank NCCL group against the AdhocRanker
     from the same seed, PAR_STEPS steps at 32 x 1408 docs, and one WassRank
     step likewise: the same losses and params bit for bit (one rank's
     all-reduces are copies), and the same kernel launches (the flash
     forward and backward, the pair kernels, the Sinkhorn half-step),
     counted on the DP path; (b) `ltr.main -mesh data=1` (a one-rank NCCL
     group in the process) against the same run without the mesh: the same
     CV metrics bit for bit; (c) two gloo ranks on the one card, CUDA tensors
     in the collectives, the flagship in fp32, PAR_GLOO_B lists of 1408
     docs a rank: the first step's loss, its gradients summed over the ranks
     and the initial nDCG within the CPU tests' tolerances of the one-device
     run on the same global batch, both ranks' params the same bits after
     PAR_GLOO_STEPS steps. (c) shows the reduction path with the kernels on
     the card, not multi-GPU scaling. (a'), (d), (e), (f): tensor and
     pipeline parallelism and expert sharding, the same way. Context
     parallelism (parallel/ring.py, ot.py): (g) a one-rank NCCL
     DistributedTrainer(shard_docs=True) on {seq: 1} at the flagship's width,
     PAR_STEPS fp32 LambdaRank steps at 32 x 1408 against the AdhocRanker
     (first loss, nDCG; first-step gradients under RankNet; bf16 reported),
     no launch of B1, B2 or B3 on the CP path (the JAX package routes CP past
     them); (h) in (c)'s spawn, a {seq: 2} mesh of the two gloo ranks: ring
     and Ulysses attention under RankNet, fp32, PAR_GLOO_B * 2 lists of 1408
     docs, against one device's dense attention and dense loss, and the CP
     loss zoo (CP_ZOO) against the port's one-device dense losses on the
     card.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of jax or ptranking_tpu.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

BF16_PEAK = 989e12   # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
FP32_PEAK = 67e12    # fp32 FLOP/s outside the tensor cores, H100 SXM data sheet
TF32_PEAK = 495e12   # dense TF32 tensor-core FLOP/s, H100 SXM data sheet
# the fp32 kernels on the tensor cores (the backward at d <= 128; the packed,
# list and long kernels at d > 128) take each fp32 product as three TF32
# products (3xTF32)
TF32_PRODUCTS = 3
HBM_BYTES_S = 3.35e12
SFU_PER_CLOCK_PER_SM = 16  # transcendental results per clock per SM, compute capability 9.0

# (B, H, N, d, all_padded_rows): the long-list batch that bench.py measures
# for the JAX package (32 lists of 1408 docs), the two ends of what the
# server's default 100-doc batches give the kernel: one list in the top
# bucket, and the smallest bucket whose remainder rows are all padding; and
# the Yahoo! LTR listsf's training batches (32,768 docs in each of the
# buckets of 16 to 256 docs, 2 heads of 350, or of 384 under lane_align: the
# wide kernels, whatever the route; phase 7 says why these buckets); and
# 32,768 docs in the 32-doc bucket at d = 68 (the flagship's width with
# short lists)
ATTN_SHAPES = [(32, 2, 1408, 68, False), (1, 2, 1536, 68, False), (3, 2, 32, 68, True),
               (1024, 2, 32, 68, False),
               (2048, 2, 16, 350, False), (1024, 2, 32, 350, False), (512, 2, 64, 350, False),
               (256, 2, 128, 350, False), (128, 2, 256, 350, False),
               (2048, 2, 16, 384, False), (1024, 2, 32, 384, False), (512, 2, 64, 384, False),
               (256, 2, 128, 384, False), (128, 2, 256, 384, False)]
# the shape whose numbers go into the kernels' JSON record: the training
# batch of phase 5 (32 lists of 1408 docs) in bf16 and fp32, whose
# train_epoch gives the record's launch counts (the fp32 wide kernels':
# WIDE_F32_RECORD, check_wide_tf32)
RECORD_SHAPE = (32, 2, 1408, 68)
# correctness only, no timing: every padded head width the narrow kernels
# dispatch on (d rounded up to 16), N of one key and N one past a 64-key
# tile; then the wide kernels (d > 128) at each d-chunk and output-chunk
# boundary (64 and 128 columns), at odd head dims (129, 131: synchronous
# copies of the bf16 kernels), 2 mod 4 (350: 4-byte copies), 4 mod 8 (132,
# 196: 8-byte copies; the inputs are fresh tensors, 16-byte aligned) and
# 0 mod 8 (136 .. 520: 16-byte copies)
EDGE_SHAPES = [(2, 3, 1, 1, False), (2, 2, 65, 8, True), (1, 3, 100, 24, False),
               (2, 1, 64, 33, True), (1, 2, 129, 64, False), (2, 2, 77, 75, True),
               (1, 1, 200, 96, False), (2, 1, 50, 112, True), (1, 2, 129, 128, False),
               (2, 2, 77, 129, True), (2, 1, 50, 131, False), (1, 2, 100, 132, False),
               (1, 2, 130, 136, False), (2, 1, 65, 192, True), (2, 1, 65, 196, True),
               (2, 1, 65, 200, True), (2, 2, 128, 256, False), (2, 2, 128, 350, True),
               (1, 2, 100, 384, False), (2, 1, 70, 520, True)]
# B*H = 65538 (b, h) pairs: past grid.y's 65535, so two launches of whole lists
GRID_SHAPE = (32769, 2, 16, 8)
# the fp32 forward at d <= 128 (3xTF32, the head dim padded to a multiple of
# 8) at every d of 1..128, correctness only: (B, H, N) of a full, a ragged
# and an all-padded list, N two 64-key tiles (the last ragged) and two
# 64-row query blocks
NARROW_EVERY_D = (3, 2, 77)
# max |kernel - plain| over real query rows. fp32: both sides accumulate in
# fp32, differing only in summation order and exp rounding. bf16: the plain
# version rounds p to bf16 before p.v (as the JAX package does) and the
# kernel keeps p in fp32, and both round the output to bf16 (ulp 2^-8 near 1).
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# max |kernel - plain| / max |plain| over every query row (padded and
# all-padded ones included: both compute the same thing there) against
# attention_forward_plain, the kernels' own formulas (64-key tiles, a running
# max, p rounded to the inputs' dtype before p.v at the same points). What is
# left: the tensor cores' summation order, ex2.approx in log2 units against
# expf, so now and then a p or an output rounded to the other side in bf16
# (one bf16 ulp at the largest output). The first run on an H100 over all 12
# shapes: 3.2e-3 (bf16), 2.3e-6 (fp32); the tolerances hold a margin of 3x
# and more.
FWD_PLAIN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# row_max: max |kernel - plain| / (1 + |plain|); row_sum: max |kernel -
# plain| / plain; both fp32 (the bf16 kernel keeps the max in log2 units and
# converts it back, ex2.approx against expf). The first run: 4.2e-7 and
# 1.8e-6; a margin of 5x.
STATS_TOL = 1e-5
# max |kernel - plain| / max |plain| per gradient (dq, dk, dv) over the lists
# with a real document (all-padded lists differ by contract, as in the
# forward, and are checked for finiteness only), against two plain versions:
# autograd through blockwise_attention, and attention_backward_plain (the
# kernels' own formulas from the same row statistics). fp32: summation order
# and exp rounding. bf16: the kernels round P and dS to bf16 before the second
# products, as attention_backward_plain does at the same points (what is left
# is the tensor cores' summation order, the fast exp and one bf16 ulp at the
# outputs), while autograd through blockwise_attention rounds each block's
# unnormalised p and the gradient of p; all round the outputs to bf16.
# The worst of a run on an H100 over all 12 shapes: 7.6e-3 (bf16) and 1.7e-6
# (fp32) against autograd, 3.3e-3 and 6.1e-7 against attention_backward_plain;
# the tolerances hold a margin of 2.6x and more.
BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the packed backward (bf16 lists of at most 64 docs, several a 64-row tile,
# csrc/flash_attn_bwd.cu's flash_bwd_packed_mma_kernel), correctness only: every
# copy width and chunk boundary of the wide kernels' head dims (129: element
# copies, 136: 16-byte, 200: 8-byte, 350: 4-byte, 384, 520: more d-chunks than
# the 384 the variant tables time) x list lengths around the tile (one list a
# tile at 33, 63 and 64 docs, 64 at 1, N dividing 64 or not), at
# PACK_LISTS = (B, H): B*H = 10 lists leave a partial last tile wherever
# 64 // N > 1 does not divide 10; the second b a one-doc list, the last
# fully padded, the others ragged;
# then B*H = 65538 lists (PACK_BIG). The fp32 packed backward (3xTF32) is
# held the same way at the same shapes, in both plain versions' fp32, to
# BWD_TOL's fp32 1e-5 with the same floor.
PACK_DS = (129, 136, 200, 350, 384, 520)
PACK_NS = (1, 5, 16, 20, 33, 63, 64)
PACK_LISTS = (5, 2)
PACK_BIG = (32769, 2, 5, 136)
# timed, the Yahoo! LTR listsf's buckets of at most 64 docs at 32,768 docs a
# layer (the record: the 16-doc bucket at d = 350)
PACK_TIMED = [(2048, 2, 16, 350), (1024, 2, 32, 350), (512, 2, 64, 350),
              (2048, 2, 16, 384), (1024, 2, 32, 384), (512, 2, 64, 384)]
PACK_RECORD = (2048, 2, 16, 350)
# the list backward (bf16 lists of 65..128 docs, one a 128-row tile), the
# same way: PACK_DS x lengths around its tile (65, 100, 127, 128 docs, the
# second b a one-doc list, the last fully padded) at PACK_LISTS; timed in
# Yahoo!'s 128-doc bucket. Its fp32 instantiation (3xTF32, keys in slices
# of 64) likewise, to BWD_TOL's fp32 1e-5 with the same floor, and at
# F32_LIST_BIG (B*H = 65538 lists, held against the plain versions on its
# first and last b, by check_big)
LIST_NS = (65, 100, 127, 128)
F32_LIST_BIG = (32769, 2, 65, 136)
LIST_TIMED = [(256, 2, 128, 350), (256, 2, 128, 384)]
LIST_RECORD = (256, 2, 128, 350)
# the long backward and forward (bf16 lists of 129..256 docs, one a 256-row
# tile, its keys in two halves of 128), the same way: PACK_DS x lengths
# around its halves and tile (129: one key in the second half; 200; 255;
# 256) at PACK_LISTS, the last b fully padded; B*H = 65538 lists of 129 docs
# (LONG_BIG: held against the plain versions on its first and last b, by
# check_big); timed in Yahoo!'s 256-doc bucket; the fp32 long backward
# (3xTF32) likewise, as the fp32 list backward
LONG_NS = (129, 200, 255, 256)
LONG_BIG = (32769, 2, 129, 136)
LONG_TIMED = [(128, 2, 256, 350), (128, 2, 256, 384)]
LONG_RECORD = (128, 2, 256, 350)
# the packed forward (bf16 lists of at most 128 docs: 64 // N a 64-key tile,
# or one a 128-key tile), correctness at PACK_DS x FWD_PACK_NS at PACK_LISTS
# and at PACK_BIG, each the same bits twice and with or without statistics:
# the output within FWD_PLAIN_TOL of attention_forward_packed_plain (its own
# formulas) and ATTN_TOL of attention_forward_plain (above 64 docs the two
# round p against other maxima), the statistics within STATS_TOL of both;
# timed in Yahoo!'s buckets of 16 to 128 docs beside the wide forward and SDPA;
# the fp32 packed forward (3xTF32, lists of at most 64 docs) likewise at
# PACK_DS x PACK_NS and PACK_BIG, to FWD_PLAIN_TOL, ATTN_TOL and STATS_TOL's
# fp32 gates, timed in the buckets of 16 to 64 docs; the fp32 list forward
# (3xTF32, one list of 65..256 docs a 128- or 256-row tile, through the
# packed and the long entries) likewise at PACK_DS x LIST_NS and x LONG_NS,
# timed at LIST_TIMED and LONG_TIMED, and at F32_LIST_BIG and LONG_BIG
# (check_big); each of these cases also holds a one-doc list
FWD_PACK_NS = (1, 5, 16, 20, 33, 63, 64, 65, 100, 127, 128)
FWD_PACK_TIMED = [(2048, 2, 16, 350), (1024, 2, 32, 350), (512, 2, 64, 350), (256, 2, 128, 350),
                  (2048, 2, 16, 384), (1024, 2, 32, 384), (512, 2, 64, 384), (256, 2, 128, 384)]
FWD_PACK_RECORD = (2048, 2, 16, 350)
# the fp32 wide kernels (3xTF32, every fp32 list past F32_LONG_MAX_N docs at
# d > 128: csrc/flash_attn_fwd.cu's flash_fwd_wide_tf32_kernel and
# csrc/flash_attn_bwd.cu's flash_bwd_{dkdv,dq}_wide_tf32_kernel), correctness
# at WIDE_F32_NS x WIDE_F32_DS: four lists a case (full, one real doc,
# ragged, all padded), against attention_forward_plain and
# attention_backward_plain (FWD_PLAIN_TOL, STATS_TOL, BWD_TOL with
# PACK_FLOOR) and blockwise_attention with its autograd (ATTN_TOL, BWD_TOL),
# the same bits twice; d = 384 and 700 (Yahoo!'s F under one head) take two
# output groups of dk/dv (376 columns at most), one of the forward and dq
# (752). Timed at
# WIDE_F32_TIMED: the one-head MSLR-WEB30K listsf's buckets of 512 and 1024
# docs and its long-list point (32 x 1408), one served list of the top
# bucket, and the Yahoo! widths at 512 docs, beside SDPA in fp32 (TF32 off);
# the record at WIDE_F32_RECORD (phase 7 trains the one-head model there)
WIDE_F32_NS = (257, 300, 512, 1408, 1536)
WIDE_F32_DS = (129, 136, 350, 384, 700)
WIDE_F32_TIMED = [(64, 1, 512, 136), (32, 1, 1024, 136), (32, 1, 1408, 136), (1, 1, 1536, 136),
                  (16, 2, 512, 350), (16, 2, 512, 384)]
WIDE_F32_RECORD = (32, 1, 1408, 136)
# The packed kernel against attention_backward_packed_plain and
# attention_backward_plain: BWD_TOL's bf16 2e-2 on max |kernel - plain| per
# gradient over EVERY list (a fully padded one too: all three compute the
# same there), relative to max(max |plain|, PACK_FLOOR x max |plain dv|): dq
# and dk of a one-doc list (every list at N = 1) are sums of P (dP - D) that
# cancel to rounding noise, so they are held at a tenth of dv's scale.
PACK_FLOOR = 0.1
# the attention kernels of each library and how many instantiations each
# has: the bf16 kernels of d <= 128 one per head-dim step of 16 (KC = 1 ..
# 8), the fp32 ones (3xTF32) one per step of 8 (NC = 1 .. 16), the bf16 wide kernels
# (d > 128) one, the fp32 wide forward, dk/dv and dq one each,
# the packed forward two (a 64-key tile of 64 // N lists, a 128-key
# tile of one list), the packed backward three (64 rows with inputs kept
# where they fit, d <= 448, and re-read beyond: check_packed meets both; the
# list kernel's 128 rows), the long forward and backward one each, the
# fp32 packed forward and backward (3xTF32) one each, the fp32 list and
# long backward two (128 and 256 rows), the fp32 list forward two (128 and
# 256 rows).
# Every instantiation is one that some shape dispatches to, so no entry of
# these libraries may spill.
BUILD_KERNELS = {"flash_attn_fwd": {"flash_fwd_mma_kernel": 8, "flash_fwd_tf32_kernel": 16,
                                    "flash_fwd_wide_mma_kernel": 1, "flash_fwd_wide_tf32_kernel": 1,
                                    "flash_fwd_packed_mma_kernel": 2,
                                    "flash_fwd_long_mma_kernel": 1,
                                    "flash_fwd_packed_tf32_kernel": 1,
                                    "flash_fwd_list_tf32_kernel": 2},
                 "flash_attn_bwd": {"flash_bwd_dkdv_mma_kernel": 8, "flash_bwd_dq_mma_kernel": 8,
                                    "flash_bwd_dkdv_tf32_kernel": 16, "flash_bwd_dq_tf32_kernel": 16,
                                    "flash_bwd_dkdv_wide_mma_kernel": 1,
                                    "flash_bwd_dq_wide_mma_kernel": 1,
                                    "flash_bwd_dkdv_wide_tf32_kernel": 1,
                                    "flash_bwd_dq_wide_tf32_kernel": 1,
                                    "flash_bwd_packed_mma_kernel": 3,
                                    "flash_bwd_long_mma_kernel": 1,
                                    "flash_bwd_packed_tf32_kernel": 1,
                                    "flash_bwd_list_tf32_kernel": 2}}

# the fused pairwise loss: (B, N, lengths or None for full lists, weighted, sigma)
PAIR_SHAPES = [(32, 1408, None, True, 1.0), (3, 1, (1, 1, 0), True, 1.0),
               (3, 2, (2, 1, 0), True, 1.0), (4, 255, (255, 200, 17, 0), True, 1.0),
               (4, 257, (257, 256, 1, 0), True, 1.0), (4, 300, (300, 257, 40, 0), False, 1.5)]
PAIR_RECORD = (32, 1408)
# B past grid.y's 65535, folded into grid.x (16-doc lists)
PAIR_BIG = (70000, 16)
# |kernel - plain| / |plain| of the loss, and max |kernel - plain| / max |plain|
# of the gradient, both fp32: the two sum in other orders (the first chip
# run's worst: 1.1e-7 and 9.5e-7)
PAIR_TOL = 1e-5
# per pair: fp32 operations and transcendental (SFU) operations of the formula
# (pairwise_lambda.cu header): forward softplus(x) - t*x weighted, backward
# sigma*(sigmoid(x) - t) weighted. Both count unordered pairs: the backward's
# term is odd in the pair, so each unordered pair gives both of its rows
# their terms (the record also states the reading on ordered pairs, twice as
# many, which the first backward design evaluated); the backward's 20 are the
# term's 18 and its adds into both rows' sums
PAIR_FWD_OPS, PAIR_BWD_OPS, PAIR_SFU_OPS = 19, 20, 2

# the Sinkhorn half-step: the WassRank training batch of phase 6 (the `eg`
# cost of its labels, lam 0.1, where -C/lam reaches thousands), the two
# smaller widths whose times PERF.md keeps, and edge cases (N, lengths, lam)
SINK_RECORD = (32, 1408)
SINK_TIMED_N = (128, 512)
SINK_EDGES = [(1, (1, 1, 0), 0.1), (2, (2, 1, 0), 0.3), (16, (16, 9, 0), 0.1),
              (50, (50, 37, 0), 0.3), (255, (255, 100, 0), 0.1), (257, (257, 256, 1, 0), 0.3)]
# |kernel - plain| <= SINK_ATOL + SINK_RTOL * |plain| on real outputs, both
# fp32: the kernel keeps a running (max, sum) and merges partial pairs where
# the plain version subtracts the final max, so they round differently (the
# first chip runs' worst: 0.075 of this limit, at an edge case; 4.1e-7 for
# the scalings). The 20-iteration scalings are held to
# max |kernel - plain| / max |plain| <= SINK_SCALINGS_TOL.
SINK_RTOL, SINK_ATOL, SINK_SCALINGS_TOL = 1e-4, 1e-5, 1e-4
# costs with entries outside the range the vector kernels' FMA division takes
# (sink_case's `extreme`: every s-th entry scaled by 1e-35, every t-th by
# 1e35). (7, 11) puts one in every whole chunk of 4 x 4 loads, so every chunk
# goes through the division (and, at N % 4 != 0, the scalar kernels meet
# them); (1009, 1013) in about 3% of the chunks, so a reduction mixes chunks
# of the FMA path and of the division. Whole chunks exist in the column
# kernel at N = 128, 512 and 1408, in the row kernel at 512 and 1408 (a row
# of 128 is all remainder).
SINK_EXTREMES = ((7, 11), (1009, 1013))
# per element of the cost matrix: fp32 operations of the half-step (negate,
# divide, add, subtract, abs, select, multiply-add, max) beside its one exp
SINK_FP32_OPS = 10

# phase 5, the flagship model's training
TRAIN_B, TRAIN_N = 32, 1408
TRAIN_STEPS = 10
# launches per training step: 6 encoder layers, one loss (whose backward is
# two kernels: the pair kernel and the fixed-order reduction)
LAUNCHES_PER_STEP = {"flash_attn_fwd": 6, "flash_attn_fwd_packed": 0, "flash_attn_fwd_long": 0,
                     "flash_attn_bwd_dkdv": 6, "flash_attn_bwd_dq": 6, "flash_attn_bwd_packed": 0,
                     "flash_attn_bwd_list": 0, "flash_attn_bwd_long": 0,
                     "pairwise_lambda_fwd": 1, "pairwise_lambda_bwd": 2, "sinkstep": 0}
# phase 6, per WassRank step: 20 Sinkhorn iterations of two half-steps each
# in the loss's forward, none in its analytic backward
WASS_LAUNCHES_PER_STEP = {**LAUNCHES_PER_STEP, "pairwise_lambda_fwd": 0,
                          "pairwise_lambda_bwd": 0, "sinkstep": 40}
WASS_STEPS = 10
EVAL_KS = (1, 3, 5, 10, 20, 50)
# One step's gradients, fp32, compared per parameter tensor as
# ||a - b|| / max(||b||, GRAD_FLOOR * the largest ||b||) (the floor keeps a
# tensor whose gradient is a near-cancelling sum, such as a bias of the tail
# FFN, from magnifying rounding), leaving out ZERO_GRAD_PARAM: the last
# layer's bias, whose exact gradient is zero (both losses are invariant to a
# shift of every score). At init, at 1408 docs, this step is ill-conditioned
# in fp32: two correct implementations part by about 1e-3, and which of them
# strays from the CPU's plain path depends on the batch (the vs_cpu records
# hold the kernel path and the card's dense path against the CPU for two
# batches). So the model-level comparisons are held to GRAD_TOL, a margin
# of 3x over the worst seen on the card (6.2e-3); a wrong kernel gradient
# gives O(1). The kernels are held tightly at their own level (phase 3), and
# the fused loss on the kernel path's own scores (well-conditioned: the same
# forward) to SAME_SCORES_TOL. In bf16 the scores carry 8 bits and tie
# heavily at init, so LambdaRank's order-following weights part the two
# paths far more (the record counts the sorted positions that differ): the
# bf16 errors are printed, not held.
GRAD_TOL, SAME_SCORES_TOL, GRAD_FLOOR = 2e-2, 1e-4, 1e-2
ZERO_GRAD_PARAM = "tail_ffnns.layers[3].linear.b"
# the vs_cpu comparison: VS_CPU_B lists of TRAIN_N docs (ragged, one
# all-padded), two batches, under the order-free dense RankNet loss
VS_CPU_B, VS_CPU_SEEDS = 4, (1, 4)
EPOCH_QUERIES, EPOCH_PASSES = 16, 4
# a restored ranker's next step against the ranker that was not reloaded:
# the same kernels on the same inputs
RESUME_TOL = 1e-6

# phase 7: Yahoo! LTR's 700 features (ptranking_tpu_torch/data/meta.py, data
# id Set1), 2 heads of 350 (384 under lane_align). Its lists are short:
# Set 1's training split holds 473,134 documents over 19,944 queries, 23.7 a
# query (Chapelle and Chang, "Yahoo! Learning to Rank Challenge Overview",
# JMLR W&CP 14, 2011, Table 1), so the mean list falls in the 32-doc bucket
# (data/dataset.py's DEFAULT_BUCKETS), and by that mean alone (Markov's
# bound) at least 63% of the lists in the buckets of 16 to 64 docs. The
# timed steps run each bucket of 16 to 256 docs at YAHOO_DOCS docs a step
# (2048 lists of 16 .. 128 of 256; Yahoo!'s longest lists, 139 docs, land in
# the 256-doc bucket, the long kernels' route); the gradient
# check runs ragged lists of 20..128 docs in the 128-doc bucket; the served
# lists spread log-evenly over 5..139 docs, so a request fills every bucket
# up to 256.
YAHOO_FEATURES, YAHOO_DATA_ID = 700, "Set1"
YAHOO_DOCS, YAHOO_BUCKETS, YAHOO_STEPS = 32768, (16, 32, 64, 128, 256), 10
YAHOO_GRAD_CHECK = 128
# the bucket of Yahoo!'s mean list, where the gradient checks (fp32 held,
# bf16 printed) run a second time, through the packed forward and backward
# (ragged lists of 20..32 docs)
YAHOO_PACKED_CHECK = 32
# the timed fp32 Yahoo! steps (compute_dtype's default, with flash
# attention), at d = 350: through the fp32 packed forward and backward
# (3xTF32) up to F32_PACK_MAX_N docs; at 128 and 256 through the fp32 list
# forward and the fp32 list and long backward (3xTF32)
YAHOO_F32_BUCKETS = (16, 32, 64, 128, 256)
# the one-head model (d = 136, MSLR-WEB30K's features, whose long lists
# fill the default buckets up to 1536 docs, data/dataset.py) also takes its
# fp32 gradient check in a bucket past F32_LONG_MAX_N, and fp32 timed steps
# at the flagship's long-list point (WIDE_F32_STEP: lists, docs): the path of
# the fp32 wide forward and dk/dv and dq kernels (3xTF32)
WIDE_PAIR_CHECK = 512
WIDE_F32_STEP = (32, 1408)
YAHOO_SERVE_LENGTHS = [int(round(5 * (139 / 5) ** (i / 15))) for i in range(16)]
# the listsfs of phase 7, each with a head dim above 128: (name, features,
# heads, lane_align, LETOR data id): Yahoo!'s at d = 350 (its launch counts
# go into the kernels' record) and under lane_align at d = 384, and the
# flagship's width (MSLR-WEB30K) with one head, d = 136
WIDE_MODELS = [("yahoo", YAHOO_FEATURES, 2, False, YAHOO_DATA_ID),
               ("yahoo", YAHOO_FEATURES, 2, True, YAHOO_DATA_ID),
               ("mslr_1head", 136, 1, False, "MSLRWEB30K")]

NUM_FEATURES = 136  # MSLR-WEB30K
# 16 queries of ragged lengths, log-spaced over 20..1408 docs
SERVE_LENGTHS = [int(round(20 * (1408 / 20) ** (i / 15))) for i in range(16)]
SERVE_REPEATS = 5
# max |served score - dense-attention score| on one doc. Both run the model in
# bf16 and differ only inside attention (the kernel keeps p in fp32, the dense
# path rounds it to bf16), which moves a score by a few bf16 ulps (2^-8 near 1)
# through the 6 layers.
SCORE_TOL = 2e-2


def phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_entries(log: str):
    """[(mangled entry name, registers, spill bytes)] from nvcc's -Xptxas -v output."""
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", part)
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", part)
        out.append((part.split("'", 1)[0], int(regs.group(1)) if regs else -1,
                    sum(int(x) for x in spills)))
    return out


def ptxas_summary(log: str) -> str:
    """One line per kernel source from nvcc's -Xptxas -v output: entries
    compiled, register range and spill bytes (stores and loads)."""
    entries = ptxas_entries(log)
    regs = [e[1] for e in entries]
    return (f"{log.split(':', 1)[0]}: {len(entries)} entries, registers {min(regs, default=0)}.."
            f"{max(regs, default=0)}, spill {sum(e[2] for e in entries)} bytes")


def check_build(log: str, kernels: dict):
    """Registers and spill bytes of each named kernel of one library, by its
    template arguments (the head-dim steps); raises if a kernel has not as
    many instantiations as named, or if any entry of the library spills."""
    entries = ptxas_entries(log)
    for kernel, count in kernels.items():
        row = {}
        for name, regs, spill in entries:
            m = re.search(str(len(kernel)) + kernel + r"I(\w*?)EEv", name)
            if m:
                row[",".join(re.findall(r"L[ib](\d+)E", m.group(1) + "E"))] = (regs, spill)
        print(f"{kernel} registers/spill bytes: "
              + ", ".join(f"<{t}> {r}/{sp}" for t, (r, sp) in row.items()), flush=True)
        if len(row) != count:
            raise AssertionError(f"{kernel}: {len(row)} instantiations built, {count} expected")
    spilled = [(name, regs, spill) for name, regs, spill in entries if spill]
    if spilled:
        raise AssertionError(f"{log.split(':', 1)[0]}: entries spill: {spilled} "
                             f"(name, registers, spill bytes)")


def cuda_time_ms(fn, iters: int, warmup: int = 3, blocks: int = 3) -> float:
    """ms per call of `fn`: the median over `blocks` timed blocks of `iters`
    calls each, CUDA events around every block. A block's time includes the
    host's enqueueing wherever the host is slower than the card, so one stall
    of the host would end up in a single block's mean; the median drops it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(blocks)]
    for start, end in events:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(start.elapsed_time(end) for start, end in events)[blocks // 2] / iters


def profile_ms(fn, kernel="flash_fwd", every=False):
    """(device busy ms, ms of the kernels whose name holds `kernel`, wall ms)
    of one call of `fn` under torch.profiler: the sum of the kernels' and
    copies' own device times, on one stream. The profiler's user annotations
    on the device (`Optimizer.step#...`) are left out: each spans its kernels
    and the gaps between them, so it would count them twice and count idle
    time as busy. The first two are None when the profiler recorded no device
    time. With every=True, a fourth item: every kernel and copy by device
    time, as [name (cut to 60 characters), ms, calls]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = named = 0.0
    kernels = []
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = e.self_device_time_total
        busy += us / 1e3
        kernels.append([e.key[:60], us / 1e3, e.count])
        if kernel in e.key:
            named += us / 1e3
    out = (None, None, wall) if busy <= 0.0 else (busy, named, wall)  # None: not measured
    if every:
        out += (sorted(kernels, key=lambda k: -k[1]),)
    return out


def sfu_ops_per_s() -> float:
    """The card's transcendental rate: SFU results per clock per SM x SMs x
    the maximum SM clock that nvidia-smi reports."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    mhz = float(out.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_CLOCK_PER_SM * sms * mhz * 1e6


def fwd_ops(flops: float, dtype, d: int):
    """(operations, peak) of the flash forward's bound: bf16 on the tensor
    cores; fp32 at every d as TF32_PRODUCTS TF32 products a product
    (3xTF32)."""
    import torch

    if dtype == torch.bfloat16:
        return flops, BF16_PEAK
    return TF32_PRODUCTS * flops, TF32_PEAK


def bound(flops: float, peak: float, nbytes: float) -> dict:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def attention_inputs(B, H, N, d, all_padded, dtype, seed=0):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(B, H, N, d, generator=g).to("cuda", dtype) for _ in range(3))
    lengths = torch.randint(max(1, N // 4), N + 1, (B,), generator=g)
    lengths[0] = N
    if all_padded:
        lengths[-1] = 0  # a remainder row of a bucket: no real document
    mask = (torch.arange(N)[None, :] < lengths[:, None]).to("cuda")
    return q, k, v, mask


def check_close(out, ref, mask, shape, dtype) -> float:
    """Max |kernel - plain| over real query rows, under ATTN_TOL, with every
    row finite (padded ones included); raises otherwise."""
    import torch

    real = mask[:, None, :, None].expand_as(out)
    err = float((out.float() - ref.float()).abs()[real].max()) if real.any() else 0.0
    finite = bool(torch.isfinite(out.float()).all())
    name = str(dtype).split(".")[1]
    if not finite or not err <= ATTN_TOL[name]:
        raise AssertionError(f"flash_attn_fwd {name} {shape}: max_abs_err {err} "
                             f"(tol {ATTN_TOL[name]}), all finite: {finite}")
    return err


def check_plain_forward(q, k, v, mask, worst) -> float:
    """The kernel, with and without row statistics, against
    attention_forward_plain over every query row: the same bits either way,
    the output within FWD_PLAIN_TOL (relative to its largest value) and the
    statistics within STATS_TOL. Notes the worst errors by dtype in `worst`
    and returns the output's."""
    import torch

    from ptranking_tpu_torch.ops.attention import FLASH_ATTN_FWD, attention_forward_plain

    out = FLASH_ATTN_FWD(q, k, v, mask)
    out_s, row_max, row_sum = FLASH_ATTN_FWD(q, k, v, mask, stats=True)
    ref, ref_max, ref_sum = attention_forward_plain(q, k, v, mask)
    torch.cuda.synchronize()
    name = str(q.dtype).split(".")[1]
    errs = {"out": rel_err(out, ref),
            "row_max": float(((row_max - ref_max).abs() / (1.0 + ref_max.abs())).max()),
            "row_sum": float(((row_sum - ref_sum).abs() / ref_sum).max())}
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (out_s, row_max, row_sum))
    if (not torch.equal(out, out_s) or not finite or not errs["out"] <= FWD_PLAIN_TOL[name]
            or not max(errs["row_max"], errs["row_sum"]) <= STATS_TOL):
        raise AssertionError(f"flash_attn_fwd {name} {tuple(q.shape)} against "
                             f"attention_forward_plain: {errs} (tol {FWD_PLAIN_TOL[name]}, "
                             f"statistics {STATS_TOL}), all finite: {finite}, same output "
                             f"with statistics: {torch.equal(out, out_s)}")
    for key, e in errs.items():
        worst[name][key] = max(worst[name][key], e)
    return errs["out"]


def check_attention(card: str):
    """Phase 3: the flash kernel against its plain versions at every shape and
    dtype, and the fp32 forward of d <= 128 (3xTF32) at every d of 1..128
    (NARROW_EVERY_D), the same bits twice; returns the records at
    RECORD_SHAPE (bf16 and fp32), by (shape, dtype name). The bound of the
    fp32 forward counts TF32_PRODUCTS TF32 products a product at TF32_PEAK."""
    import torch
    import torch.nn.functional as Fn

    from ptranking_tpu_torch.ops.attention import FLASH_ATTN_FWD, blockwise_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {n: {"out": 0.0, "row_max": 0.0, "row_sum": 0.0} for n in ("bfloat16", "float32")}
    for (B, H, N, d, all_padded) in EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask = attention_inputs(B, H, N, d, all_padded, dtype)
            out = FLASH_ATTN_FWD(q, k, v, mask)
            ref = blockwise_attention(q, k, v, mask, block_size=min(128, N))
            torch.cuda.synchronize()
            check_close(out, ref, mask, (B, H, N, d), dtype)
            check_plain_forward(q, k, v, mask, worst)
    print(f"attn edge shapes: {len(EDGE_SHAPES)} x 2 dtypes agree", flush=True)
    B, H, N = NARROW_EVERY_D
    for d in range(1, 129):
        q, k, v, mask = attention_inputs(B, H, N, d, True, torch.float32)
        out = FLASH_ATTN_FWD(q, k, v, mask, stats=True)
        again = FLASH_ATTN_FWD(q, k, v, mask, stats=True)
        ref = blockwise_attention(q, k, v, mask, block_size=min(128, N))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"flash_attn_fwd float32 {(B, H, N, d)}: not the same bits twice")
        check_close(out[0], ref, mask, (B, H, N, d), torch.float32)
        check_plain_forward(q, k, v, mask, worst)
    print(f"attn fp32 forward at every d of 1..128 at {NARROW_EVERY_D}: agrees, the same bits "
          f"twice", flush=True)
    records = {}
    for (B, H, N, d, all_padded) in ATTN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask = attention_inputs(B, H, N, d, all_padded, dtype)
            plain = lambda: blockwise_attention(q, k, v, mask, block_size=min(128, N))
            kern = lambda: FLASH_ATTN_FWD(q, k, v, mask)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = check_close(out, ref, mask, (B, H, N, d), dtype)
            err_plain = check_plain_forward(q, k, v, mask, worst)
            name = str(dtype).split(".")[1]
            bias = torch.where(mask, 0.0, -1e9).to(dtype)[:, None, None, :].expand(B, H, N, N)
            library = lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            iters = 20 if N >= 1024 else 200
            ms = cuda_time_ms(kern, iters)
            plain_ms = cuda_time_ms(plain, max(iters // 4, 5))
            library_ms = cuda_time_ms(library, iters)
            flops = 4.0 * B * H * N * N * d
            nbytes = 4.0 * B * H * N * d * q.element_size() + B * N
            rec = {"shape": [B, H, N, d], "dtype": name, "max_abs_err": err,
                   "rel_err_vs_plain_forward": err_plain,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   **bound(*fwd_ops(flops, dtype, d), nbytes)}
            print("attn " + json.dumps(rec) + f"  [{card}]", flush=True)
            if (B, H, N, d) == RECORD_SHAPE:
                records[((B, H, N, d), name)] = rec
    print(f"attn worst error against attention_forward_plain over every shape: "
          f"{json.dumps(worst)}", flush=True)
    return records


def rel_err(out, ref) -> float:
    """max |out - ref| / max |ref| (max |out| where ref is all zero)."""
    out, ref = out.float(), ref.float()
    den = float(ref.abs().max()) if ref.numel() else 0.0
    num = float((out - ref).abs().max()) if ref.numel() else 0.0
    return num / den if den > 0 else float(out.abs().max()) if out.numel() else 0.0


def attention_grads(fn, q, k, v, mask, dout):
    """(dq, dk, dv) of fn(q, k, v, mask) for the output gradient dout."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    fn(*leaves, mask).backward(dout)
    return [t.grad for t in leaves]


def check_bwd_close(got, ref, mask, shape, dtype, plain="autograd"):
    """The kernels' (dq, dk, dv) against the plain version's (`plain` names
    it), over the lists with a real document, under BWD_TOL; every gradient
    finite. Returns the {name: (max abs err, relative err)}."""
    import torch

    name = str(dtype).split(".")[1]
    real = mask.any(dim=1)
    errs = {}
    for g_name, a, b in zip(("dq", "dk", "dv"), got, ref):
        if not bool(torch.isfinite(a.float()).all()):
            raise AssertionError(f"flash_attn_bwd {name} {shape}: non-finite {g_name}")
        if bool(real.any()):
            errs[g_name] = (float((a[real].float() - b[real].float()).abs().max()),
                            rel_err(a[real], b[real]))
        else:
            errs[g_name] = (0.0, 0.0)
        if not errs[g_name][1] <= BWD_TOL[name]:
            raise AssertionError(f"flash_attn_bwd {name} {shape} against {plain}: {g_name} "
                                 f"relative error {errs[g_name][1]} (tol {BWD_TOL[name]})")
    return errs


def check_attention_bwd(card):
    """Phase 3: the backward kernels (through flash_attention's autograd, so
    the packed kernel where bwd_route takes it) against autograd through the
    plain blockwise attention and against attention_backward_plain at every
    shape and dtype, and the dk/dv and dq kernels themselves (the wide pair
    at every wide shape, routed or not) against attention_backward_plain,
    with their times; the records' errors are those of the pair itself;
    returns the records for the dk/dv kernel, the dq kernel and the forward
    with row statistics (the call training makes) at RECORD_SHAPE in bf16
    (by the wrappers' names), and for the dk/dv and dq kernels at
    RECORD_SHAPE in fp32 (3xTF32; the names with "_fp32"). The bound of the
    fp32 backward counts TF32_PRODUCTS TF32 products a product at
    TF32_PEAK."""
    import torch
    import torch.nn.functional as Fn

    from ptranking_tpu_torch.ops.attention import (FLASH_ATTN_BWD_DKDV, FLASH_ATTN_BWD_DQ,
                                                   FLASH_ATTN_FWD, attention_backward_plain,
                                                   blockwise_attention, flash_attention)

    def plain_fn(q, k, v, m):
        return blockwise_attention(q, k, v, m, block_size=min(128, q.shape[2]))

    def case(B, H, N, d, all_padded, dtype):
        q, k, v, mask = attention_inputs(B, H, N, d, all_padded, dtype)
        g = torch.Generator(device="cpu").manual_seed(1)
        dout = torch.randn(B, H, N, d, generator=g).to("cuda", dtype)
        return q, k, v, mask, dout

    def both_errs(q, k, v, mask, dout, dtype):
        """The kernels' gradients against the two plain versions."""
        shape = tuple(q.shape)
        got = attention_grads(flash_attention, q, k, v, mask, dout)
        ref = attention_grads(plain_fn, q, k, v, mask, dout)
        out, row_max, row_sum = FLASH_ATTN_FWD(q, k, v, mask, stats=True)
        explicit = attention_backward_plain(q, k, v, dout, out, row_max, row_sum, mask)
        torch.cuda.synchronize()
        return (check_bwd_close(got, ref, mask, shape, dtype),
                check_bwd_close(got, explicit, mask, shape, dtype, "attention_backward_plain"))

    worst = {"autograd": {"bfloat16": 0.0, "float32": 0.0},
             "plain_backward": {"bfloat16": 0.0, "float32": 0.0}}

    def note(errs, errs_explicit, dtype):
        name = str(dtype).split(".")[1]
        for key, e in (("autograd", errs), ("plain_backward", errs_explicit)):
            worst[key][name] = max(worst[key][name], *(x[1] for x in e.values()))

    for (B, H, N, d, all_padded) in EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask, dout = case(B, H, N, d, all_padded, dtype)
            note(*both_errs(q, k, v, mask, dout, dtype), dtype)
    print(f"attn bwd edge shapes: {len(EDGE_SHAPES)} x 2 dtypes agree; worst relative "
          f"error {json.dumps(worst)}", flush=True)

    records = {}
    for (B, H, N, d, all_padded) in ATTN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask, dout = case(B, H, N, d, all_padded, dtype)
            errs, errs_explicit = both_errs(q, k, v, mask, dout, dtype)
            note(errs, errs_explicit, dtype)

            out, row_max, row_sum = FLASH_ATTN_FWD(q, k, v, mask, stats=True)
            dsum = torch.sum(dout.float() * out.float(), dim=-1)
            fwd = lambda: FLASH_ATTN_FWD(q, k, v, mask, stats=True)
            dkdv = lambda: FLASH_ATTN_BWD_DKDV(q, k, v, dout, row_max, row_sum, dsum, mask)
            dq = lambda: FLASH_ATTN_BWD_DQ(q, k, v, dout, row_max, row_sum, dsum, mask)
            # the dk/dv and dq kernels themselves, routed at this shape or
            # not (at d > 128 the wide pair), against attention_backward_plain
            pair_errs = check_bwd_close(
                (dq(), *dkdv()),
                attention_backward_plain(q, k, v, dout, out, row_max, row_sum, mask), mask,
                (B, H, N, d), dtype, "attention_backward_plain (the dk/dv and dq kernels)")
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            plain_out = plain_fn(*leaves, mask)

            def backward_only(out_, leaves_):
                """One backward from a kept graph into fresh .grad tensors."""
                for t in leaves_:
                    t.grad = None
                out_.backward(dout, retain_graph=True)

            plain = lambda: backward_only(plain_out, leaves)
            bias = torch.where(mask, 0.0, -1e9).to(dtype)[:, None, None, :].expand(B, H, N, N)
            lib_leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            library = lambda: backward_only(
                Fn.scaled_dot_product_attention(*lib_leaves, attn_mask=bias), lib_leaves)
            # the library's backward alone: one call yields dq, dk and dv, so
            # it stands against the two backward kernels together
            lib_out = Fn.scaled_dot_product_attention(*lib_leaves, attn_mask=bias)
            library_bwd = lambda: backward_only(lib_out, lib_leaves)
            iters = 10 if N >= 1024 else 100
            times = {"fwd_stats": cuda_time_ms(fwd, iters), "dkdv": cuda_time_ms(dkdv, iters),
                     "dq": cuda_time_ms(dq, iters),
                     "plain_bwd": cuda_time_ms(plain, max(iters // 4, 3)),
                     "library_fwd_bwd": cuda_time_ms(library, iters),
                     "library_bwd": cuda_time_ms(library_bwd, iters)}
            times["dkdv_plus_dq"] = times["dkdv"] + times["dq"]
            name = str(dtype).split(".")[1]
            # the fp32 backward runs on 3xTF32 tensor-core products at every d
            fp32 = dtype == torch.float32
            bwd_peak, bwd_products = (TF32_PEAK, TF32_PRODUCTS) if fp32 else (BF16_PEAK, 1)
            val = B * H * N * d * q.element_size()
            stats_bytes = B * H * N * 4
            rec = {"shape": [B, H, N, d], "dtype": name,
                   "max_abs_err": {g: e[0] for g, e in errs.items()},
                   "rel_err": {g: e[1] for g, e in errs.items()},
                   "rel_err_vs_plain_backward": {g: e[1] for g, e in errs_explicit.items()},
                   "pair_rel_err_vs_plain_backward": {g: e[1] for g, e in pair_errs.items()},
                   "ms": times,
                   "bound_ms": {
                       "fwd_stats": bound(*fwd_ops(4.0 * B * H * N * N * d, dtype, d),
                                          4 * val + B * N + 2 * stats_bytes),
                       "dkdv": bound(bwd_products * 8.0 * B * H * N * N * d, bwd_peak,
                                     6 * val + 3 * stats_bytes + B * N),
                       "dq": bound(bwd_products * 6.0 * B * H * N * N * d, bwd_peak,
                                   5 * val + 3 * stats_bytes + B * N)}}
            print("attn_bwd " + json.dumps(rec) + f"  [{card}]", flush=True)
            tag = {(RECORD_SHAPE, "bfloat16"): "", (RECORD_SHAPE, "float32"): "_fp32"}.get(
                ((B, H, N, d), name))
            if tag is not None:
                common = {"plain_ms": times["plain_bwd"], "library_ms": times["library_bwd"]}
                records["flash_attn_fwd" + tag] = {"ms": times["fwd_stats"],
                                                   **rec["bound_ms"]["fwd_stats"]}
                records["flash_attn_bwd_dkdv" + tag] = {
                    "max_abs_err": max(pair_errs["dk"][0], pair_errs["dv"][0]),
                    "ms": times["dkdv"], **common, **rec["bound_ms"]["dkdv"]}
                records["flash_attn_bwd_dq" + tag] = {
                    "max_abs_err": pair_errs["dq"][0], "ms": times["dq"], **common,
                    **rec["bound_ms"]["dq"]}
    print(f"attn bwd worst relative error over every shape: {json.dumps(worst)}", flush=True)
    return records


def pair_case(B, N, lengths, weighted, seed=0):
    """Inputs of the fused pairwise loss on the card: LambdaRank rows sorted by
    score with pads last and their normalised gains, as lambda_rank_fused
    builds them; RankNet rows in the raw order with random pad scores."""
    import torch

    from ptranking_tpu_torch import EPSILON
    from ptranking_tpu_torch.losses.listwise import _full_dcg
    from ptranking_tpu_torch.ops import gain, sort_labels_by_scores

    g = torch.Generator(device="cpu").manual_seed(seed)
    scores = torch.randn(B, N, generator=g)
    labels = torch.randint(0, 5, (B, N), generator=g).float().sort(dim=1, descending=True).values
    lens = torch.full((B,), N) if lengths is None else torch.tensor(lengths)
    mask = torch.arange(N)[None, :] < lens[:, None]
    scores, labels, mask = scores.cuda(), torch.where(mask, labels, 0.0).cuda(), mask.cuda()
    if not weighted:
        return scores, labels, torch.zeros_like(scores), mask
    s, l, m = sort_labels_by_scores(scores, labels, mask)
    idcg = torch.clamp(_full_dcg(labels, mask), min=EPSILON)
    n_gains = gain(torch.where(m, l, 0.0)) / idcg[:, None]
    return s.contiguous(), l.contiguous(), n_gains.contiguous(), m.contiguous()


def check_pairwise(card):
    """Phase 3: the fused pairwise loss kernels against their plain versions
    at every PAIR_SHAPES case; returns the records at PAIR_RECORD."""
    import torch

    from ptranking_tpu_torch.ops.pairwise_fused import (PAIRWISE_LAMBDA_BWD, PAIRWISE_LAMBDA_FWD,
                                                        pairwise_lambda_grad_plain,
                                                        pairwise_lambda_loss_plain)

    sfu_rate = sfu_ops_per_s()
    records = {}
    worst = {"loss": 0.0, "grad": 0.0}
    for (B, N, lengths, weighted, sigma) in PAIR_SHAPES:
        s, l, g, m = pair_case(B, N, lengths, weighted)
        scale = torch.tensor([0.75], device="cuda")
        fwd = lambda: torch.sum(PAIRWISE_LAMBDA_FWD(s, l, g, m, sigma, weighted))
        bwd = lambda: PAIRWISE_LAMBDA_BWD(s, l, g, m, scale, sigma, weighted)
        plain_fwd = lambda: pairwise_lambda_loss_plain(s, l, g, m, sigma, weighted)
        plain_bwd = lambda: 0.75 * pairwise_lambda_grad_plain(s, l, g, m, sigma, weighted)
        loss, loss_ref, grad, grad_ref = fwd(), plain_fwd(), bwd(), plain_bwd()
        loss2, grad2 = fwd(), bwd()  # no atomics, a fixed order: the same bits again
        torch.cuda.synchronize()
        if not torch.equal(loss, loss2) or not torch.equal(grad, grad2):
            raise AssertionError(f"pairwise_lambda {(B, N, lengths, weighted, sigma)}: two runs "
                                 f"on the same inputs differ")
        loss_err = abs(float(loss) - float(loss_ref))
        loss_rel = loss_err / abs(float(loss_ref)) if float(loss_ref) != 0 else loss_err
        grad_err = float((grad - grad_ref).abs().max())
        grad_rel = rel_err(grad, grad_ref)
        finite = bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all())
        if not finite or not loss_rel <= PAIR_TOL or not grad_rel <= PAIR_TOL:
            raise AssertionError(f"pairwise_lambda {(B, N, lengths, weighted, sigma)}: loss "
                                 f"{float(loss)} vs {float(loss_ref)}, grad relative error "
                                 f"{grad_rel} (tol {PAIR_TOL}), all finite: {finite}")
        worst = {"loss": max(worst["loss"], loss_rel), "grad": max(worst["grad"], grad_rel)}
        if (B, N) != PAIR_RECORD:
            continue
        n = m.sum(dim=1).double()
        pairs = float(torch.sum(n * (n - 1) / 2))
        row_bytes = B * N * (3 * 4 + 1)
        times = {"fwd": cuda_time_ms(fwd, 20), "bwd": cuda_time_ms(bwd, 20),
                 "plain_fwd": cuda_time_ms(plain_fwd, 5), "plain_bwd": cuda_time_ms(plain_bwd, 5)}
        bound_fwd = max(bound(pairs * PAIR_FWD_OPS, FP32_PEAK, row_bytes + B * 4 * ((N + 255) // 256)),
                        bound(pairs * PAIR_SFU_OPS, sfu_rate, 0.0), key=lambda b: b["bound_ms"])
        bound_bwd = max(bound(pairs * PAIR_BWD_OPS, FP32_PEAK, row_bytes + B * N * 4),
                        bound(pairs * PAIR_SFU_OPS, sfu_rate, 0.0), key=lambda b: b["bound_ms"])
        rec = {"shape": [B, N], "pairs_fwd": pairs, "pairs_bwd": pairs,
               "sfu_ops_per_s": sfu_rate, "loss_abs_err": loss_err, "loss_rel_err": loss_rel,
               "grad_abs_err": grad_err, "grad_rel_err": grad_rel, "ms": times,
               "bound_fwd": bound_fwd, "bound_bwd": bound_bwd,
               "bound_bwd_ms_on_ordered_pairs": 2 * pairs * PAIR_SFU_OPS / sfu_rate * 1e3}
        print("pairwise " + json.dumps(rec) + f"  [{card}]", flush=True)
        records["pairwise_lambda_fwd"] = {"max_abs_err": loss_err, "ms": times["fwd"],
                                          "plain_ms": times["plain_fwd"], "library_ms": None,
                                          **bound_fwd}
        records["pairwise_lambda_bwd"] = {"max_abs_err": grad_err, "ms": times["bwd"],
                                          "plain_ms": times["plain_bwd"], "library_ms": None,
                                          **bound_bwd}
    print(f"pairwise: {len(PAIR_SHAPES)} cases agree, each the same bits on two runs; worst "
          f"relative error {json.dumps(worst)}", flush=True)
    return records


def check_grid_limits(card):
    """Phase 3: shapes past grid.y's 65535: attention at B*H = 65538
    (GRID_SHAPE; two launches of each kernel, whole lists each), bf16 and
    fp32, forward and backward against attention_forward_plain and
    attention_backward_plain under the usual tolerances; the pairwise loss
    at PAIR_BIG against its plain versions under PAIR_TOL."""
    import torch

    from ptranking_tpu_torch.ops.attention import (FLASH_ATTN_BWD_DKDV, FLASH_ATTN_BWD_DQ,
                                                   FLASH_ATTN_FWD, attention_backward_plain)
    from ptranking_tpu_torch.ops.pairwise_fused import (PAIRWISE_LAMBDA_BWD, PAIRWISE_LAMBDA_FWD,
                                                        pairwise_lambda_grad_plain,
                                                        pairwise_lambda_loss_plain)

    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, mask = attention_inputs(*GRID_SHAPE, True, dtype)
        worst = {n: {"out": 0.0, "row_max": 0.0, "row_sum": 0.0} for n in ("bfloat16", "float32")}
        fwd_err = check_plain_forward(q, k, v, mask, worst)
        dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to("cuda", dtype)
        start = FLASH_ATTN_FWD.launches
        out, row_max, row_sum = FLASH_ATTN_FWD(q, k, v, mask, stats=True)
        if FLASH_ATTN_FWD.launches - start != 2:
            raise AssertionError(f"attention at {GRID_SHAPE}: "
                                 f"{FLASH_ATTN_FWD.launches - start} launches, expected 2")
        dsum = torch.sum(dout.float() * out.float(), dim=-1)
        dk, dv = FLASH_ATTN_BWD_DKDV(q, k, v, dout, row_max, row_sum, dsum, mask)
        dq = FLASH_ATTN_BWD_DQ(q, k, v, dout, row_max, row_sum, dsum, mask)
        ref = attention_backward_plain(q, k, v, dout, out, row_max, row_sum, mask)
        torch.cuda.synchronize()
        errs = check_bwd_close((dq, dk, dv), ref, mask, GRID_SHAPE, dtype,
                               "attention_backward_plain")
        rec[str(dtype).split(".")[1]] = {"fwd_rel_err": fwd_err,
                                         "bwd_rel_err": {g: e[1] for g, e in errs.items()}}
    s, l, g, m = pair_case(*PAIR_BIG, None, True)
    scale = torch.tensor([0.75], device="cuda")
    loss = torch.sum(PAIRWISE_LAMBDA_FWD(s, l, g, m))
    grad = PAIRWISE_LAMBDA_BWD(s, l, g, m, scale)
    loss_ref = pairwise_lambda_loss_plain(s, l, g, m)
    grad_ref = 0.75 * pairwise_lambda_grad_plain(s, l, g, m)
    torch.cuda.synchronize()
    loss_rel = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
    grad_rel = rel_err(grad, grad_ref)
    rec["pairwise"] = {"shape": list(PAIR_BIG), "loss_rel_err": loss_rel, "grad_rel_err": grad_rel}
    print("grid_limits " + json.dumps({"attention_shape": list(GRID_SHAPE), **rec})
          + f"  [{card}]", flush=True)
    if not max(loss_rel, grad_rel) <= PAIR_TOL:
        raise AssertionError(f"pairwise_lambda {PAIR_BIG}: {rec['pairwise']} (tol {PAIR_TOL})")


def check_packed(card):
    """Phase 3: the backward kernels that take whole lists into a block
    (FLASH_ATTN_BWD_PACKED: bf16 and fp32 lists of at most 64 docs, several
    a 64-row tile; FLASH_ATTN_BWD_LIST: bf16 and fp32 lists of 65..128 docs,
    one a 128-row tile; FLASH_ATTN_BWD_LONG: bf16 and fp32 lists of
    129..256 docs, one a 256-row tile; fp32 on 3xTF32 tensor-core products;
    each dq, dk, dv in one launch) against attention_backward_packed_plain
    and attention_backward_plain on the forward kernel's output and row
    statistics: the packed kernel at PACK_DS x PACK_NS and at PACK_BIG, the
    list kernel at PACK_DS x LIST_NS, the long kernel at PACK_DS x LONG_NS
    (each with a one-doc and a fully padded list; the list and long
    kernels' shapes past 65535 lists: check_big), each in both dtypes and where it is
    timed, each the same bits on two runs and one launch a call; where timed
    (PACK_TIMED, LIST_TIMED, LONG_TIMED) also the time of the kernel, of the
    wide dk/dv and dq pair it replaces there, of SDPA's backward alone (fp32:
    with TF32 off, so that it computes in fp32), of the plain version, and
    the bound. Returns the records at PACK_RECORD (bf16, and fp32 under
    "flash_attn_bwd_packed_fp32"), LIST_RECORD and LONG_RECORD (fp32 under
    "flash_attn_bwd_list_fp32" and "flash_attn_bwd_long_fp32")."""
    import torch
    import torch.nn.functional as Fn

    # fp32 products of the plain versions and of SDPA in fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ptranking_tpu_torch.ops.attention import (FLASH_ATTN_BWD_DKDV, FLASH_ATTN_BWD_DQ,
                                                   FLASH_ATTN_BWD_LIST, FLASH_ATTN_BWD_LONG,
                                                   FLASH_ATTN_BWD_PACKED, FLASH_ATTN_FWD,
                                                   attention_backward_packed_plain,
                                                   attention_backward_plain)

    def run(kernel, dtype, B, H, N, d, all_padded):
        """The kernel against both plain versions; returns (inputs, errors)."""
        q, k, v, mask = attention_inputs(B, H, N, d, all_padded, dtype)
        if all_padded:
            mask[1, 1:] = False  # beside the padded list, one with one real document
        g = torch.Generator(device="cpu").manual_seed(1)
        dout = torch.randn(B, H, N, d, generator=g).to("cuda", dtype)
        out, row_max, row_sum = FLASH_ATTN_FWD(q, k, v, mask, stats=True)
        dsum = torch.sum(dout.float() * out.float(), dim=-1)
        args = (q, k, v, dout, row_max, row_sum, dsum, mask)
        start = kernel.launches
        got, again = kernel(*args), kernel(*args)
        launched = kernel.launches - start
        plains = {"packed_plain": attention_backward_packed_plain(q, k, v, dout, out, row_max,
                                                                  row_sum, mask),
                  "plain": attention_backward_plain(q, k, v, dout, out, row_max, row_sum, mask)}
        torch.cuda.synchronize()
        shape = (B, H, N, d)
        if launched != 2 or not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{kernel.name} {shape}: {launched} launches for 2 calls, the "
                                 f"same bits twice: "
                                 f"{[torch.equal(a, b) for a, b in zip(got, again)]}")
        errs = {}
        tol = BWD_TOL[str(dtype).split(".")[1]]
        for which, ref in plains.items():
            floor = PACK_FLOOR * float(ref[2].float().abs().max())
            for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                if not bool(torch.isfinite(a.float()).all()):
                    raise AssertionError(f"{kernel.name} {dtype} {shape}: non-finite {name}")
                diff = float((a.float() - b.float()).abs().max())
                rel = diff / max(float(b.float().abs().max()), floor)
                if not rel <= tol:
                    raise AssertionError(f"{kernel.name} {dtype} {shape} against {which}: "
                                         f"{name} relative error {rel} (tol {tol})")
                errs[f"{which}_{name}"] = (diff, rel)
        return args, out, errs

    records = {}
    for kernel, dtype, ns, big, timed, record in (
            (FLASH_ATTN_BWD_PACKED, torch.bfloat16, PACK_NS, [(*PACK_BIG, True)], PACK_TIMED,
             PACK_RECORD),
            (FLASH_ATTN_BWD_PACKED, torch.float32, PACK_NS, [(*PACK_BIG, True)], PACK_TIMED,
             PACK_RECORD),
            (FLASH_ATTN_BWD_LIST, torch.bfloat16, LIST_NS, [], LIST_TIMED, LIST_RECORD),
            (FLASH_ATTN_BWD_LONG, torch.bfloat16, LONG_NS, [], LONG_TIMED, LONG_RECORD),
            (FLASH_ATTN_BWD_LIST, torch.float32, LIST_NS, [], LIST_TIMED, LIST_RECORD),
            (FLASH_ATTN_BWD_LONG, torch.float32, LONG_NS, [], LONG_TIMED, LONG_RECORD)):
        fp32 = dtype == torch.float32
        tag = kernel.name + ("_fp32" if fp32 else "")
        worst = {}
        shapes = [(*PACK_LISTS, N, d, True) for d in PACK_DS for N in ns] + big
        for shape in shapes:
            _, _, errs = run(kernel, dtype, *shape)
            for key, (_, rel) in errs.items():
                worst[key] = max(worst.get(key, 0.0), rel)
        print(f"attn bwd {tag}: {len(shapes)} shapes agree with both plain versions, "
              f"each the same bits on two runs; worst relative error {json.dumps(worst)}  "
              f"[{card}]", flush=True)

        for (B, H, N, d) in timed:
            args, out, errs = run(kernel, dtype, B, H, N, d, False)
            q, k, v, dout, row_max, row_sum, dsum, mask = args
            fused = lambda: kernel(*args)
            pair = lambda: (FLASH_ATTN_BWD_DKDV(*args), FLASH_ATTN_BWD_DQ(*args))
            plain = lambda: attention_backward_packed_plain(q, k, v, dout, out, row_max, row_sum,
                                                            mask)
            bias = torch.where(mask, 0.0, -1e9).to(dtype)[:, None, None, :].expand(B, H, N, N)
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            lib_out = Fn.scaled_dot_product_attention(*leaves, attn_mask=bias)

            def library():  # SDPA's backward alone, from a kept graph
                for t in leaves:
                    t.grad = None
                lib_out.backward(dout, retain_graph=True)

            times = {"kernel": cuda_time_ms(fused, 50), "pair": cuda_time_ms(pair, 20),
                     "library_bwd": cuda_time_ms(library, 50), "plain": cuda_time_ms(plain, 5)}
            val = B * H * N * d * q.element_size()
            # q, k, v, dO read, dq, dk, dv written once; m, l, D read; the mask
            flops = 10.0 * B * H * N * N * d
            bnd = bound(TF32_PRODUCTS * flops if fp32 else flops, TF32_PEAK if fp32 else BF16_PEAK,
                        7 * val + 3 * B * H * N * 4 + B * N)
            rec = {"shape": [B, H, N, d], "dtype": str(dtype).split(".")[1], "ms": times,
                   "pair_over_kernel": times["pair"] / times["kernel"],
                   "library_over_kernel": times["library_bwd"] / times["kernel"],
                   "max_abs_err": {key: e[0] for key, e in errs.items()},
                   "rel_err": {key: e[1] for key, e in errs.items()}, **bnd}
            print(f"attn_bwd_{kernel.name.split('_')[-1]} " + json.dumps(rec) + f"  [{card}]",
                  flush=True)
            if (B, H, N, d) == record:
                records[tag] = {
                    "max_abs_err": max(e[0] for key, e in errs.items() if key.startswith("plain_")),
                    "ms": times["kernel"], "plain_ms": times["plain"],
                    "library_ms": times["library_bwd"], **bnd}
    return records


def check_packed_fwd(card):
    """Phase 3: the forward kernels that take whole lists into a block
    (FLASH_ATTN_FWD_PACKED: bf16 lists of at most 128 docs and fp32 lists of
    at most 64 (3xTF32 tensor-core products), S once a tile, and fp32 lists
    of 65..128 docs on the fp32 list kernel's 128-row tile;
    FLASH_ATTN_FWD_LONG: bf16 lists of 129..256 docs, S once a 256-key tile
    in two halves, and fp32 ones on the fp32 list kernel's 256-row tile (S
    once in slices of 64 keys, 3xTF32); one launch each) against
    attention_forward_packed_plain and attention_forward_plain, output and
    row statistics, with a one-doc and a fully padded list: the packed
    kernel at PACK_DS x FWD_PACK_NS and at PACK_BIG (fp32: PACK_DS x PACK_NS
    and PACK_BIG), the long kernel at PACK_DS x LONG_NS (and at LONG_BIG:
    check_big), the fp32 list kernel at PACK_DS x LIST_NS and x LONG_NS (and
    at F32_LIST_BIG and LONG_BIG: check_big): the same bits on two runs,
    the same output with and without statistics, one launch a call; at
    FWD_PACK_TIMED (fp32: its shapes of at most 64 docs), LONG_TIMED and,
    for the fp32 list kernel, LIST_TIMED and LONG_TIMED also the time of
    the kernel with statistics (the call training makes), of the wide
    forward it replaces there, of SDPA's forward (fp32: with TF32 off), of
    the packed plain version, and the bound. Returns the records at
    FWD_PACK_RECORD (bf16, and fp32 under "flash_attn_fwd_packed_fp32"),
    LONG_RECORD, and at LIST_RECORD and LONG_RECORD for the fp32 list
    kernel ("flash_attn_fwd_list_fp32", "flash_attn_fwd_long_fp32")."""
    import torch
    import torch.nn.functional as Fn

    # fp32 products of the plain versions and of SDPA in fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ptranking_tpu_torch.ops.attention import (FLASH_ATTN_FWD, FLASH_ATTN_FWD_LONG,
                                                   FLASH_ATTN_FWD_PACKED,
                                                   attention_forward_packed_plain,
                                                   attention_forward_plain)

    def run(kernel, dtype, B, H, N, d, all_padded):
        """The kernel against both plain versions; returns (inputs, errors)."""
        q, k, v, mask = attention_inputs(B, H, N, d, all_padded, dtype)
        if all_padded:
            mask[1, 1:] = False  # beside the padded list, one with one real document
        start = kernel.launches
        got, again = kernel(q, k, v, mask, stats=True), kernel(q, k, v, mask, stats=True)
        bare = kernel(q, k, v, mask)
        launched = kernel.launches - start
        plains = {"packed_plain": attention_forward_packed_plain(q, k, v, mask),
                  "plain": attention_forward_plain(q, k, v, mask)}
        torch.cuda.synchronize()
        shape = (B, H, N, d)
        same = [torch.equal(a, b) for a, b in zip(got, again)] + [torch.equal(got[0], bare)]
        if launched != 3 or not all(same):
            raise AssertionError(f"{kernel.name} {shape}: {launched} launches for 3 calls, the "
                                 f"same bits (twice with statistics, and without): {same}")
        if not all(bool(torch.isfinite(t.float()).all()) for t in got):
            raise AssertionError(f"{kernel.name} {shape}: non-finite output or statistics")
        errs = {}
        name = str(dtype).split(".")[1]
        for which, (ref, ref_max, ref_sum) in plains.items():
            out_err = (rel_err(got[0], ref) if which == "packed_plain"
                       else float((got[0].float() - ref.float()).abs().max()))
            tol = FWD_PLAIN_TOL[name] if which == "packed_plain" else ATTN_TOL[name]
            e = {"out": out_err,
                 "row_max": float(((got[1] - ref_max).abs() / (1.0 + ref_max.abs())).max()),
                 "row_sum": float(((got[2] - ref_sum).abs() / ref_sum).max())}
            if not e["out"] <= tol or not max(e["row_max"], e["row_sum"]) <= STATS_TOL:
                raise AssertionError(f"{kernel.name} {name} {shape} against {which}: {e} (out "
                                     f"tol {tol}, statistics {STATS_TOL})")
            errs.update({f"{which}_{key}": x for key, x in e.items()})
        return (q, k, v, mask), errs

    records = {}
    for tag, kernel, dtype, ns, big, timed, record in (
            ("flash_attn_fwd_packed", FLASH_ATTN_FWD_PACKED, torch.bfloat16, FWD_PACK_NS,
             [(*PACK_BIG, True)], FWD_PACK_TIMED, FWD_PACK_RECORD),
            ("flash_attn_fwd_packed_fp32", FLASH_ATTN_FWD_PACKED, torch.float32, PACK_NS,
             [(*PACK_BIG, True)], [s for s in FWD_PACK_TIMED if s[2] <= 64], FWD_PACK_RECORD),
            ("flash_attn_fwd_long", FLASH_ATTN_FWD_LONG, torch.bfloat16, LONG_NS, [], LONG_TIMED,
             LONG_RECORD),
            ("flash_attn_fwd_list_fp32", FLASH_ATTN_FWD_PACKED, torch.float32, LIST_NS, [],
             LIST_TIMED, LIST_RECORD),
            ("flash_attn_fwd_long_fp32", FLASH_ATTN_FWD_LONG, torch.float32, LONG_NS, [],
             LONG_TIMED, LONG_RECORD)):
        fp32 = dtype == torch.float32
        worst = {}
        shapes = [(*PACK_LISTS, N, d, True) for d in PACK_DS for N in ns] + big
        for shape in shapes:
            _, errs = run(kernel, dtype, *shape)
            for key, e in errs.items():
                worst[key] = max(worst.get(key, 0.0), e)
        print(f"attn fwd {tag}: {len(shapes)} shapes agree with both plain versions, "
              f"each the same bits on two runs; worst error (out: relative to the packed plain "
              f"version, absolute to attention_forward_plain) {json.dumps(worst)}  [{card}]",
              flush=True)

        for (B, H, N, d) in timed:
            (q, k, v, mask), errs = run(kernel, dtype, B, H, N, d, False)
            bias = torch.where(mask, 0.0, -1e9).to(dtype)[:, None, None, :].expand(B, H, N, N)
            times = {"kernel": cuda_time_ms(lambda: kernel(q, k, v, mask, stats=True), 50),
                     "wide": cuda_time_ms(lambda: FLASH_ATTN_FWD(q, k, v, mask, stats=True), 20),
                     "library": cuda_time_ms(
                         lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=bias), 50),
                     "plain": cuda_time_ms(lambda: attention_forward_packed_plain(q, k, v, mask),
                                           5)}
            # q, k, v read and o written once; the mask; the row statistics written
            flops = 4.0 * B * H * N * N * d
            bnd = bound(TF32_PRODUCTS * flops if fp32 else flops, TF32_PEAK if fp32 else BF16_PEAK,
                        4 * B * H * N * d * q.element_size() + B * N + 2 * B * H * N * 4)
            rec = {"shape": [B, H, N, d], "dtype": str(dtype).split(".")[1], "ms": times,
                   "wide_over_kernel": times["wide"] / times["kernel"],
                   "library_over_kernel": times["library"] / times["kernel"], "errors": errs, **bnd}
            print(f"attn_{tag[len('flash_attn_'):]} " + json.dumps(rec) + f"  [{card}]",
                  flush=True)
            if (B, H, N, d) == record:
                records[tag] = {
                    "max_abs_err": float((kernel(q, k, v, mask).float()
                                          - attention_forward_plain(q, k, v, mask)[0].float())
                                         .abs().max()),
                    "ms": times["kernel"], "plain_ms": times["plain"],
                    "library_ms": times["library"], **bnd}
    return records


def check_wide_tf32(card):
    """Phase 3: the fp32 wide kernels (d > 128, 3xTF32: FLASH_ATTN_FWD,
    FLASH_ATTN_BWD_DKDV and FLASH_ATTN_BWD_DQ with fp32 inputs at d > 128,
    the route of every fp32 list past F32_LONG_MAX_N docs) at WIDE_F32_NS x
    WIDE_F32_DS, four lists a case (full, one real document, ragged, all
    padded): the forward with statistics twice and without, the same bits,
    against attention_forward_plain (FWD_PLAIN_TOL relative, STATS_TOL) and
    blockwise_attention (ATTN_TOL on real rows); the dk/dv and dq kernels
    twice, the same bits, against attention_backward_plain (every list) and
    autograd through blockwise_attention (the lists with a real document:
    an all-padded one differs by contract), BWD_TOL relative to
    max(max |plain|, PACK_FLOOR x max |plain dv|) (a one-doc list's dq and
    dk are rounding noise); one launch a call. At WIDE_F32_TIMED the time of
    each kernel beside SDPA's fp32 forward and its backward alone (TF32 off), the
    plain versions and the 3xTF32 bounds. Returns the records at
    WIDE_F32_RECORD ("flash_attn_fwd_wide_fp32", "flash_attn_bwd_dkdv_wide_fp32",
    "flash_attn_bwd_dq_wide_fp32")."""
    import torch
    import torch.nn.functional as Fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ptranking_tpu_torch.ops.attention import (FLASH_ATTN_BWD_DKDV, FLASH_ATTN_BWD_DQ,
                                                   FLASH_ATTN_FWD, attention_backward_plain,
                                                   attention_forward_plain, blockwise_attention)

    def plain_fn(q, k, v, m):
        return blockwise_attention(q, k, v, m, block_size=min(128, q.shape[2]))

    def run(B, H, N, d, edge_lists):
        q, k, v, mask = attention_inputs(B, H, N, d, edge_lists, torch.float32)
        if edge_lists:
            mask[1, 1:] = False  # one real document; the last list all padded
        g = torch.Generator(device="cpu").manual_seed(1)
        dout = torch.randn(B, H, N, d, generator=g).to("cuda")
        kernels = (FLASH_ATTN_FWD, FLASH_ATTN_BWD_DKDV, FLASH_ATTN_BWD_DQ)
        start = [kern.launches for kern in kernels]
        got, again = (FLASH_ATTN_FWD(q, k, v, mask, stats=True) for _ in range(2))
        bare = FLASH_ATTN_FWD(q, k, v, mask)
        out, row_max, row_sum = got
        dsum = torch.sum(dout * out, dim=-1)
        args = (q, k, v, dout, row_max, row_sum, dsum, mask)
        grads = [(FLASH_ATTN_BWD_DQ(*args), *FLASH_ATTN_BWD_DKDV(*args)) for _ in range(2)]
        launched = [kern.launches - s for kern, s in zip(kernels, start)]
        ref, ref_max, ref_sum = attention_forward_plain(q, k, v, mask)
        dense = plain_fn(q, k, v, mask)
        plains = {"plain": attention_backward_plain(q, k, v, dout, out, row_max, row_sum, mask),
                  "autograd": attention_grads(plain_fn, q, k, v, mask, dout)}
        torch.cuda.synchronize()
        shape = (B, H, N, d)
        same = ([torch.equal(a, b) for a, b in zip(got, again)] + [torch.equal(out, bare)]
                + [torch.equal(a, b) for a, b in zip(*grads)])
        if launched != [3, 2, 2] or not all(same):
            raise AssertionError(f"fp32 wide kernels {shape}: launches {launched} for 3 forward "
                                 f"and 2 backward calls, the same bits twice: {same}")
        if not all(bool(torch.isfinite(t).all()) for t in (*got, *grads[0])):
            raise AssertionError(f"fp32 wide kernels {shape}: a non-finite output")
        real = mask[:, None, :, None].expand_as(out)
        errs = {"out": rel_err(out, ref),
                "row_max": float(((row_max - ref_max).abs() / (1.0 + ref_max.abs())).max()),
                "row_sum": float(((row_sum - ref_sum).abs() / ref_sum).max()),
                "out_vs_blockwise": float((out - dense).abs()[real].max())}
        if (not errs["out"] <= FWD_PLAIN_TOL["float32"]
                or not max(errs["row_max"], errs["row_sum"]) <= STATS_TOL
                or not errs["out_vs_blockwise"] <= ATTN_TOL["float32"]):
            raise AssertionError(f"flash_attn_fwd fp32 wide {shape}: {errs} (tol "
                                 f"{FWD_PLAIN_TOL['float32']}, statistics {STATS_TOL}, against "
                                 f"blockwise {ATTN_TOL['float32']})")
        has_doc = mask.any(dim=1)  # autograd through blockwise: an all-padded list by contract
        for which, want in plains.items():
            keep = slice(None) if which == "plain" else has_doc
            floor = PACK_FLOOR * float(want[2][keep].abs().max())
            for name, a, b in zip(("dq", "dk", "dv"), grads[0], want):
                a, b = a[keep], b[keep]
                diff = float((a - b).abs().max())
                errs[f"{which}_{name}"] = diff / max(float(b.abs().max()), floor)
                errs[f"{which}_{name}_abs"] = diff
                if not errs[f"{which}_{name}"] <= BWD_TOL["float32"]:
                    raise AssertionError(f"flash_attn_bwd fp32 wide {shape} against {which}: "
                                         f"{name} relative error {errs[f'{which}_{name}']} "
                                         f"(tol {BWD_TOL['float32']})")
        return args, out, errs

    worst = {}
    for d in WIDE_F32_DS:
        for N in WIDE_F32_NS:
            _, _, errs = run(4, 1, N, d, True)
            for key, e in errs.items():
                worst[key] = max(worst.get(key, 0.0), e)
    print(f"attn fp32 wide: {len(WIDE_F32_DS) * len(WIDE_F32_NS)} shapes (N {WIDE_F32_NS} x d "
          f"{WIDE_F32_DS}, a one-doc and an all-padded list each) agree with both plain versions, "
          f"the same bits twice; worst {json.dumps(worst)}  [{card}]", flush=True)

    records = {}
    for (B, H, N, d) in WIDE_F32_TIMED:
        args, out, errs = run(B, H, N, d, False)
        q, k, v, dout, row_max, row_sum, dsum, mask = args
        bias = torch.where(mask, 0.0, -1e9)[:, None, None, :].expand(B, H, N, N)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = Fn.scaled_dot_product_attention(*leaves, attn_mask=bias)

        def library_bwd():  # SDPA's backward alone, from a kept graph
            for t in leaves:
                t.grad = None
            lib_out.backward(dout, retain_graph=True)

        iters = 10 if N * B * H >= 16384 else 50
        times = {"fwd": cuda_time_ms(lambda: FLASH_ATTN_FWD(q, k, v, mask, stats=True), iters),
                 "dkdv": cuda_time_ms(lambda: FLASH_ATTN_BWD_DKDV(*args), iters),
                 "dq": cuda_time_ms(lambda: FLASH_ATTN_BWD_DQ(*args), iters),
                 "library_fwd": cuda_time_ms(
                     lambda: Fn.scaled_dot_product_attention(q, k, v, attn_mask=bias), iters),
                 "library_bwd": cuda_time_ms(library_bwd, iters),
                 "plain_fwd": cuda_time_ms(lambda: attention_forward_plain(q, k, v, mask), 3),
                 "plain_bwd": cuda_time_ms(lambda: attention_backward_plain(
                     q, k, v, dout, out, row_max, row_sum, mask), 3)}
        times["dkdv_plus_dq"] = times["dkdv"] + times["dq"]
        val, stats_bytes = B * H * N * d * 4, B * H * N * 4
        flops = B * H * N * N * d
        bounds = {"fwd": bound(TF32_PRODUCTS * 4.0 * flops, TF32_PEAK,
                               4 * val + B * N + 2 * stats_bytes),
                  "dkdv": bound(TF32_PRODUCTS * 8.0 * flops, TF32_PEAK,
                                6 * val + 3 * stats_bytes + B * N),
                  "dq": bound(TF32_PRODUCTS * 6.0 * flops, TF32_PEAK,
                              5 * val + 3 * stats_bytes + B * N)}
        rec = {"shape": [B, H, N, d], "dtype": "float32", "ms": times,
               "library_fwd_over_fwd": times["library_fwd"] / times["fwd"],
               "library_bwd_over_pair": times["library_bwd"] / times["dkdv_plus_dq"],
               "bound_ms": bounds, "errors": errs}
        print("attn_f32_wide " + json.dumps(rec) + f"  [{card}]", flush=True)
        if (B, H, N, d) == WIDE_F32_RECORD:
            records["flash_attn_fwd_wide_fp32"] = {
                "max_abs_err": float((out - attention_forward_plain(q, k, v, mask)[0]).abs().max()),
                "ms": times["fwd"], "plain_ms": times["plain_fwd"],
                "library_ms": times["library_fwd"], **bounds["fwd"]}
            common = {"plain_ms": times["plain_bwd"], "library_ms": times["library_bwd"]}
            records["flash_attn_bwd_dkdv_wide_fp32"] = {
                "max_abs_err": max(errs["plain_dk_abs"], errs["plain_dv_abs"]),
                "ms": times["dkdv"], **common, **bounds["dkdv"]}
            records["flash_attn_bwd_dq_wide_fp32"] = {"max_abs_err": errs["plain_dq_abs"],
                                                 "ms": times["dq"], **common, **bounds["dq"]}
    return records


def check_big(card):
    """Phase 3: the kernels that take whole lists into a block at B*H past
    65535 lists (inputs drawn on the card, the last b fully padded): the bf16
    long forward and backward at LONG_BIG, and the fp32 list forward and
    backward at F32_LIST_BIG (the packed and the list entries) and at
    LONG_BIG (the long entries; in fp32 the second to last b a one-doc
    list). Each kernel the same bits on two runs and one launch a call, and
    on the first and the last two b (the last blocks of the grid) against
    both plain versions of those lists alone (a list's outputs depend on
    that list alone), under the gates of check_packed_fwd and
    check_packed."""
    import torch

    from ptranking_tpu_torch.ops.attention import (FLASH_ATTN_BWD_LIST, FLASH_ATTN_BWD_LONG,
                                                   FLASH_ATTN_FWD_LONG, FLASH_ATTN_FWD_PACKED,
                                                   attention_backward_packed_plain,
                                                   attention_backward_plain,
                                                   attention_forward_packed_plain,
                                                   attention_forward_plain)

    def case(dtype, shape, fwd_kernel, bwd_kernel):
        B, H, N, d = shape
        name = str(dtype).split(".")[1]
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, dout = (torch.randn(B, H, N, d, device="cuda", generator=g).to(dtype)
                         for _ in range(4))
        lengths = torch.randint(N // 4, N + 1, (B,), device="cuda", generator=g)
        lengths[0], lengths[-1] = N, 0
        if dtype == torch.float32:
            lengths[-2] = 1
        mask = torch.arange(N, device="cuda")[None, :] < lengths[:, None]
        start = (fwd_kernel.launches, bwd_kernel.launches)
        fwd = fwd_kernel(q, k, v, mask, stats=True)
        again = fwd_kernel(q, k, v, mask, stats=True)
        same = [torch.equal(a, b) for a, b in zip(fwd, again)]
        del again  # tens of GB at fp32
        out, row_max, row_sum = fwd
        dsum = torch.sum(dout.float() * out.float(), dim=-1)
        args = (q, k, v, dout, row_max, row_sum, dsum, mask)
        bwd = [bwd_kernel(*args) for _ in range(2)]
        torch.cuda.synchronize()
        launched = (fwd_kernel.launches - start[0], bwd_kernel.launches - start[1])
        same += [torch.equal(a, b) for a, b in zip(bwd[0], bwd[1])]
        if launched != (2, 2) or not all(same):
            raise AssertionError(f"{fwd_kernel.name}, {bwd_kernel.name} {name} at {shape}: "
                                 f"{launched} launches for 2 and 2 calls, the same bits "
                                 f"twice: {same}")
        rec = {"shape": list(shape), "dtype": name, "forward": fwd_kernel.name,
               "backward": bwd_kernel.name}
        for which_b, part in (("first", slice(0, 1)), ("last", slice(B - 2, B))):
            sq, sk, sv, sdo, sm = (t[part] for t in (q, k, v, dout, mask))
            got = [t[part] for t in fwd]
            ref_plain = attention_forward_packed_plain(sq, sk, sv, sm)
            ref = attention_forward_plain(sq, sk, sv, sm)
            e = {"out_vs_packed_plain": rel_err(got[0], ref_plain[0]),
                 "out_vs_plain": float((got[0].float() - ref[0].float()).abs().max()),
                 "row_max": max(float(((got[1] - r[1]).abs() / (1.0 + r[1].abs())).max())
                                for r in (ref_plain, ref)),
                 "row_sum": max(float(((got[2] - r[2]).abs() / r[2]).max())
                                for r in (ref_plain, ref))}
            if (not e["out_vs_packed_plain"] <= FWD_PLAIN_TOL[name]
                    or not e["out_vs_plain"] <= ATTN_TOL[name]
                    or not max(e["row_max"], e["row_sum"]) <= STATS_TOL):
                raise AssertionError(f"{fwd_kernel.name} {shape}, {which_b} b: {e}")
            plain_args = (sq, sk, sv, sdo, got[0], got[1], got[2], sm)
            for which, ref_b in (("packed_plain", attention_backward_packed_plain(*plain_args)),
                                 ("plain", attention_backward_plain(*plain_args))):
                floor = PACK_FLOOR * float(ref_b[2].float().abs().max())
                for gname, a, b in zip(("dq", "dk", "dv"), (t[part] for t in bwd[0]), ref_b):
                    rel = float((a.float() - b.float()).abs().max()) / max(
                        float(b.float().abs().max()), floor)
                    if not bool(torch.isfinite(a.float()).all()) or not rel <= BWD_TOL[name]:
                        raise AssertionError(f"{bwd_kernel.name} {name} {shape}, {which_b} b, "
                                             f"against {which}: {gname} relative error {rel}")
                    e[f"{which}_{gname}"] = rel
            rec[which_b] = e
        print("big " + json.dumps(rec) + f"  [{card}]", flush=True)

    for args in ((torch.bfloat16, LONG_BIG, FLASH_ATTN_FWD_LONG, FLASH_ATTN_BWD_LONG),
                 (torch.float32, F32_LIST_BIG, FLASH_ATTN_FWD_PACKED, FLASH_ATTN_BWD_LIST),
                 (torch.float32, LONG_BIG, FLASH_ATTN_FWD_LONG, FLASH_ATTN_BWD_LONG)):
        case(*args)
        torch.cuda.empty_cache()  # the case's tensors are gone: tens of GB at fp32


def sink_case(B, N, lengths, seed=0, dense=False, extreme=None):
    """Inputs of the half-step on the card as WassRank builds them: the `eg`
    cost of presorted labels, the log of the labels' softmax histogram as the
    marginal, and a log-scaling (the log of a random histogram); pads carry
    -1e30 in both. Under the `eg` cost at lam 0.1 a column's sum is its
    largest term (the others fall below fp32's epsilon), so `dense` swaps in
    a cost of |normal| draws, under which hundreds of terms of like size add
    up. `extreme` = (s, t) (with `dense`) scales every s-th entry by 1e-35
    and every t-th by 1e35: values outside the range the vector kernels' FMA
    division takes, so their chunks go through the division itself
    (SINK_EXTREMES). Returns (cost, log_marginal, log_u, mask)."""
    import torch

    from ptranking_tpu_torch.losses.wassrank import cost_mat_group, std_histogram_st
    from ptranking_tpu_torch.ops import masked_softmax
    from ptranking_tpu_torch.ops.sinkhorn import _safe_log

    g = torch.Generator(device="cpu").manual_seed(seed)
    labels = torch.randint(0, 5, (B, N), generator=g).float().sort(dim=1, descending=True).values
    lens = torch.full((B,), N) if lengths is None else torch.tensor(lengths)
    mask = (torch.arange(N)[None, :] < lens[:, None]).cuda()
    labels = torch.where(mask, labels.cuda(), 0.0)
    cost = cost_mat_group(labels, mask).contiguous()
    if dense:
        cost = torch.randn(B, N, N, generator=g).abs().cuda()
    if extreme:
        flat = cost.view(-1)
        flat[::extreme[0]] *= 1e-35
        flat[::extreme[1]] *= 1e35
    log_marg = _safe_log(std_histogram_st(labels, mask))
    log_u = _safe_log(masked_softmax(torch.randn(B, N, generator=g).cuda(), mask))
    return cost, log_marg, log_u, mask


def sink_errs(out, ref, mask, what):
    """(max |out - ref|, worst |out - ref| / (SINK_ATOL + SINK_RTOL |ref|)) over
    the real outputs, every output finite; raises past the tolerance."""
    import torch

    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"sinkstep {what}: non-finite output")
    if not bool(mask.any()):
        return 0.0, 0.0
    diff = (out - ref).abs()[mask]
    share = float((diff / (SINK_ATOL + SINK_RTOL * ref.abs()[mask])).max())
    if not share <= 1.0:
        raise AssertionError(f"sinkstep {what}: |kernel - plain| is {share} of its limit "
                             f"(rtol {SINK_RTOL}, atol {SINK_ATOL}); max abs {float(diff.max())}")
    return float(diff.max()), share


def check_sinkstep(card):
    """Phase 3: the Sinkhorn half-step kernel against its plain version, both
    orientations (the transposed one against the plain version on the
    transposed cost), at the edge cases and the timed widths, then 20
    iterations of scalings, kernel against plain; returns the record at
    SINK_RECORD."""
    import torch

    from ptranking_tpu_torch.ops.sinkhorn import log_sinkstep, sinkhorn_log_scalings
    from ptranking_tpu_torch.ops.sinkhorn_fused import SINKSTEP

    sfu_rate = sfu_ops_per_s()
    worst = 0.0

    def check_both(cost, log_marg, log_u, mask, lam, what):
        """Both orientations against the plain version; {name: (max abs err,
        share of the limit)}."""
        neg_c = -cost / lam
        errs = {}
        for name, transposed in (("cols", False), ("rows", True)):
            out = SINKSTEP(cost, log_marg, log_u, lam, transposed=transposed)
            ref = log_sinkstep(neg_c.transpose(-1, -2) if transposed else neg_c, log_marg, log_u)
            torch.cuda.synchronize()
            errs[name] = sink_errs(out, ref, mask, what + (name,))
        return errs

    costs = ((False, None), (True, None), *((True, e) for e in SINK_EXTREMES))  # eg, dense
    for (N, lengths, lam) in SINK_EDGES:
        for dense, extreme in costs:  # the dense cost is asymmetric: a swapped orientation shows
            errs = check_both(*sink_case(len(lengths), N, lengths, dense=dense, extreme=extreme),
                              lam, (N, lengths, lam, dense, extreme))
            worst = max(worst, *(e[1] for e in errs.values()))
    print(f"sinkstep edge cases: {len(SINK_EDGES)} x {len(costs)} costs x 2 orientations agree; "
          f"worst share of the limit {worst}", flush=True)

    record = None
    B = SINK_RECORD[0]
    lam = 0.1
    for N in SINK_TIMED_N + (SINK_RECORD[1],):
        cost, log_marg, log_u, mask = sink_case(B, N, None)
        neg_c = -cost / lam
        neg_c_t = neg_c.transpose(-1, -2)
        fns = {"cols": (lambda: SINKSTEP(cost, log_marg, log_u, lam),
                        lambda: log_sinkstep(neg_c, log_marg, log_u)),
               "rows": (lambda: SINKSTEP(cost, log_marg, log_u, lam, transposed=True),
                        lambda: log_sinkstep(neg_c_t, log_marg, log_u))}
        errs, ms, plain_ms = {}, {}, {}
        iters = 20 if N >= 1024 else 100
        for name, (kern, plain) in fns.items():
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            errs[name] = sink_errs(out, ref, mask, (B, N, name))
            ms[name] = cuda_time_ms(kern, iters)
            plain_ms[name] = cuda_time_ms(plain, max(iters // 4, 5))
        library = lambda: log_marg - torch.logsumexp(neg_c + log_u[..., :, None], dim=-2)
        library_ms = cuda_time_ms(library, max(iters // 4, 5))
        elements = float(B) * N * N
        nbytes = 4.0 * (elements + 4 * B * N)  # cost, marginal and log_u read, out written
        bnd = max(bound(elements * SINK_FP32_OPS, FP32_PEAK, nbytes),
                  bound(elements, sfu_rate, 0.0), key=lambda b: b["bound_ms"])
        dense = check_both(*sink_case(B, N, None, seed=1, dense=True), 0.3, (B, N, "dense"))
        extremes = {e: check_both(*sink_case(B, N, None, seed=2, dense=True, extreme=e), 0.3,
                                  (B, N, "extreme", e)) for e in SINK_EXTREMES}
        rec = {"shape": [B, N, N], "lam": lam, "max_neg_cost_over_lam": float(neg_c.abs().max()),
               "max_abs_err": {k: e[0] for k, e in errs.items()},
               "share_of_limit": {k: e[1] for k, e in errs.items()},
               "dense_cost_max_abs_err": {k: e[0] for k, e in dense.items()},
               "dense_cost_share_of_limit": {k: e[1] for k, e in dense.items()},
               "extreme_cost_share_of_limit": {f"{s}/{t}": {k: e[1] for k, e in errs_e.items()}
                                               for (s, t), errs_e in extremes.items()},
               "ms": ms, "plain_ms": plain_ms, "library_ms_cols": library_ms, **bnd}
        print("sinkstep " + json.dumps(rec) + f"  [{card}]", flush=True)
        if N == SINK_RECORD[1]:
            # a step launches as many of one orientation as of the other: the
            # record holds the mean of the two
            checked = [*errs.values(), *dense.values(),
                       *(e for errs_e in extremes.values() for e in errs_e.values())]
            record = {"max_abs_err": max(e[0] for e in checked),
                      "ms": sum(ms.values()) / 2, "plain_ms": sum(plain_ms.values()) / 2,
                      "library_ms": library_ms, **bnd}
            log_nu = log_marg
            start = SINKSTEP.launches
            got = sinkhorn_log_scalings(log_u, log_nu, cost, lam, 20)
            launched = SINKSTEP.launches - start
            want = sinkhorn_log_scalings(log_u, log_nu, cost, lam, 20, use_pallas=False)
            plain_launched = SINKSTEP.launches - start - launched
            torch.cuda.synchronize()
            if launched != 40 or plain_launched != 0:
                raise AssertionError(f"20 iterations launched the kernel {launched} times, and "
                                     f"{plain_launched} times under use_pallas=False")
            scal = {name: rel_err(a, b) for name, a, b in zip(("log_u", "log_v"), got, want)}
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            print("sinkhorn_scalings " + json.dumps({"iterations": 20, "rel_err": scal,
                                                      "max_abs": float(want[0].abs().max())})
                  + f"  [{card}]", flush=True)
            if not finite or not max(scal.values()) <= SINK_SCALINGS_TOL:
                raise AssertionError(f"20 Sinkhorn iterations, kernel against plain: {scal} "
                                     f"(tol {SINK_SCALINGS_TOL}), all finite: {finite}")
    return {"sinkstep": record}


def post_json(url: str, body: bytes) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        if resp.status != 200:
            raise AssertionError(f"POST {url}: HTTP {resp.status}")
        return json.loads(resp.read())


def scores_by_docid(results) -> dict:
    out = {}
    for r in results:
        for docid, s in zip(r["docids"], r["scores"]):
            if s is None or not math.isfinite(s):
                raise AssertionError(f"{r['qid']}/{docid}: non-finite score {s}")
            out[docid] = s
    return out


def serve_phase(card: str, work_dir: str, cfg=None, lengths=SERVE_LENGTHS,
                data_id: str = "MSLRWEB30K", letor_docs=(20, 400), tag: str = "flagship") -> int:
    """Phase 4: a ranker served over HTTP on the card: the flagship by
    default, or `cfg` on `lengths`; score_file then scores a LETOR file of
    `data_id` (of the model's width) with 8 queries of `letor_docs` docs.
    Returns the kernel's launch count from the one served request: 6 a
    batch, each batch's through the forward wrapper that fwd_route names for
    its list length."""
    import dataclasses
    import threading

    import numpy as np
    import torch

    from ptranking_tpu_torch import LTR_SEED
    from ptranking_tpu_torch.data.dataset import BucketedDataset, make_synthetic_queries
    from ptranking_tpu_torch.data.letor import write_letor_file
    from ptranking_tpu_torch.models import ScorerConfig, apply_scorer
    from ptranking_tpu_torch.ops.attention import (FLASH_ATTN_FWD, FLASH_ATTN_FWD_LONG,
                                                   FLASH_ATTN_FWD_PACKED, fwd_route)
    from ptranking_tpu_torch.score import score_file
    from ptranking_tpu_torch.serve import ScoringService, make_server
    from ptranking_tpu_torch.train import AdhocRanker

    if cfg is None:
        cfg = ScorerConfig.default_listsf(NUM_FEATURES, compute_dtype="bfloat16", flash_attn=True)
    F = cfg.num_features
    ckpt = os.path.join(work_dir, f"{tag}.pt")
    AdhocRanker("LambdaRank", cfg, seed=LTR_SEED, device="cuda").init().save(ckpt)
    service = ScoringService(ckpt, device="cuda")  # the server's default batch_docs
    dense = ScoringService(ckpt, device="cuda")
    dense.ranker.scorer_cfg = dataclasses.replace(cfg, flash_attn=False)

    rng = np.random.RandomState(LTR_SEED)
    docs = [rng.randn(n, F).astype(np.float32) for n in lengths]
    payload = {"queries": [{"qid": f"q{i}", "docs": d.tolist()} for i, d in enumerate(docs)]}
    body = json.dumps(payload).encode()
    ds = BucketedDataset([(str(i), d, np.zeros(len(d), np.float32)) for i, d in enumerate(docs)],
                         batch_docs=service.batch_docs, num_features=F)
    n_docs = sum(lengths)

    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/score"
    forwards = (FLASH_ATTN_FWD, FLASH_ATTN_FWD_PACKED, FLASH_ATTN_FWD_LONG)
    wrapper = {"flash": FLASH_ATTN_FWD.name, "packed": FLASH_ATTN_FWD_PACKED.name,
               "long": FLASH_ATTN_FWD_LONG.name}
    expected = {k.name: 0 for k in forwards}  # by fwd_route, batch by batch
    for b in ds.batches():
        route = fwd_route(getattr(torch, cfg.compute_dtype), b.mask.shape[1],
                          cfg.width // cfg.n_heads)
        expected[wrapper[route]] += 6
    try:
        for k in forwards:
            k.launches = 0
        answer = post_json(url, body)
        by_kernel = {k.name: k.launches for k in forwards}
        launches = sum(by_kernel.values())
        http_s = []
        for _ in range(SERVE_REPEATS):
            t0 = time.perf_counter()
            post_json(url, body)
            http_s.append(time.perf_counter() - t0)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if launches != 6 * len(ds) or by_kernel != expected:
        raise AssertionError(f"the forward kernels launched {by_kernel} times for "
                             f"{len(ds)} batches; expected {expected}: 6 per batch")
    got = scores_by_docid(answer["results"])
    want = scores_by_docid(dense.score(payload)["results"])
    if len(got) != n_docs or set(got) != set(want):
        raise AssertionError(f"served {len(got)} docs, expected {n_docs}")
    score_err = max(abs(got[k] - want[k]) for k in got)
    if not score_err <= SCORE_TOL:
        raise AssertionError(f"served scores differ from dense attention by "
                             f"{score_err} (tol {SCORE_TOL})")

    service_s = []
    for _ in range(SERVE_REPEATS):
        t0 = time.perf_counter()
        service.score(payload)
        service_s.append(time.perf_counter() - t0)
    busy_ms, flash_ms, wall_ms = profile_ms(lambda: service.score(payload))
    # the scorer alone over the request's batches, already on the card, with
    # the kernel and with dense attention (CUDA events around the loop, so
    # this includes the host's enqueue time wherever the host is slower)
    batches = [(torch.from_numpy(b.features).cuda(), torch.from_numpy(b.mask).cuda())
               for b in ds.batches()]
    scorer_ms = {}
    for name, svc in (("flash", service), ("dense", dense)):
        run = lambda: [apply_scorer(svc.ranker.params, svc.ranker.scorer_cfg, x, m)
                       for x, m in batches]
        with torch.inference_mode():
            scorer_ms[name] = cuda_time_ms(run, SERVE_REPEATS, warmup=1)

    # batch scoring of a LETOR file written by the port
    queries = make_synthetic_queries(8, num_features=F, max_label=4, min_docs=letor_docs[0],
                                     max_docs=letor_docs[1], seed=LTR_SEED)
    letor = write_letor_file(queries, os.path.join(work_dir, f"{tag}.txt"), with_comment=False)
    run_path = os.path.join(work_dir, f"{tag}.run")
    for k in forwards:
        k.launches = 0
    rows = score_file(ckpt, letor, run_path, data_id=data_id, device="cuda")
    file_launches = sum(k.launches for k in forwards)
    with open(run_path) as f:
        lines = [line.split() for line in f]
    if rows != sum(len(q[2]) for q in queries) or len(lines) != rows:
        raise AssertionError(f"score_file wrote {rows} rows for "
                             f"{sum(len(q[2]) for q in queries)} docs")
    if not all(math.isfinite(float(r[4])) for r in lines):
        raise AssertionError("score_file: non-finite scores")
    file_batches = len(BucketedDataset(queries, batch_docs=service.batch_docs))
    if file_launches != 6 * file_batches:
        raise AssertionError(f"score_file: {file_launches} kernel launches for "
                             f"{file_batches} batches; expected 6 per batch")

    med = sorted(http_s)[len(http_s) // 2]
    rec = {"model": tag, "head_dim": cfg.width // cfg.n_heads, "lists": len(lengths),
           "docs": n_docs, "batches": len(ds),
           "batch_docs": service.batch_docs, "launches": launches,
           "launches_by_kernel": by_kernel,
           "max_abs_score_err_vs_dense": score_err,
           "http_s": http_s, "lists_per_s": len(lengths) / med, "docs_per_s": n_docs / med,
           "service_s": service_s, "profiled_service_ms": wall_ms,
           "profiled_device_busy_ms": busy_ms, "profiled_flash_kernel_ms": flash_ms,
           "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
           "scorer_loop_ms_flash": scorer_ms["flash"],
           "scorer_loop_ms_dense": scorer_ms["dense"], "score_file_rows": rows,
           "score_file_launches": file_launches}
    print("serve " + json.dumps(rec) + f"  [{card}]", flush=True)
    return launches


def kernel_counters():
    from ptranking_tpu_torch.ops import attention
    from ptranking_tpu_torch.ops.pairwise_fused import PAIRWISE_LAMBDA_BWD, PAIRWISE_LAMBDA_FWD
    from ptranking_tpu_torch.ops.sinkhorn_fused import SINKSTEP

    attn = (attention.FLASH_ATTN_FWD, attention.FLASH_ATTN_FWD_PACKED,
            attention.FLASH_ATTN_FWD_LONG, attention.FLASH_ATTN_BWD_DKDV,
            attention.FLASH_ATTN_BWD_DQ, attention.FLASH_ATTN_BWD_PACKED,
            attention.FLASH_ATTN_BWD_LIST, attention.FLASH_ATTN_BWD_LONG)
    return {**{k.name: k for k in attn}, "pairwise_lambda_fwd": PAIRWISE_LAMBDA_FWD,
            "pairwise_lambda_bwd": PAIRWISE_LAMBDA_BWD, "sinkstep": SINKSTEP}


def reset_counts():
    for k in kernel_counters().values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in kernel_counters().items()}


def check_counts(counts: dict, steps: int, what: str, per_step: dict = LAUNCHES_PER_STEP):
    want = {name: n * steps for name, n in per_step.items()}
    if counts != want:
        raise AssertionError(f"{what}: kernel launches {counts}, expected {want} "
                             f"for {steps} steps")


def flagship_ranker(dropout: float = 0.1, compute_dtype: str = "bfloat16",
                    model_id: str = "LambdaRank", num_features: int = NUM_FEATURES,
                    lane_align: bool = False, n_heads: int = 2, mesh=None, device="cuda",
                    kernels: bool = True, **parallel):
    """The flagship scorer (or the same DASALC listsf at another width) under
    a loss with its default paras; LambdaRank goes through the fused pairwise
    kernel. With kernels=False, dense attention and the dense loss instead.
    With a mesh, the DistributedTrainer of the same config (with
    `parallel`'s tp, pp_stages or shard_docs)."""
    from ptranking_tpu_torch import LTR_SEED
    from ptranking_tpu_torch.models import ScorerConfig
    from ptranking_tpu_torch.parallel import DistributedTrainer
    from ptranking_tpu_torch.train import AdhocRanker, OptimizerConfig

    cfg = ScorerConfig.default_listsf(num_features, compute_dtype=compute_dtype,
                                      flash_attn=kernels, dropout=dropout, lane_align=lane_align,
                                      n_heads=n_heads)
    kw = dict(model_paras={"use_pallas": kernels} if model_id == "LambdaRank" else {},
              opt_cfg=OptimizerConfig(opt="Adagrad", lr=1e-3), seed=LTR_SEED, device=device)
    if mesh is not None:
        return DistributedTrainer(model_id, cfg, mesh, **kw, **parallel).init()
    return AdhocRanker(model_id, cfg, **kw).init()


def train_batch(B: int, N: int, ragged: bool, seed: int, num_features: int = NUM_FEATURES):
    """One padded batch of B lists in one N-doc bucket: full lists, or B-1
    lists of 20..N docs and an all-padded remainder row."""
    from ptranking_tpu_torch.data.dataset import BucketedDataset, make_synthetic_queries

    queries = make_synthetic_queries(B - 1 if ragged else B, num_features=num_features,
                                     max_label=4, min_docs=20 if ragged else N, max_docs=N,
                                     seed=seed)
    ds = BucketedDataset(queries, batch_docs=B * N, buckets=(N,), num_features=num_features)
    return next(iter(ds.batches()))


def leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


def vs_cpu(ranker, names, seed: int) -> dict:
    """One step's gradients under the dense RankNet loss at VS_CPU_B ragged
    lists (fp32): the card's kernel path and the card's dense path, each
    against the plain path (blockwise attention) on the CPU. Returns
    {name: rel_errs record}."""
    import dataclasses

    import torch

    from ptranking_tpu_torch.losses.pairwise import ranknet
    from ptranking_tpu_torch.models import apply_scorer
    from ptranking_tpu_torch.models.scorers import map_params, tree_leaves

    batch = train_batch(VS_CPU_B, TRAIN_N, ragged=True, seed=seed)

    def grads(device, cfg):
        params = map_params(lambda t: t.detach().to(device).requires_grad_(True), ranker.params)
        x, labels, mask = (torch.from_numpy(a).to(device)
                           for a in (batch.features, batch.labels, batch.mask))
        scores = apply_scorer(params, cfg, x, mask, training=True)
        return [g.cpu() for g in torch.autograd.grad(ranknet(scores, labels, mask),
                                                     tree_leaves(params))]

    cfg = ranker.scorer_cfg
    cpu = grads("cpu", cfg)  # flash_attn on the CPU: blockwise_attention, autograd
    return {"card_kernels_vs_cpu_plain": rel_errs(grads("cuda", cfg), cpu, names),
            "card_dense_vs_cpu_plain": rel_errs(
                grads("cuda", dataclasses.replace(cfg, flash_attn=False)), cpu, names)}


def rel_errs(got, want, names) -> dict:
    """Per parameter tensor ||got - want|| / max(||want||, GRAD_FLOOR * the
    largest ||want||): its worst tensor and value and the median; over all
    tensors together ||got - want|| / ||want||; and the two norms of
    ZERO_GRAD_PARAM's gradient, which is left out of both."""
    import torch

    for name, a in zip(names, got):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"gradient check: non-finite gradient of {name}")
    pairs = [(n, a, b) for n, a, b in zip(names, got, want) if n != ZERO_GRAD_PARAM]
    floor = GRAD_FLOOR * max(float(b.norm()) for _, _, b in pairs)
    rel = {n: float((a - b).norm()) / max(float(b.norm()), floor) for n, a, b in pairs}
    worst = max(rel, key=rel.get)
    diff2 = sum(float((a - b).norm()) ** 2 for _, a, b in pairs)
    ref2 = sum(float(b.norm()) ** 2 for _, _, b in pairs)
    zero = [[float(a.norm()), float(b.norm())] for n, a, b in zip(names, got, want)
            if n == ZERO_GRAD_PARAM]
    return {"worst": [worst, rel[worst]], "median": sorted(rel.values())[len(rel) // 2],
            "global": math.sqrt(diff2 / ref2), "zero_grad_param_norms": zero[0]}


def grads_vs_dense(ranker, x, labels, mask, what: str,
                   per_step: dict = LAUNCHES_PER_STEP) -> dict:
    """One step's gradients of `ranker` (dropout 0) through the kernels (flash
    attention, the fused LambdaRank loss) against dense attention and the
    dense loss, with exactly `per_step` kernel launches; in fp32 held
    to GRAD_TOL, and the fused loss on the kernel path's own scores to
    SAME_SCORES_TOL; in bf16 printed only. Returns the record."""
    import dataclasses

    import torch

    from ptranking_tpu_torch.losses.listwise import lambda_rank
    from ptranking_tpu_torch.models import apply_scorer
    from ptranking_tpu_torch.models.scorers import tree_leaves
    from ptranking_tpu_torch.ops import mask_scores

    leaves, names = tree_leaves(ranker.params), leaf_names(ranker.params)
    kernel_cfg = ranker.scorer_cfg
    dense_cfg = dataclasses.replace(kernel_cfg, flash_attn=False)
    dtype = kernel_cfg.compute_dtype

    def grads(cfg, loss_fn):
        scores = apply_scorer(ranker.params, cfg, x, mask, training=True)
        loss = loss_fn(scores, labels, mask)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    fused = lambda s, l, m: lambda_rank(s, l, m, use_pallas=True)
    dense = lambda s, l, m: lambda_rank(s, l, m, use_pallas=False)
    reset_counts()
    loss_k, grads_k = grads(kernel_cfg, fused)
    if read_counts() != per_step:
        raise AssertionError(f"{what}: kernel launches {read_counts()}, expected {per_step}")
    loss_d, grads_d = grads(dense_cfg, dense)
    with torch.no_grad():
        orders = [torch.argsort(-mask_scores(apply_scorer(ranker.params, cfg, x, mask), mask),
                                dim=-1, stable=True) for cfg in (kernel_cfg, dense_cfg)]
    errs = rel_errs(grads_k, grads_d, names)
    rec = {"loss_kernels": loss_k, "loss_dense": loss_d,
           "sorted_positions_differing": int((orders[0] != orders[1]).sum()), **errs}
    if not math.isfinite(loss_k) or (dtype == "float32" and not errs["worst"][1] <= GRAD_TOL):
        raise AssertionError(f"{what} {dtype}: {errs['worst']} relative error "
                             f"(tol {GRAD_TOL}); loss {loss_k} vs {loss_d}")
    if dtype == "float32":
        _, grads_kd = grads(kernel_cfg, dense)
        same = rel_errs(grads_k, grads_kd, names)
        rec["fused_vs_dense_loss_same_scores"] = same
        if not same["worst"][1] <= SAME_SCORES_TOL:
            raise AssertionError(f"{what}, fused loss on the same scores: "
                                 f"{same['worst']} relative error (tol {SAME_SCORES_TOL})")
    return rec


def timed_steps(ranker, batch, steps: int, what: str,
                per_step: dict = LAUNCHES_PER_STEP) -> dict:
    """`steps` steps of `ranker` on `batch` through train_epoch after a
    warm-up, on the host's clock, with exactly `per_step` kernel launches a
    step; then three profiled steps. Returns the record (without printing)."""
    import torch

    ranker.train_epoch([batch] * 2, epoch_k=1)  # warm up: cuBLAS handles, kernel loads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    mean_loss, stop = ranker.train_epoch([batch] * steps, epoch_k=1)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    check_counts(counts, steps, what, per_step)
    if stop or not math.isfinite(mean_loss):
        raise AssertionError(f"{what}: loss {mean_loss}, stop {stop}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    busy_ms, _, prof_ms, every = profile_ms(
        lambda: ranker.train_epoch([batch] * 3, epoch_k=1), every=True)

    def item(name):  # ms of the kernels whose name holds `name`, over the 3 steps
        return sum(ms for key, ms, _ in every if name in key)

    B, N = batch.mask.shape
    return {"B": B, "N": N, "steps": steps, "wall_s": wall_s, "ms_per_step": wall_s * 1e3 / steps,
            "lists_per_s": B * steps / wall_s, "mean_loss": mean_loss, "launches": counts,
            "peak_mem_gb": peak_gb, "profiled_steps": 3, "profiled_wall_ms": prof_ms,
            "profiled_device_busy_ms": busy_ms, "profiled_flash_ms": item("flash_"),
            "profiled_flash_fwd_ms": item("flash_fwd"), "profiled_pair_ms": item("pair_"),
            "profiled_sinkstep_ms": item("sinkstep_"),
            "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / prof_ms,
            "top_kernels_ms_calls": every[:14]}


def resume_check(ranker, batches, path: str, what: str) -> dict:
    """Save `ranker`, restore it into a second ranker, one more step on both:
    the same parameters within RESUME_TOL and the same loss. Returns the record."""
    from ptranking_tpu_torch.models.scorers import tree_leaves
    from ptranking_tpu_torch.train import AdhocRanker

    ranker.save(path)
    again = AdhocRanker.from_checkpoint(path, device="cuda")
    loss_a, _ = ranker.train_epoch(batches[:1], epoch_k=2)
    loss_b, _ = again.train_epoch(batches[:1], epoch_k=2)
    diff = max(float((a.detach() - b.detach()).abs().max()) for a, b in
               zip(tree_leaves(ranker.params), tree_leaves(again.params)))
    if not diff <= RESUME_TOL or loss_a != loss_b:
        raise AssertionError(f"{what}: params differ by {diff} (tol {RESUME_TOL}), "
                             f"losses {loss_a} vs {loss_b}")
    return {"max_abs_param_diff": diff, "loss": loss_a}


def train_phase(card: str, work_dir: str):
    """Phase 5: the flagship ranker's training on the card. Returns the
    launch counts of the train_epoch run (c) and of the fp32 timed steps."""
    import torch

    from ptranking_tpu_torch.data.dataset import BucketedDataset, make_synthetic_queries

    # (a) one step's gradients through the kernels against dense attention
    # and the dense loss, dropout 0, on 31 ragged lists and an all-padded row
    batch = train_batch(TRAIN_B, TRAIN_N, ragged=True, seed=1)
    x, labels, mask = (torch.from_numpy(a).cuda() for a in (batch.features, batch.labels, batch.mask))
    grad_rec = {}
    for dtype in ("float32", "bfloat16"):
        ranker = flagship_ranker(dropout=0.0, compute_dtype=dtype)
        grad_rec[dtype] = rec = grads_vs_dense(ranker, x, labels, mask, "gradient check")
        if dtype == "float32":
            names = leaf_names(ranker.params)
            for seed in VS_CPU_SEEDS:
                rec[f"vs_cpu_batch{seed}"] = cmp = vs_cpu(ranker, names, seed)
                if not cmp["card_kernels_vs_cpu_plain"]["worst"][1] <= GRAD_TOL:
                    raise AssertionError(f"gradient check, kernels against the CPU, batch {seed}: "
                                         f"{cmp['card_kernels_vs_cpu_plain']['worst']} relative "
                                         f"error (tol {GRAD_TOL})")
    print("train_grad " + json.dumps(grad_rec) + f"  [{card}]", flush=True)

    # (b) timed steps at 32 lists of 1408 docs through train_epoch, dropout 0.1
    steps_rec = timed_steps(flagship_ranker(), train_batch(TRAIN_B, TRAIN_N, ragged=False, seed=2),
                            TRAIN_STEPS, "timed steps")
    print("train_steps " + json.dumps(steps_rec) + f"  [{card}]", flush=True)
    # the same at compute_dtype float32, the JAX package's default: the fp32
    # forward, and the fp32 backward on 3xTF32 (tools/yahoo_steps.py
    # --flagship times a parent checkout's beside it)
    f32_rec = timed_steps(flagship_ranker(compute_dtype="float32"),
                          train_batch(TRAIN_B, TRAIN_N, ragged=False, seed=2), TRAIN_STEPS,
                          "fp32 timed steps")
    print("train_fp32_steps " + json.dumps(f32_rec) + f"  [{card}]", flush=True)

    # (c) one train_epoch over ragged lists at the server's 100 docs per
    # batch, the same batches EPOCH_PASSES times over
    ranker = flagship_ranker()
    queries = make_synthetic_queries(EPOCH_QUERIES, num_features=NUM_FEATURES, max_label=4,
                                     min_docs=20, max_docs=TRAIN_N, seed=3)
    batches = list(BucketedDataset(queries, batch_docs=100, num_features=NUM_FEATURES).batches())
    step_losses = []
    step = ranker._step
    ranker._step = lambda *a: step_losses.append(step(*a)) or step_losses[-1]
    reset_counts()
    t0 = time.perf_counter()
    mean_loss, stop = ranker.train_epoch(batches * EPOCH_PASSES, epoch_k=1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch_counts = read_counts()
    del ranker._step
    check_counts(epoch_counts, len(batches) * EPOCH_PASSES, "train_epoch")
    pass_busy_ms, _, pass_ms = profile_ms(lambda: ranker.train_epoch(batches, epoch_k=1))
    per_step = torch.stack(step_losses).cpu().tolist()
    first = sum(per_step[:len(batches)]) / len(batches)
    last = sum(per_step[-len(batches):]) / len(batches)
    if stop or not math.isfinite(mean_loss) or not last < first:
        raise AssertionError(f"train_epoch: mean loss {mean_loss}, stop {stop}, first pass "
                             f"{first}, last pass {last}")
    epoch_rec = {"queries": EPOCH_QUERIES, "batches": len(batches), "passes": EPOCH_PASSES,
                 "steps": len(per_step), "epoch_s": epoch_s, "mean_loss_per_query": mean_loss,
                 "first_pass_mean_step_loss": first, "last_pass_mean_step_loss": last,
                 "launches": epoch_counts, "profiled_pass_wall_ms": pass_ms,
                 "profiled_pass_device_busy_ms": pass_busy_ms,
                 "pass_device_idle_share": None if pass_busy_ms is None else
                 1.0 - pass_busy_ms / pass_ms}
    print("train_epoch " + json.dumps(epoch_rec) + f"  [{card}]", flush=True)

    # (d) resume: save, restore into a second ranker, one more step on both
    rec = resume_check(ranker, batches, os.path.join(work_dir, "trained.pt"), "resume")
    print("train_resume " + json.dumps(rec) + f"  [{card}]", flush=True)
    return epoch_counts, f32_rec["launches"]


def wassrank_phase(card: str, work_dir: str) -> dict:
    """Phase 6: the flagship ranker trained with WassRank and evaluated on the
    card. Returns the launch counts of the train_epoch run (c)."""
    import numpy as np
    import torch

    from ptranking_tpu_torch.data.dataset import BucketedDataset, make_synthetic_queries
    from ptranking_tpu_torch.losses.wassrank import wass_rank
    from ptranking_tpu_torch.models import apply_scorer
    from ptranking_tpu_torch.models.scorers import tree_leaves

    # (a) one step's fp32 gradients with every half-step through the kernel
    # against the same step on the plain half-step (use_pallas=False), dropout
    # 0, on 31 ragged lists and an all-padded row; then both losses on the
    # same scores
    batch = train_batch(TRAIN_B, TRAIN_N, ragged=True, seed=1)
    x, labels, mask = (torch.from_numpy(a).cuda() for a in (batch.features, batch.labels, batch.mask))
    ranker = flagship_ranker(dropout=0.0, compute_dtype="float32", model_id="WassRank")
    leaves, names = tree_leaves(ranker.params), leaf_names(ranker.params)
    paras = ranker.model_paras

    def grads(use_pallas):
        scores = apply_scorer(ranker.params, ranker.scorer_cfg, x, mask, training=True)
        loss = wass_rank(scores, labels, mask, **paras, use_pallas=use_pallas)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    reset_counts()
    loss_k, grads_k = grads(None)
    if read_counts() != WASS_LAUNCHES_PER_STEP:
        raise AssertionError(f"wassrank gradient check: kernel launches {read_counts()}, "
                             f"expected {WASS_LAUNCHES_PER_STEP}")
    loss_p, grads_p = grads(False)
    errs = rel_errs(grads_k, grads_p, names)
    with torch.no_grad():
        scores = apply_scorer(ranker.params, ranker.scorer_cfg, x, mask)
    same = {}
    for name, use_pallas in (("kernel", None), ("plain", False)):
        s = scores.clone().requires_grad_(True)
        loss = wass_rank(s, labels, mask, **paras, use_pallas=use_pallas)
        same[name] = (float(loss.detach()), torch.autograd.grad(loss, s)[0])
    same_rec = {"loss_kernel": same["kernel"][0], "loss_plain": same["plain"][0],
                "loss_rel_err": abs(same["kernel"][0] - same["plain"][0]) / abs(same["plain"][0]),
                "score_grad_rel_err": rel_err(same["kernel"][1], same["plain"][1])}
    print("wassrank_grad " + json.dumps({"loss_kernel": loss_k, "loss_plain": loss_p, **errs,
                                         "same_scores": same_rec}) + f"  [{card}]", flush=True)
    if not math.isfinite(loss_k) or not errs["worst"][1] <= GRAD_TOL:
        raise AssertionError(f"wassrank gradient check: {errs['worst']} relative error "
                             f"(tol {GRAD_TOL}); loss {loss_k} vs {loss_p}")
    if not max(same_rec["loss_rel_err"], same_rec["score_grad_rel_err"]) <= SAME_SCORES_TOL:
        raise AssertionError(f"wassrank on the same scores, kernel against plain: {same_rec} "
                             f"(tol {SAME_SCORES_TOL})")

    # (b) timed steps at 32 lists of 1408 docs through train_epoch, bf16,
    # dropout 0.1
    ranker = flagship_ranker(model_id="WassRank")
    batch = train_batch(TRAIN_B, TRAIN_N, ragged=False, seed=2)
    steps_rec = timed_steps(ranker, batch, WASS_STEPS, "wassrank timed steps",
                            WASS_LAUNCHES_PER_STEP)
    # the loss alone, forward and backward, on this batch's scores: through the
    # kernel, and on the plain half-step
    x, labels, mask = (torch.from_numpy(a).cuda() for a in (batch.features, batch.labels, batch.mask))
    with torch.no_grad():
        scores = apply_scorer(ranker.params, ranker.scorer_cfg, x, mask)

    def loss_fwd_bwd(use_pallas):
        s = scores.clone().requires_grad_(True)
        wass_rank(s, labels, mask, **ranker.model_paras, use_pallas=use_pallas).backward()

    steps_rec["loss_fwd_bwd_ms"] = {"kernel": cuda_time_ms(lambda: loss_fwd_bwd(None), 5),
                                    "plain": cuda_time_ms(lambda: loss_fwd_bwd(False), 5)}
    print("wassrank_steps " + json.dumps(steps_rec) + f"  [{card}]", flush=True)

    # (c) evaluate on ragged lists at the server's 100 docs per batch, one
    # train_epoch of EPOCH_PASSES passes over them, evaluate again
    ranker = flagship_ranker(model_id="WassRank")
    queries = make_synthetic_queries(EPOCH_QUERIES, num_features=NUM_FEATURES, max_label=4,
                                     min_docs=20, max_docs=TRAIN_N, seed=3)
    ds = BucketedDataset(queries, batch_docs=100, num_features=NUM_FEATURES)
    batches = list(ds.batches())

    def evaluate(what):
        t0 = time.perf_counter()
        means = ranker.evaluate(ds, ks=EVAL_KS)
        eval_s = time.perf_counter() - t0
        per_query = ranker.evaluate_per_query(batches, ks=EVAL_KS)
        for m, v in means.items():
            if v.shape != (len(EVAL_KS),) or not np.all(np.isfinite(v)) or v.min() < 0 or v.max() > 1:
                raise AssertionError(f"evaluate {what}: {m} = {v.tolist()}")
            if per_query[m].shape != (EPOCH_QUERIES, len(EVAL_KS)):
                raise AssertionError(f"evaluate {what}: {per_query[m].shape[0]} real queries "
                                     f"counted, expected {EPOCH_QUERIES}")
            if not np.allclose(per_query[m].mean(0), v, atol=1e-5):
                raise AssertionError(f"evaluate {what}: {m} means {v.tolist()} are not the "
                                     f"per-query means {per_query[m].mean(0).tolist()}")
        return {"eval_s": eval_s, **{m: v.tolist() for m, v in means.items()}}

    before = evaluate("before")
    reset_counts()
    t0 = time.perf_counter()
    mean_loss, stop = ranker.train_epoch(batches * EPOCH_PASSES, epoch_k=1)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch_counts = read_counts()
    steps = len(batches) * EPOCH_PASSES
    check_counts(epoch_counts, steps, "wassrank train_epoch", WASS_LAUNCHES_PER_STEP)
    if stop or not math.isfinite(mean_loss):
        raise AssertionError(f"wassrank train_epoch: mean loss {mean_loss}, stop {stop}")
    reset_counts()
    after = evaluate("after")
    eval_counts = read_counts()
    if eval_counts["flash_attn_fwd"] != 2 * 6 * len(batches) or eval_counts["sinkstep"] != 0:
        raise AssertionError(f"evaluate: kernel launches {eval_counts} for {len(batches)} batches "
                             f"scored twice")
    k10 = EVAL_KS.index(10)
    epoch_rec = {"queries": EPOCH_QUERIES, "batches": len(batches), "passes": EPOCH_PASSES,
                 "steps": steps, "epoch_s": epoch_s, "mean_loss_per_query": mean_loss,
                 "launches": epoch_counts, "ks": list(EVAL_KS), "nDCG@10_before": before["nDCG"][k10],
                 "nDCG@10_after": after["nDCG"][k10], "before": before, "after": after}
    print("wassrank_epoch " + json.dumps(epoch_rec) + f"  [{card}]", flush=True)

    # (d) resume: save, restore into a second ranker, one more step on both
    rec = resume_check(ranker, batches, os.path.join(work_dir, "wassrank.pt"), "wassrank resume")
    print("wassrank_resume " + json.dumps(rec) + f"  [{card}]", flush=True)
    return epoch_counts


def wide_launches(N: int, d: int, dtype: str = "bfloat16") -> dict:
    """Launches a step of the listsf (6 layers) at head dim d > 128 with
    lists of N docs in `dtype`, by the routes: the forward's (in bf16 the
    packed forward up to FWD_PACK_MAX_N docs, the long forward up to
    LONG_MAX_N, in fp32 the packed forward's wrapper up to
    F32_FWD_LIST_MAX_N and the long forward's up to F32_FWD_LONG_MAX_N, else
    the wide kernel) and the backward's (the packed backward up to PACK_MAX_N
    docs, the list backward up to LIST_MAX_N, the long backward up to
    LONG_MAX_N, in fp32 up to F32_PACK_MAX_N, F32_LIST_MAX_N and
    F32_LONG_MAX_N, else the wide pair)."""
    import torch

    from ptranking_tpu_torch.ops.attention import bwd_route, fwd_route

    dt = getattr(torch, dtype)
    fwd, bwd = fwd_route(dt, N, d), bwd_route(dt, N, d)
    return {**LAUNCHES_PER_STEP, "flash_attn_fwd": 6 * (fwd == "flash"),
            "flash_attn_fwd_packed": 6 * (fwd == "packed"),
            "flash_attn_fwd_long": 6 * (fwd == "long"),
            "flash_attn_bwd_dkdv": 6 * (bwd == "pair"), "flash_attn_bwd_dq": 6 * (bwd == "pair"),
            "flash_attn_bwd_packed": 6 * (bwd == "packed"),
            "flash_attn_bwd_list": 6 * (bwd == "list"),
            "flash_attn_bwd_long": 6 * (bwd == "long")}


def wide_phase(card: str, work_dir: str) -> dict:
    """Phase 7: the DASALC listsf at head dims above 128 (WIDE_MODELS: 6
    layers, bf16, flash attention through the wide kernels), trained with
    LambdaRank through the fused pairwise kernel and Adagrad: (a) served over
    HTTP (16 ragged lists of 5..139 docs) and score_file; (b) one step's
    gradients through the kernels against dense attention and the dense loss,
    in the YAHOO_GRAD_CHECK bucket, fp32 held, bf16 printed (Yahoo!'s also at
    YAHOO_PACKED_CHECK docs, through the packed kernels, fp32's through the
    3xTF32 ones); (c) timed steps of YAHOO_DOCS docs in each of Yahoo!'s
    YAHOO_BUCKETS (the one-head model: the 128-doc bucket), with exact launch
    counts (wide_launches: in bf16 no Yahoo! bucket reaches a wide kernel);
    (d) save, restore, one more step on both; (e) for the first model, timed
    fp32 steps in YAHOO_F32_BUCKETS (yahoo_f32_steps). The one-head model
    also takes its fp32 gradient check (b) at WIDE_PAIR_CHECK docs and (f)
    timed fp32 steps at WIDE_F32_STEP with exact launch counts (the fp32
    wide forward and dk/dv and dq kernels, 3xTF32). Returns the launch counts
    of (c) for the first model, summed over its buckets, those of (e), by
    bucket, and those of (f)."""
    import torch

    from ptranking_tpu_torch.models import ScorerConfig

    counts, f32_step_counts, one_head_f32, first = {}, {}, {}, True
    for name, F, n_heads, lane_align, data_id in WIDE_MODELS:
        cfg = ScorerConfig.default_listsf(F, compute_dtype="bfloat16", flash_attn=True,
                                          lane_align=lane_align, n_heads=n_heads)
        d = cfg.width // cfg.n_heads
        tag = f"{name}_d{d}"
        serve_phase(card, work_dir, cfg, YAHOO_SERVE_LENGTHS, data_id,
                    (min(YAHOO_SERVE_LENGTHS), max(YAHOO_SERVE_LENGTHS)), tag)
        ranker_kw = {"num_features": F, "lane_align": lane_align, "n_heads": n_heads}

        N = YAHOO_GRAD_CHECK
        batch = train_batch(YAHOO_DOCS // N, N, ragged=True, seed=1, num_features=F)
        x, labels, mask = (torch.from_numpy(a).cuda()
                           for a in (batch.features, batch.labels, batch.mask))
        grad_rec = {dtype: grads_vs_dense(flagship_ranker(dropout=0.0, compute_dtype=dtype,
                                                          **ranker_kw),
                                          x, labels, mask, f"{tag} gradient check",
                                          wide_launches(N, d, dtype))
                    for dtype in ("float32", "bfloat16")}
        print(f"{tag}_grad " + json.dumps(grad_rec) + f"  [{card}]", flush=True)

        if name == "mslr_1head":  # fp32 past F32_LONG_MAX_N docs: the fp32 wide kernels
            N = WIDE_PAIR_CHECK
            batch = train_batch(YAHOO_DOCS // N, N, ragged=True, seed=1, num_features=F)
            x, labels, mask = (torch.from_numpy(a).cuda()
                               for a in (batch.features, batch.labels, batch.mask))
            rec = grads_vs_dense(flagship_ranker(dropout=0.0, compute_dtype="float32",
                                                 **ranker_kw),
                                 x, labels, mask, f"{tag} fp32 gradient check at {N} docs",
                                 wide_launches(N, d, "float32"))
            print(f"{tag}_grad_{N}docs " + json.dumps({"float32": rec}) + f"  [{card}]",
                  flush=True)
            B, N = WIDE_F32_STEP
            rec = timed_steps(flagship_ranker(compute_dtype="float32", **ranker_kw),
                              train_batch(B, N, ragged=False, seed=2, num_features=F),
                              YAHOO_STEPS, f"{tag} fp32 timed steps at {B} x {N} docs",
                              wide_launches(N, d, "float32"))
            print(f"{tag}_fp32_steps " + json.dumps({"head_dim": d, "dtype": "float32", **rec})
                  + f"  [{card}]", flush=True)
            one_head_f32 = rec["launches"]

        if name == "yahoo":  # the same in a bucket of the packed kernels: the mean list's
            N = YAHOO_PACKED_CHECK
            batch = train_batch(YAHOO_DOCS // N, N, ragged=True, seed=1, num_features=F)
            x, labels, mask = (torch.from_numpy(a).cuda()
                               for a in (batch.features, batch.labels, batch.mask))
            rec = {dtype: grads_vs_dense(flagship_ranker(dropout=0.0, compute_dtype=dtype,
                                                         **ranker_kw),
                                         x, labels, mask, f"{tag} gradient check at {N} docs",
                                         wide_launches(N, d, dtype))
                   for dtype in ("float32", "bfloat16")}
            print(f"{tag}_grad_{N}docs " + json.dumps(rec) + f"  [{card}]", flush=True)

        ranker = flagship_ranker(**ranker_kw)
        # Yahoo!'s buckets, short lists first; the one-head MSLR-WEB30K model
        # (long lists) at the 128-doc bucket only
        for N in YAHOO_BUCKETS if name == "yahoo" else (YAHOO_GRAD_CHECK,):
            batch = train_batch(YAHOO_DOCS // N, N, ragged=False, seed=2, num_features=F)
            steps_rec = timed_steps(ranker, batch, YAHOO_STEPS, f"{tag} timed steps at {N} docs",
                                    wide_launches(N, d))
            print(f"{tag}_steps " + json.dumps({"head_dim": d, **steps_rec}) + f"  [{card}]",
                  flush=True)
            if first:
                counts = {k: counts.get(k, 0) + n for k, n in steps_rec["launches"].items()}
        rec = resume_check(ranker, [batch], os.path.join(work_dir, f"{tag}.trained.pt"),
                           f"{tag} resume")
        print(f"{tag}_resume " + json.dumps(rec) + f"  [{card}]", flush=True)
        if first:
            f32_step_counts = yahoo_f32_steps(card)
        first = False
    return counts, f32_step_counts, one_head_f32


def yahoo_f32_steps(card: str) -> dict:
    """Timed LambdaRank steps of the Yahoo! listsf at d = 350 in fp32 (WIDE_MODELS'
    first model, compute_dtype float32), YAHOO_DOCS docs a step in each of
    YAHOO_F32_BUCKETS, with exact launch counts (wide_launches in fp32: the
    fp32 packed kernels up to F32_PACK_MAX_N docs; the fp32 list forward up
    to F32_FWD_LIST_MAX_N and F32_FWD_LONG_MAX_N docs; the fp32 list
    backward up to F32_LIST_MAX_N docs, the long backward up to
    F32_LONG_MAX_N). Returns the launch counts by bucket: {N: counts}."""
    name, F, n_heads, lane_align, _ = WIDE_MODELS[0]
    ranker = flagship_ranker(compute_dtype="float32", num_features=F, lane_align=lane_align,
                             n_heads=n_heads)
    d = ranker.scorer_cfg.width // n_heads
    counts = {}
    for N in YAHOO_F32_BUCKETS:
        batch = train_batch(YAHOO_DOCS // N, N, ragged=False, seed=2, num_features=F)
        rec = timed_steps(ranker, batch, YAHOO_STEPS, f"{name}_d{d} fp32 timed steps at {N} docs",
                          wide_launches(N, d, "float32"))
        print(f"{name}_d{d}_fp32_steps " + json.dumps({"head_dim": d, "dtype": "float32", **rec})
              + f"  [{card}]", flush=True)
        counts[N] = rec["launches"]
    return counts


# phase 8, the resident data path at the flagship's width: RES_QUERIES
# synthetic lists of 20..1408 docs at F=136 (seed 3) in the default buckets,
# RES_BATCH_DOCS docs a batch (32 lists of 1408 docs: the flagship step);
# then the same timing at the CLI's default 100-doc batches on the first
# RES_ROUGH_QUERIES of those lists (one list a step in the buckets of 128
# docs and up, so about as many steps as lists; not profiled: the
# profiler's processing of some 250 steps took minutes)
RES_QUERIES, RES_SEED = 1024, 3
RES_BATCH_DOCS = TRAIN_B * TRAIN_N
RES_EPOCHS = (1, 2)
RES_ROUGH_DOCS, RES_ROUGH_QUERIES = 100, 128
# resident against streamed: the same kernels on the same batches, so the
# losses and params should keep their bits; held to this relative bound
RES_TOL = 1e-6
# the k-fold entry point: LETOR files of KF_QUERIES synthetic lists of
# 20..KF_MAX_DOCS docs at F=136 a split (the generic LETOR_K id, whose JSON
# declares its width and 2 folds), 2 epochs, KF_BATCH_DOCS docs a training
# batch, the flagship scorer under LambdaRank through the fused loss
KF_QUERIES, KF_MAX_DOCS, KF_BATCH_DOCS, KF_EPOCHS = 64, 160, 4096, 2
# the bf16 linear_apply gate: the layer shapes (rows, d_in, d_out) of the
# flagship (32 x 1408 docs at F=136: QKV, attention output, the FFNs) and of
# the Yahoo! listsf (32,768 docs at F=700)
LINEAR_SHAPES = [(45056, 136, 408), (45056, 136, 136), (45056, 136, 128), (45056, 128, 256),
                 (45056, 256, 512), (45056, 512, 136), (45056, 512, 1),
                 (32768, 700, 2100), (32768, 700, 700), (32768, 700, 128), (32768, 512, 700)]


class _Interrupted(Exception):
    pass


def params_diff(a, b) -> dict:
    """Whether two rankers' params have the same bits, and the worst
    max |a - b| / max |b| over the tensors."""
    import torch

    from ptranking_tpu_torch.models.scorers import tree_leaves

    pairs = list(zip(tree_leaves(a.params), tree_leaves(b.params)))
    worst = max(float((x.detach() - y.detach()).abs().max())
                / max(float(y.detach().abs().max()), 1e-30) for x, y in pairs)
    return {"same_bits": all(torch.equal(x, y) for x, y in pairs), "worst_rel": worst}


def resident_vs_streamed(card: str, work_dir: str) -> dict:
    """Phase 8 (a): the flagship ranker (bf16, dropout 0) trained two epochs
    on the device-resident data (bf16 features) and, from the same seed, two
    epochs streamed from the host: the same losses and params (the same bits,
    or within RES_TOL relative), exact launch counts; then a third epoch each
    way on the host's clock and a fourth under the profiler (idle share,
    host->device copies and bytes); the same timing on the host's clock at
    RES_ROUGH_DOCS docs a batch, with the index copies counted on the host.
    Returns the launch counts of the resident epochs."""
    import torch

    from ptranking_tpu_torch.data.dataset import BucketedDataset, make_synthetic_queries
    from ptranking_tpu_torch.data.device_cache import DeviceResidentDataset, packed_nbytes

    queries = make_synthetic_queries(RES_QUERIES, num_features=NUM_FEATURES, max_label=4,
                                     min_docs=20, max_docs=TRAIN_N, seed=RES_SEED)
    index_copies = []
    to_device = DeviceResidentDataset.index_to_device

    def counted(self, idx):
        index_copies.append(idx.nbytes)
        return to_device(self, idx)

    DeviceResidentDataset.index_to_device = counted
    out = {}
    t_phase = time.perf_counter()
    try:
        for batch_docs, qs in ((RES_BATCH_DOCS, queries),
                               (RES_ROUGH_DOCS, queries[:RES_ROUGH_QUERIES])):
            ds = BucketedDataset(qs, batch_docs=batch_docs, num_features=NUM_FEATURES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = DeviceResidentDataset(ds, dtype="bfloat16", device="cuda")
            torch.cuda.synchronize()
            rec = {"batch_docs": batch_docs, "queries": len(qs),
                   "docs": int(sum(len(q[2]) for q in qs)), "buckets": list(ds.buckets),
                   "batches_an_epoch": len(ds), "upload_s": time.perf_counter() - t0,
                   "packed_nbytes_bf16": packed_nbytes(ds, "bfloat16"),
                   "packed_nbytes_fp32": packed_nbytes(ds)}
            resident, streamed = flagship_ranker(dropout=0.0), flagship_ranker(dropout=0.0)
            epochs = RES_EPOCHS if batch_docs == RES_BATCH_DOCS else ()
            if epochs:
                reset_counts()
                losses = [resident.train_epoch_resident(res, e) for e in epochs]
                torch.cuda.synchronize()
                out = read_counts()
                check_counts(out, len(ds) * len(epochs), "resident epochs")
                reset_counts()
                want = [streamed.train_epoch(ds.batches(shuffle=True, epoch=e), e) for e in epochs]
                check_counts(read_counts(), len(ds) * len(epochs), "streamed epochs")
                diff = params_diff(resident, streamed)
                rel = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(losses, want))
                rec.update(losses_resident=losses, losses_streamed=want, loss_worst_rel=rel,
                           params=diff, launches=out)
                if (any(stop for _, stop in losses + want) or not rel <= RES_TOL
                        or not diff["worst_rel"] <= RES_TOL):
                    raise AssertionError(f"resident against streamed: {rec}")
            nxt = max(epochs, default=0) + 1
            for name, fn in (("resident", lambda e: resident.train_epoch_resident(res, e)),
                             ("streamed", lambda e: streamed.train_epoch(
                                 ds.batches(shuffle=True, epoch=e), e))):
                torch.cuda.synchronize()
                del index_copies[:]
                t0 = time.perf_counter()
                loss, stop = fn(nxt)
                torch.cuda.synchronize()
                epoch_s = time.perf_counter() - t0
                if stop or not math.isfinite(loss):
                    raise AssertionError(f"{name} epoch {nxt}: loss {loss}, stop {stop}")
                rec[name] = {"epoch_s": epoch_s, "lists_per_s": len(qs) / epoch_s,
                             "index_copies": len(index_copies),
                             "index_bytes": sum(index_copies)}
                if batch_docs == RES_BATCH_DOCS:
                    trace = os.path.join(work_dir, f"{name}_epoch.json")
                    rec[name]["profiled_epoch"] = (
                        profile_index_copies("resident epoch", lambda: fn(nxt + 1),
                                             index_copies, trace)
                        if name == "resident" else profile_device(lambda: fn(nxt + 1), trace))
            rec["phase_s"] = time.perf_counter() - t_phase
            print("resident_epochs " + json.dumps(rec) + f"  [{card}]", flush=True)
            del res
            torch.cuda.empty_cache()
    finally:
        DeviceResidentDataset.index_to_device = to_device
    return out


def write_kfold_config(root: str, dir_output: str, dir_data: str) -> str:
    """Data_Eval_ScoringFunction.json and LambdaRankParameter.json for the
    k-fold run: LETOR_K files at F=136 and 2 folds, 2 epochs with validation
    and resume, the flagship scorer (bf16, flash attention) under Adagrad at
    lr 1e-3, LambdaRank through the fused loss. Returns the directory."""
    os.makedirs(root, exist_ok=True)
    cfg = {
        "DataSetting": {"data_id": "LETOR_K", "dir_data": dir_data, "num_features": NUM_FEATURES,
                        "fold_num": 2, "has_comment": True, "max_rele_level": 4,
                        "min_docs": [10], "min_rele": [1], "binary_rele": [False],
                        "unknown_as_zero": [False], "tr_batch_size": [KF_BATCH_DOCS]},
        "EvalSetting": {"dir_output": dir_output, "epochs": KF_EPOCHS, "do_validation": True,
                        "vali_k": 5, "cutoffs": list(EVAL_KS), "loss_guided": False,
                        "do_log": True, "log_step": 1, "do_summary": False, "resume": True,
                        "mask": {"mask_label": False, "mask_type": ["rand_mask_all"],
                                 "mask_ratio": [0.2]}},
        "SFParameter": {"sf_id": "listsf", "opt": ["Adagrad"], "lr": [1e-3],
                        "listsf": {"BN": [False], "bn_type": ["BN2"], "bn_affine": [False],
                                   "apply_tl_af": [False], "AF": ["R"], "TL_AF": ["GE"],
                                   "ff_dims": [128, 256, 512], "encoder_type": ["DASALC"],
                                   "encoder_layers": [6], "n_heads": [2],
                                   "compute_dtype": ["bfloat16"], "flash_attn": [True]}},
    }
    with open(os.path.join(root, "Data_Eval_ScoringFunction.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "LambdaRankParameter.json"), "w") as f:
        json.dump({"LambdaRank": {"sigma": [1.0], "use_pallas": [True]}}, f)
    return root


def kfold_phase(card: str, work_dir: str) -> dict:
    """Phase 8 (b): `python -m ptranking_tpu_torch.ltr -model LambdaRank
    -dir_json DIR` (its main) on the card: 2 folds x 2 epochs, the training
    data resident, validation on. The CV metrics are finite, the run's log
    file holds them, and the kernel launches are what the batches predict
    (6 forward launches a trained or evaluated batch, 6 dk/dv and 6 dq, 1 + 2
    pairwise a trained one). Then a run stopped after fold 1's first epoch
    and started again (resume) gives the same CV metrics, bit for bit.
    Returns the launch counts of the first run."""
    import shutil

    import numpy as np

    from ptranking_tpu_torch import ltr
    from ptranking_tpu_torch.data.dataset import make_synthetic_queries
    from ptranking_tpu_torch.data.letor import write_letor_file
    from ptranking_tpu_torch.train.ranker import AdhocRanker

    root = os.path.join(work_dir, "kfold")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data")
    for fold in (1, 2):
        for i, split in enumerate(("train", "vali", "test")):
            qs = make_synthetic_queries(KF_QUERIES, num_features=NUM_FEATURES, max_label=4,
                                        min_docs=20, max_docs=KF_MAX_DOCS, seed=10 * fold + i)
            write_letor_file(qs, os.path.join(data, f"Fold{fold}", f"{split}.txt"))
    batches = {"train": 0, "eval": 0}
    step, eval_sums = AdhocRanker._step, AdhocRanker._eval_sums

    def counted_step(self, *a):
        batches["train"] += 1
        return step(self, *a)

    def counted_eval(self, *a):
        batches["eval"] += 1
        return eval_sums(self, *a)

    def run(name):
        cfg = write_kfold_config(os.path.join(root, name + "_json"),
                                 os.path.join(root, name), data)
        t0 = time.perf_counter()
        perf = ltr.main(["-model", "LambdaRank", "-dir_json", cfg])
        return perf, time.perf_counter() - t0

    AdhocRanker._step, AdhocRanker._eval_sums = counted_step, counted_eval
    try:
        reset_counts()
        full, full_s = run("full")
        counts = read_counts()
    finally:
        AdhocRanker._step, AdhocRanker._eval_sums = step, eval_sums
    n_train, n_eval = batches["train"], batches["eval"]
    want = {**{k: 0 for k in counts}, "flash_attn_fwd": 6 * (n_train + n_eval),
            "flash_attn_bwd_dkdv": 6 * n_train, "flash_attn_bwd_dq": 6 * n_train,
            "pairwise_lambda_fwd": n_train, "pairwise_lambda_bwd": 2 * n_train}
    if counts != want or not n_train:
        raise AssertionError(f"k-fold run: launches {counts}, expected {want}")
    metrics = {m: np.asarray(full[m]).tolist() for m in ("nDCG", "nERR", "AP", "P")}
    if not all(math.isfinite(v) for vs in metrics.values() for v in vs):
        raise AssertionError(f"k-fold run: CV metrics {metrics}")
    logs = [os.path.join(r, f) for r, _, fs in os.walk(os.path.join(root, "full"))
            for f in fs if f.startswith("log_")]
    ckpts = [f for _, _, fs in os.walk(os.path.join(root, "full")) for f in fs
             if f.startswith("net_params_epoch_")]
    with open(logs[0]) as f:
        logged = f.read() if len(logs) == 1 else ""
    if "2-fold CV" not in logged or len(ckpts) != 2:
        raise AssertionError(f"k-fold run: log files {logs}, checkpoints {ckpts}")

    real = AdhocRanker.train_epoch_resident
    calls = []

    def stop_after_one(self, res, epoch_k, shuffle=True):
        calls.append(epoch_k)
        if len(calls) == 2:
            raise _Interrupted
        return real(self, res, epoch_k, shuffle)

    AdhocRanker.train_epoch_resident = stop_after_one
    try:
        run("cut")
        raise AssertionError("k-fold run: the interruption did not happen")
    except _Interrupted:
        pass
    finally:
        AdhocRanker.train_epoch_resident = real
    resumed, resumed_s = run("cut")
    same = all(np.array_equal(np.asarray(full[m]), np.asarray(resumed[m]))
               for m in ("nDCG", "nERR", "AP", "P"))
    rec = {"folds": 2, "epochs": KF_EPOCHS, "queries_a_split": KF_QUERIES,
           "train_batches": n_train, "eval_batches": n_eval, "run_s": full_s,
           "resumed_run_s": resumed_s, "cv": metrics, "launches": counts,
           "resume_same_bits": same}
    print("kfold " + json.dumps(rec) + f"  [{card}]", flush=True)
    if not same:
        raise AssertionError(f"k-fold resume: {resumed} against {full}")
    return counts


def bf16_ulp_excess(got, want, terms, k: int) -> float:
    """max(|got - want| - tol) over the elements, tol = one bf16 ulp at the
    larger of the two plus twice the bound on an fp32 sum of k terms
    (k * 2^-24 * sum |terms|): both round one fp32 sum to bf16, summed in
    other orders. At most 0 passes."""
    import torch

    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag))) * 2.0 ** -7
    return float(((got - want).abs() - ulp - 2 * k * 2.0 ** -24 * terms).max())


def linear_gate(card: str) -> dict:
    """Phase 8 (c): the bf16 linear_apply on the card (bf16 x bf16 products
    with fp32 accumulation, `_Bf16Linear`) against its plain version (fp32
    products of upcast operands) at LINEAR_SHAPES: the output within one
    bf16 ulp (bf16_ulp_excess), dx and dw within BWD_TOL's bf16 gate
    (relative norm); the route's three products go through the dtype
    overload (counted), with no fallback; both timed, forward and backward.
    Beside them, timed and compared, not used: one bf16 `torch.addmm` with
    a bf16 result (the bias in cuBLAS's epilogue, its reduction under
    `allow_bf16_reduced_precision_reduction`)."""
    import torch

    from ptranking_tpu_torch.models.scorers import nn

    calls = []
    mm_f32 = nn._mm_f32

    def counted(a, b):
        calls.append(a.shape)
        return mm_f32(a, b)

    recs, worst = [], {"out_ulp_excess": -math.inf, "dx_rel": 0.0, "dw_rel": 0.0}
    g = torch.Generator(device="cpu").manual_seed(0)
    for rows, d_in, d_out in LINEAR_SHAPES:
        x = torch.randn(rows, d_in, generator=g).to("cuda", torch.bfloat16)
        w = (torch.randn(d_in, d_out, generator=g) / math.sqrt(d_in)).to("cuda", torch.bfloat16)
        b = torch.randn(d_out, generator=g).to("cuda", torch.bfloat16)
        dy = torch.randn(rows, d_out, generator=g).to("cuda", torch.bfloat16)

        def run(route, x=x, w=w, b=b, dy=dy):
            xs, ws, bs = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
            if route:
                y = nn.linear_apply({"w": ws, "b": bs}, xs)
            else:
                y = (torch.matmul(xs.float(), ws.float()) + bs.float()).to(torch.bfloat16)
            y.backward(dy)
            return y.detach(), xs.grad, ws.grad

        nn._mm_f32 = counted
        try:
            del calls[:]
            y, dx, dw = run(True)
            torch.cuda.synchronize()
        finally:
            nn._mm_f32 = mm_f32
        if len(calls) != 3:
            raise AssertionError(f"linear {rows}x{d_in}x{d_out}: {len(calls)} dtype-overload "
                                 "products, expected 3 (forward, dx, dw)")
        yp, dxp, dwp = run(False)
        ex = bf16_ulp_excess(y, yp, x.float().abs() @ w.float().abs(), d_in)
        rel = lambda a, r: float((a.float() - r.float()).norm() / r.float().norm())
        rec = {"shape": [rows, d_in, d_out], "out_ulp_excess": ex,
               "out_elements_differing": int((y != yp).sum()),
               "dx_rel": rel(dx, dxp), "dw_rel": rel(dw, dwp),
               "dx_ulp_excess": bf16_ulp_excess(dx, dxp, dy.float().abs() @ w.float().abs().t(),
                                                d_out),
               "ms_fwd": cuda_time_ms(lambda: nn.linear_apply({"w": w, "b": b}, x), 20),
               "plain_ms_fwd": cuda_time_ms(
                   lambda: (torch.matmul(x.float(), w.float()) + b.float()).to(torch.bfloat16),
                   20),
               "ms_fwd_bwd": cuda_time_ms(lambda: run(True), 10),
               "plain_ms_fwd_bwd": cuda_time_ms(lambda: run(False), 10),
               "bf16_result_addmm_ms": cuda_time_ms(lambda: torch.addmm(b, x, w), 20),
               "bf16_result_addmm_elements_differing": int((torch.addmm(b, x, w) != y).sum())}
        recs.append(rec)
        for key in worst:
            worst[key] = max(worst[key], rec[key])
    print("linear_bf16 " + json.dumps({"cases": recs, "worst": worst}) + f"  [{card}]",
          flush=True)
    if not (worst["out_ulp_excess"] <= 0.0 and worst["dx_rel"] <= BWD_TOL["bfloat16"]
            and worst["dw_rel"] <= BWD_TOL["bfloat16"]):
        raise AssertionError(f"bf16 linear_apply against its plain version: {worst} (output "
                             f"within one bf16 ulp, dx and dw {BWD_TOL['bfloat16']} relative)")
    return worst


def resident_phase(card: str, work_dir: str) -> dict:
    """Phase 8: (a) resident_vs_streamed, (b) kfold_phase, (c) linear_gate.
    Returns the launch counts of (a) and (b)."""
    t0 = time.perf_counter()
    resident = resident_vs_streamed(card, work_dir)
    t1 = time.perf_counter()
    kfold = kfold_phase(card, work_dir)
    t2 = time.perf_counter()
    linear_gate(card)
    print(f"resident_phase_s {{\"resident\": {t1 - t0:.1f}, \"kfold\": {t2 - t1:.1f}, "
          f"\"linear\": {time.perf_counter() - t2:.1f}}}", flush=True)
    return {"resident": resident, "kfold": kfold}


# --- phase 9: int8 serving, exported artifacts, the native GBDT, the native parser ---

# int8 serving and the artifacts serve the flagship's served request of phase
# 4 (SERVE_LENGTHS) and its LETOR file; the artifacts hold the buckets of
# both, the request cut to its lists of at most ARTIFACT_MAX_DOCS docs (11 of
# 16; the buckets 32..512, which hold the LETOR file's 20..400 docs too): the
# exports of the 1024- and 1536-doc buckets took the most of the script's
# time left to cut. The int8 scores on the card are held against the CPU plain int8 path
# on the same params at the served-score gate (SCORE_TOL): the int32 products
# are exact on both, the attention and bf16 roundings are not the same bits
# (flash kernel against blockwise on the CPU)
# the native GBDT at MSLR-WEB30K's width: F = 136, 64 bins, depth 8, on
# GBDT_DOCS docs in GBDT_QUERIES ragged lists (three fifths of MSLR-WEB30K's
# 3,771,125 docs in 31,531 queries: one fold's training split), list lengths
# drawn from a gamma of mean 120 clipped to 1..1251 (MSLR's longest list);
# the bins drawn on the card from a seed (the host binning is timed on
# GBDT_BIN_TIMED features of the same size)
GBDT_QUERIES, GBDT_MEAN_DOCS, GBDT_MAX_DOCS = 18_900, 120, 1251
GBDT_BINS, GBDT_DEPTH = 64, 8
GBDT_TREES = 1           # trees a fit; the fit runs twice (the host objective: ~25 s a tree)
GBDT_BIN_TIMED = 4       # features binned on the host to time the binning
GBDT_CPU_DOCS = 131_072  # docs of the dyadic tree held against the CPU plain path
# the native parser: an MSLR-format file of PARSE_ROWS rows at F = 136, native
# against Python; PARSE_COPIES copies of it (qids renamed) time the native rows/s
PARSE_ROWS, PARSE_COPIES = 20_000, 5
ARTIFACT_MAX_DOCS = 400


def _serve_payload(lengths, F):
    import numpy as np

    from ptranking_tpu_torch import LTR_SEED

    rng = np.random.RandomState(LTR_SEED)
    docs = [rng.randn(n, F).astype(np.float32) for n in lengths]
    return {"queries": [{"qid": f"q{i}", "docs": d.tolist()} for i, d in enumerate(docs)]}


def _served(service, body: bytes, repeats: int = SERVE_REPEATS):
    """The answer of one POST /score of `body` to `service` over HTTP on a
    local port, the forward wrappers' launches during it, and the seconds of
    `repeats` more."""
    import threading

    from ptranking_tpu_torch.ops.attention import (FLASH_ATTN_FWD, FLASH_ATTN_FWD_LONG,
                                                   FLASH_ATTN_FWD_PACKED)
    from ptranking_tpu_torch.serve import make_server

    forwards = (FLASH_ATTN_FWD, FLASH_ATTN_FWD_PACKED, FLASH_ATTN_FWD_LONG)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/score"
    try:
        for k in forwards:
            k.launches = 0
        answer = post_json(url, body)
        launches = sum(k.launches for k in forwards)
        secs = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            post_json(url, body)
            secs.append(time.perf_counter() - t0)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    return answer, launches, secs


def _score_err(got: dict, want: dict) -> float:
    if set(got) != set(want):
        raise AssertionError(f"served {len(got)} docs, expected {len(want)}")
    return max(abs(got[k] - want[k]) for k in got)


def _op_counts(fn) -> dict:
    """{op name: calls} of the host ops of one call of `fn` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()}


def _count_linears(params) -> int:
    """Linear layers ({"w_q", ...} dicts) of a quantized params tree."""
    if isinstance(params, dict):
        return int("w_q" in params) + sum(_count_linears(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(_count_linears(v) for v in params)
    return 0


def int_mm_accepts(device: str) -> dict:
    """Which (rows, inner, output) shapes this torch's `torch._int_mm` takes
    on the card, each exact against an fp64 product where it takes it (the
    shapes that int8_matmul pads to its conditions)."""
    import torch

    out = {}
    for M, K, N in ((16, 8, 8), (17, 8, 8), (17, 12, 8), (17, 8, 12), (17, 8, 1),
                    (100, 136, 408), (100, 700, 2100), (100, 512, 1)):
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=device)
        b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device=device)
        try:
            exact = torch.equal(torch._int_mm(a, b).double(), a.double() @ b.double())
            out[f"{M}x{K}x{N}"] = "exact" if exact else "inexact"
        except RuntimeError:
            out[f"{M}x{K}x{N}"] = "refused"
    return out


def int8_serving(card: str, work_dir: str, device: str = "cuda") -> dict:
    """Phase 9 (a): the flagship checkpoint of phase 4 served with `-quantize
    int8` over HTTP and through score_file: the card's scores against the CPU
    plain int8 path on the same params (SCORE_TOL), their distance from the
    unquantized served scores, 6 forward launches a batch, `aten::_int_mm`
    for every linear of a batch and no floating-point product in a profile
    of one batch, ms a served request and a batch, int8 beside bf16."""
    import numpy as np
    import torch

    from ptranking_tpu_torch.data.dataset import BucketedDataset
    from ptranking_tpu_torch.score import score_file
    from ptranking_tpu_torch.serve import ScoringService

    ckpt = os.path.join(work_dir, "flagship.pt")
    payload = _serve_payload(SERVE_LENGTHS, NUM_FEATURES)
    body = json.dumps(payload).encode()
    services = {q: ScoringService(ckpt, quantize=q, device=device) for q in ("none", "int8")}
    nbatches = len(BucketedDataset(
        [(str(i), np.asarray(q["docs"], np.float32), np.zeros(len(q["docs"]), np.float32))
         for i, q in enumerate(payload["queries"])], batch_docs=100, num_features=NUM_FEATURES))
    answers, launches, http_s = {}, {}, {}
    for q, svc in services.items():
        answers[q], launches[q], http_s[q] = _served(svc, body)
    if launches["int8"] != 6 * nbatches:
        raise AssertionError(f"int8 serving: {launches['int8']} forward launches for "
                             f"{nbatches} batches; expected 6 a batch")
    got = scores_by_docid(answers["int8"]["results"])
    cpu = ScoringService(ckpt, quantize="int8", device="cpu")
    want = scores_by_docid(cpu.score(payload)["results"])
    err_cpu = _score_err(got, want)
    if not err_cpu <= SCORE_TOL:
        raise AssertionError(f"int8 scores on the card differ from the CPU plain int8 path "
                             f"by {err_cpu} (tol {SCORE_TOL})")
    full = scores_by_docid(answers["none"]["results"])
    err_full = _score_err(got, full)
    keys = sorted(got)
    corr = float(np.corrcoef([got[k] for k in keys], [full[k] for k in keys])[0, 1])

    # one batch of the request's largest bucket, profiled: every linear an
    # int8 product, no floating-point product
    ds = BucketedDataset([(str(i), np.asarray(q["docs"], np.float32),
                           np.zeros(len(q["docs"]), np.float32))
                          for i, q in enumerate(payload["queries"])], batch_docs=100,
                         num_features=NUM_FEATURES)
    batch = list(ds.batches())[-1]
    ranker8 = services["int8"].ranker
    linears = _count_linears(ranker8.params)  # the flagship: head 4, encoder 6 x 2, tail 4
    ops = _op_counts(lambda: ranker8.predict(batch))
    float_products = {k: v for k, v in ops.items()
                      if k in ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")}
    if ops.get("aten::_int_mm", 0) != linears or float_products:
        raise AssertionError(f"int8 batch: aten::_int_mm {ops.get('aten::_int_mm', 0)} times "
                             f"(expected {linears}), floating-point products "
                             f"{float_products}")
    batch_ms = {}
    x = torch.from_numpy(batch.features).to(device)
    m = torch.from_numpy(batch.mask).to(device)
    from ptranking_tpu_torch.models import apply_scorer

    for q, svc in services.items():
        r = svc.ranker
        with torch.inference_mode():
            batch_ms[q] = cuda_time_ms(lambda: apply_scorer(r.params, r.scorer_cfg, x, m), 20)
    # score_file -quantize int8 on phase 4's LETOR file
    reset_counts()
    run_path = os.path.join(work_dir, "flagship_int8.run")
    rows = score_file(ckpt, os.path.join(work_dir, "flagship.txt"), run_path,
                      data_id="MSLRWEB30K", quantize="int8", device=device)
    file_launches = read_counts()["flash_attn_fwd"]
    with open(run_path) as f:
        if not all(math.isfinite(float(line.split()[4])) for line in f):
            raise AssertionError("score_file -quantize int8: non-finite scores")
    if file_launches <= 0:
        raise AssertionError("score_file -quantize int8 launched no forward kernel")
    med = {q: sorted(s)[len(s) // 2] for q, s in http_s.items()}
    rec = {"batches": nbatches, "launches": launches["int8"],
           "max_abs_err_vs_cpu_int8": err_cpu, "max_abs_diff_vs_bf16": err_full,
           "corr_vs_bf16": corr, "int_mm_per_batch": ops.get("aten::_int_mm", 0),
           "http_s_int8": http_s["int8"], "http_s_bf16": http_s["none"],
           "ms_per_served_batch_int8": med["int8"] * 1e3 / nbatches,
           "ms_per_served_batch_bf16": med["none"] * 1e3 / nbatches,
           "scorer_ms_batch_int8": batch_ms["int8"], "scorer_ms_batch_bf16": batch_ms["none"],
           "batch_shape": list(batch.features.shape), "score_file_rows": rows,
           "score_file_launches": file_launches, "int_mm": int_mm_accepts(device)}
    print("int8_serving " + json.dumps(rec) + f"  [{card}]", flush=True)
    return {"flash_attn_fwd": launches["int8"] + file_launches}


def artifact_serving(card: str, work_dir: str, device: str = "cuda") -> dict:
    """Phase 9 (b): the flagship checkpoint exported for `cuda`, plain and
    int8, with the buckets of phase 4's request (its lists of at most
    ARTIFACT_MAX_DOCS docs) and LETOR file; each artifact
    served over HTTP and through score_file. Its scores against the
    checkpoint's own served scores (plain) or int8 served scores (int8) at
    the bf16 serving gate (SCORE_TOL), the forward kernel's launches during
    the replay (6 a batch), the export time and the artifact's size."""
    import numpy as np

    from ptranking_tpu_torch.data.dataset import BucketedDataset
    from ptranking_tpu_torch.export import export_scorer
    from ptranking_tpu_torch.score import score_file
    from ptranking_tpu_torch.serve import ScoringService

    ckpt = os.path.join(work_dir, "flagship.pt")
    payload = _serve_payload([n for n in SERVE_LENGTHS if n <= ARTIFACT_MAX_DOCS], NUM_FEATURES)
    body = json.dumps(payload).encode()
    sizes = [len(q["docs"]) for q in payload["queries"]]
    ds = BucketedDataset([(str(i), np.zeros((n, 1), np.float32), np.zeros(n, np.float32))
                          for i, n in enumerate(sizes)], batch_docs=100)
    buckets = ds.buckets  # they hold phase 4's LETOR file (20..400 docs) too
    launches, rec = 0, {}
    for q in ("none", "int8"):
        art = os.path.join(work_dir, f"flagship_{q}.pttx")
        t0 = time.perf_counter()
        blob = export_scorer(ckpt, art, batch_docs=100, buckets=buckets, platforms=[device],
                             quantize=q, device=device)
        export_s = time.perf_counter() - t0
        answer, n, http_s = _served(ScoringService(art, device=device), body)
        if n != 6 * len(ds):
            raise AssertionError(f"artifact ({q}): {n} forward launches during its replay for "
                                 f"{len(ds)} batches; expected 6 a batch")
        want, _, _ = _served(ScoringService(ckpt, quantize=q, device=device), body, repeats=0)
        err = _score_err(scores_by_docid(answer["results"]), scores_by_docid(want["results"]))
        if not err <= SCORE_TOL:
            raise AssertionError(f"artifact ({q}) scores differ from its checkpoint's by {err} "
                                 f"(tol {SCORE_TOL})")
        reset_counts()
        rows = score_file(art, os.path.join(work_dir, "flagship.txt"),
                          os.path.join(work_dir, f"flagship_{q}_artifact.run"),
                          data_id="MSLRWEB30K", device=device)
        file_launches = read_counts()["flash_attn_fwd"]
        if file_launches <= 0:
            raise AssertionError(f"score_file of the artifact ({q}) launched no forward kernel")
        launches += n + file_launches
        rec[q] = {"entries": len(blob["entries"]), "export_s": export_s,
                  "bytes": os.path.getsize(art), "launches": n,
                  "max_abs_err_vs_checkpoint": err, "bit_equal": err == 0.0,
                  "http_s": http_s, "score_file_rows": rows,
                  "score_file_launches": file_launches}
    print("artifact_serving " + json.dumps(rec) + f"  [{card}]", flush=True)
    return {"flash_attn_fwd": launches}


def _same_tree(a, b):
    """None when two trees (split_feat, split_bin, leaf_value) are the same
    bits, else the first difference. Empty leaves are 0/0: NaN on both, but
    the CPU's and CUDA's NaN differ in their bits, so NaN equals NaN."""
    import numpy as np

    for name, x, y in zip(("split_feat", "split_bin", "leaf_value"), a, b):
        if x.shape != y.shape:
            return f"{name} shapes {x.shape} {y.shape}"
        if x.dtype == np.float32:
            nan = np.isnan(x)
            if not np.array_equal(nan, np.isnan(y)):
                return f"{name}: NaN at other leaves"
            x, y = x[~nan].view(np.int32), y[~nan].view(np.int32)
        bad = np.flatnonzero(x != y)
        if bad.size:
            return f"{name}[{bad[0]}]: {x[bad[0]]} against {y[bad[0]]} ({bad.size} differ)"
    return None


def gbdt_data(device: str):
    """Synthetic MSLR-shaped binned data: (bins [n, F] int32 on `device`,
    target [n] float64, group [Q] int64). List lengths from a gamma of mean
    GBDT_MEAN_DOCS clipped to 1..GBDT_MAX_DOCS; bins uniform in
    0..GBDT_BINS-1 drawn on the device; labels 0..4 from a linear teacher over
    12 of the features plus noise, cut at global quantiles (MSLR-like: about
    half the docs 0)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(7)
    group = np.clip(np.round(rng.gamma(2.0, GBDT_MEAN_DOCS / 2.0, GBDT_QUERIES)), 1,
                    GBDT_MAX_DOCS).astype(np.int64)
    n = int(group.sum())
    gen = torch.Generator(device=device).manual_seed(7)
    bins = torch.randint(0, GBDT_BINS, (n, NUM_FEATURES), dtype=torch.int32, device=device,
                         generator=gen)
    w = torch.linspace(1.0, 2.0, 12, device=device)
    s = bins[:, :12].float() @ w / GBDT_BINS + 0.5 * torch.randn(n, device=device, generator=gen)
    cuts = torch.quantile(s[torch.randperm(n, device=device, generator=gen)[:1 << 20]],
                          torch.tensor([0.5, 0.8, 0.95, 0.99], device=device))
    target = torch.bucketize(s, cuts).double().cpu().numpy()
    return bins, target, group


def gbdt_phase(card: str, work_dir: str, device: str = "cuda") -> dict:
    """Phase 9 (c): the native GBDT on the card at MSLR-WEB30K's width (F =
    136, 64 bins, depth 8) on about 2.26 M docs: a fit of GBDT_TREES trees
    twice from the same binned data (the same trees, bit for bit), s a tree
    split into the host objective and the card's growth and prediction, the
    idle share of one profiled grow_tree, one tree grown from dyadic grad
    and hess (exact sums) held against the CPU plain path on GBDT_CPU_DOCS
    docs, the host binning's s a feature, and `ltr.main -model
    LightGBMLambdaMART -data SyntheticMQ -debug` end to end on the card."""
    import shutil

    import numpy as np
    import torch

    from ptranking_tpu_torch import ltr
    from ptranking_tpu_torch.tree import gbdt

    t0 = time.perf_counter()
    bins, target, group = gbdt_data(device)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    n = bins.shape[0]
    cfg = gbdt.GBDTConfig(num_trees=GBDT_TREES, max_depth=GBDT_DEPTH, num_bins=GBDT_BINS)
    fits, timings = [], []
    for _ in range(2):
        tm = {}
        fits.append(gbdt.GBDTRanker(cfg, device=device).boost(bins, target, group, timings=tm))
        timings.append(tm)
    same = len(fits[0].trees) == len(fits[1].trees) == GBDT_TREES and all(
        _same_tree(ta, tb) is None for ta, tb in zip(fits[0].trees, fits[1].trees))
    if not same:
        raise AssertionError("two fits from the same data grew different trees")
    leaves = fits[0].trees[-1][2]
    if not np.isfinite(leaves[np.isfinite(leaves)]).all() or not np.isfinite(leaves).any():
        raise AssertionError("the fit's leaves are not finite")

    # one grow_tree profiled: its idle share on the card
    g = torch.from_numpy(np.random.RandomState(1).randn(n).astype(np.float32)).to(device)
    h = torch.rand(n, device=device) + 0.01
    grow = lambda: gbdt.grow_tree(bins, g, h, GBDT_DEPTH, GBDT_BINS, 0.0, 1e-3)
    grow()
    busy_ms, _, wall_ms = profile_ms(grow, kernel="index")

    # the deepest level's histograms (128 nodes) as the tree builds them
    # (blocks of 8 features, int64 scatter-adds) and as a plain loop of one
    # fp32 index_add_ a feature, whose atomics add in no fixed order
    local = torch.randint(0, 1 << (GBDT_DEPTH - 1), (n,), device=device)
    FB = gbdt.FEATURE_BLOCK
    F = NUM_FEATURES // FB * FB  # 136: all of them
    blocks = bins[:, :F].t().reshape(F // FB, FB, n)
    src = torch.stack([gbdt.to_fixed(g, 30), gbdt.to_fixed(h, 30)], -1).repeat(FB, 1)
    ghf = torch.stack([g, h], -1)
    nodes = 1 << (GBDT_DEPTH - 1)

    def per_feature():
        for f in range(F):
            torch.zeros(nodes * GBDT_BINS, 2, device=device).index_add_(
                0, local * GBDT_BINS + bins[:, f].long(), ghf)

    hist_ms = {"blocked_int64": cuda_time_ms(
        lambda: gbdt.level_histograms(blocks, local, src, nodes, GBDT_BINS), 3, warmup=1),
        "per_feature_fp32": cuda_time_ms(per_feature, 3, warmup=1)}
    del blocks, src

    # dyadic grad and hess: exact sums in any order, so the card's tree is
    # the CPU plain path's, bit for bit
    rng = np.random.RandomState(3)
    k = GBDT_CPU_DOCS
    gd = torch.from_numpy(rng.randint(-64, 65, k).astype(np.float32) / 64.0)
    hd = torch.from_numpy(rng.randint(1, 65, k).astype(np.float32) / 128.0)
    sub = bins[:k]
    on_card = gbdt.grow_tree(sub, gd.to(device), hd.to(device), GBDT_DEPTH, GBDT_BINS, 0.0, 1e-3)
    t1 = time.perf_counter()
    on_cpu = gbdt.grow_tree(sub.cpu(), gd, hd, GBDT_DEPTH, GBDT_BINS, 0.0, 1e-3)
    cpu_s = time.perf_counter() - t1
    diff = _same_tree([t.cpu().numpy() for t in on_card], [t.numpy() for t in on_cpu])
    if diff is not None:
        raise AssertionError(f"the dyadic tree on the card differs from the CPU plain "
                             f"path's: {diff}")
    del bins, sub, g, h
    torch.cuda.empty_cache()

    # the host binning at this size, on a few features
    data = np.random.RandomState(5).randn(n, GBDT_BIN_TIMED)
    t1 = time.perf_counter()
    edges = gbdt.quantile_bin_edges(data, GBDT_BINS)
    t2 = time.perf_counter()
    gbdt.bin_features(data, edges)
    t3 = time.perf_counter()

    out = os.path.join(work_dir, "tree")
    shutil.rmtree(out, ignore_errors=True)
    t4 = time.perf_counter()
    cv = ltr.main(["-model", "LightGBMLambdaMART", "-data", "SyntheticMQ", "-debug",
                   "-dir_output", out, "-device", device])
    ltr_s = time.perf_counter() - t4
    if not np.all(np.isfinite(cv["nDCG"])) or not 0.0 < float(cv["nDCG"][2]) <= 1.0:
        raise AssertionError(f"tree k-fold run: CV nDCG {cv['nDCG']}")
    rec = {"docs": n, "queries": len(group), "features": NUM_FEATURES, "bins": GBDT_BINS,
           "depth": GBDT_DEPTH, "trees_per_fit": GBDT_TREES, "same_trees_twice": same,
           "bins_gb": n * NUM_FEATURES * 4 / 1e9, "data_s": data_s,
           "objective_s": [tm["objective"] for tm in timings],
           "grow_s": [tm["grow"] for tm in timings],
           "level7_histogram_ms": hist_ms,
           "profiled_grow_ms": wall_ms, "profiled_grow_busy_ms": busy_ms,
           "grow_idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
           "dyadic_cpu_equal_docs": k, "dyadic_cpu_grow_s": cpu_s,
           "host_quantile_s_per_feature": (t2 - t1) / GBDT_BIN_TIMED,
           "host_bin_s_per_feature": (t3 - t2) / GBDT_BIN_TIMED,
           "ltr_tree_s": ltr_s, "ltr_tree_cv_ndcg": [float(v) for v in cv["nDCG"]]}
    print("gbdt " + json.dumps(rec) + f"  [{card}]", flush=True)
    return rec


def parser_phase(card: str, work_dir: str) -> dict:
    """Phase 9 (d): the native LETOR parser on the card's machine: an
    MSLR-format file of PARSE_ROWS rows parsed natively and in Python to the
    same arrays, load_letor_file through the native path, the native rows/s
    on PARSE_COPIES copies of the file, and `data.stats` on it."""
    import contextlib
    import io

    import numpy as np

    from ptranking_tpu_torch.data import letor, native_parser, stats
    from ptranking_tpu_torch.data.dataset import make_synthetic_queries
    from ptranking_tpu_torch.utils import native_build

    root = os.path.join(work_dir, "parser")
    os.makedirs(root, exist_ok=True)
    queries = make_synthetic_queries(PARSE_ROWS // 120, num_features=NUM_FEATURES, max_label=4,
                                     min_docs=1, max_docs=239, seed=9)
    # MSLR's files carry no '#docid' comments
    small = letor.write_letor_file(queries, os.path.join(root, "small.txt"), with_comment=False)
    with open(small) as f:
        rows = sum(1 for _ in f)
    if not native_parser.native_parser_available():
        raise AssertionError("the native parser did not build on this machine")
    got = native_parser.parse_letor_file_native(small)
    with open(small, encoding="iso-8859-1") as f:
        want = letor.parse_letor_lines(f)
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and got[2] == want[2]):
        raise AssertionError("native and Python parses differ")
    python_calls = []
    parse_lines = letor.parse_letor_lines
    letor.parse_letor_lines = lambda *a, **k: python_calls.append(1) or parse_lines(*a, **k)
    try:
        loaded = letor.load_letor_file(small, data_id="MSLRWEB30K", presort=False)
    finally:
        letor.parse_letor_lines = parse_lines
    if python_calls or sum(len(q[2]) for q in loaded) != rows:
        raise AssertionError("load_letor_file did not parse natively")
    with open(small) as f:
        text = f.read()
    big = os.path.join(root, "big.txt")
    with open(big, "w") as f:
        for c in range(PARSE_COPIES):
            f.write(text.replace("qid:", f"qid:c{c}_"))
    t0 = time.perf_counter()
    parsed = native_parser.parse_letor_file_native(big)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(small, encoding="iso-8859-1") as f:
        letor.parse_letor_lines(f)
    python_s = time.perf_counter() - t0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st = stats.main(["-data", "MSLRWEB30K", "-file", big, "-min_rele", "0"])
    print(buf.getvalue(), end="", flush=True)
    rec = {"rows": rows, "native_equals_python": True, "big_rows": int(parsed[0].shape[0]),
           "big_mb": os.path.getsize(big) / 1e6, "native_s": native_s,
           "native_rows_per_s": parsed[0].shape[0] / native_s,
           "python_rows_per_s": rows / python_s, "stats_queries": st["num_queries"],
           "lib": os.path.relpath(native_parser.LIB_PATH, native_build.REPO_ROOT)}
    print("parser " + json.dumps(rec) + f"  [{card}]", flush=True)
    return rec


def serving_rest_phase(card: str, work_dir: str) -> dict:
    """Phase 9: (a) int8_serving, (b) artifact_serving, (c) gbdt_phase, (d)
    parser_phase. Returns the forward kernel's launches of (a) and (b)."""
    t0 = time.perf_counter()
    launches = int8_serving(card, work_dir)["flash_attn_fwd"]
    t1 = time.perf_counter()
    launches += artifact_serving(card, work_dir)["flash_attn_fwd"]
    t2 = time.perf_counter()
    gbdt_phase(card, work_dir)
    t3 = time.perf_counter()
    parser_phase(card, work_dir)
    print(f"serving_rest_phase_s {{\"int8\": {t1 - t0:.1f}, \"artifacts\": {t2 - t1:.1f}, "
          f"\"gbdt\": {t3 - t2:.1f}, \"parser\": {time.perf_counter() - t3:.1f}}}", flush=True)
    return {"flash_attn_fwd": launches}


# --- phase 10: the diversification branch ------------------------------------

# At the JAX package's own widths for this branch (its DivSFSetting defaults,
# diversification/settings.py): D = 100 (TREC Web Track's representation
# width), the pointsf 5 layers of 100 (GE, BN, affine), the listsf AttnDIN 6
# encoder layers x 6 heads on the 300-wide [q, d, q*d] then ff_dims (256,
# 128, 64) (ReLU, BN, affine); fp32, batches of 8 queries. The branch reaches
# no pl.pallas_call in the JAX package (its listsf takes the dense attention,
# its losses and metrics are plain XLA), so it runs plain torch on the card
# and launches none of ops/csrc's kernels.
DIV_D, DIV_BATCH = 100, 8
# the check batch of (a) and (b): 7 lists of 10..250 docs and an all-padded
# row in the 256-doc bucket
DIV_CHECK_DOCS = (10, 250)
# card against CPU in fp32 on the same params: mus, vars, cocos and the
# predictions (masked), max |card - cpu| over the CPU's largest entry; one
# step's gradients, each tensor's ||card - cpu|| over its ||cpu|| (rel_errs'
# measure), floored at DIV_GRAD_FLOOR of the largest (the biases a batch norm
# follows have a gradient of rounding size only)
DIV_TOL, DIV_GRAD_FLOOR = 1e-4, 1e-2
# (c): DIV_RES_QUERIES synthetic queries of 10..250 docs (every bucket of
# 16..256 docs), presorted on the card, two epochs resident and two streamed
# (512 since phase 12 came: 1,024 before; the script keeps within its time)
DIV_RES_QUERIES, DIV_RES_SEED = 512, 5
DIV_EPOCHS = (1, 2)
# queries whose card presort is held against the numpy greedy ideal ranking
DIV_PRESORT_CHECK = 32
# (d): the on-card metrics against the CPU's on the same scores; ndeval's
# alpha-nDCG@5/10/20 against the on-card metric
DIV_KS = (1, 3, 5, 10, 20)
DIV_METRIC_TOL, DIV_NDEVAL_TOL = 1e-6, 1e-5
DIV_NDEVAL_TOPICS = 16
# (b): each DIV_LOSSES key at full width (key, scorer, loss paras)
DIV_LOSS_CHECKS = [
    ("DALETOR", "listsf", {}),
    ("SuperSoft-aNDCG", "pointsf", {}),
    ("SuperSoft-aNDCG", "pointsf", {"opt_ideal": False}),
    ("SuperSoft-nERR-IA", "pointsf_K5", {}),
    ("SuperSoft-nERR-IA", "pointsf_K5", {"opt_ideal": False}),
    ("PairCLS", "listsf_co", {"opt_id": "PairCLS"}),
    ("LambdaPairCLS", "pointsf", {"opt_id": "LambdaPairCLS"}),
    ("LambdaPairCLS", "listsf_co", {"opt_id": "LambdaPairCLS", "opt_ideal": False}),
    ("Portfolio", "pointsf_cluster5", {}),
]


def div_configs() -> dict:
    """The scorers of (a) and (b) at full width, dropout 0: the settings'
    pointsf and listsf, the listsf's co variant, the pointsf at K = 5 and as
    a cluster of 5."""
    import dataclasses

    from ptranking_tpu_torch.diversification import DivSFSetting

    point = DivSFSetting(sf_id="pointsf").default_setting(DIV_D)["scorer"]
    lst = DivSFSetting(sf_id="listsf").default_setting(DIV_D)["scorer"]
    r = dataclasses.replace
    return {"pointsf": r(point, dropout=0.0), "listsf": r(lst, dropout=0.0),
            "listsf_co": r(lst, sf_id="listsf_co", dropout=0.0),
            "pointsf_K5": r(point, K=5, dropout=0.0),
            "pointsf_cluster5": r(point, K=5, cluster=True, dropout=0.0)}


def div_check_batch(seed: int):
    from ptranking_tpu_torch.diversification import DivBucketedDataset, make_synthetic_div_queries

    qs = make_synthetic_div_queries(DIV_BATCH - 1, num_features=DIV_D, min_docs=DIV_CHECK_DOCS[0],
                                    max_docs=DIV_CHECK_DOCS[1], seed=seed)
    return next(iter(DivBucketedDataset(qs, batch_queries=DIV_BATCH, doc_buckets=(256,))
                     .batches()))


def div_rel(got, want, mask=None) -> float:
    """max |got - want| / max |want| over the real entries (mask [B, N]; a
    [B, N, N] tensor takes the pair mask)."""
    import torch

    if mask is not None:
        m = mask if got.dim() == 2 else mask[:, :, None] & mask[:, None, :]
        got, want = torch.where(m, got, 0.0), torch.where(m, want, 0.0)
    return rel_err(got, want)


def div_scorers(card: str, device: str = "cuda") -> dict:
    """Phase 10 (a): each scorer of div_configs on the card against the same
    params on the CPU (fp32): mus, vars and cocos, and div_predict under
    ExpRele, RERAR and RiskAware for the pointsf and the listsf_co, within
    DIV_TOL; the ms of a forward on the card."""
    import dataclasses

    import torch

    from ptranking_tpu_torch import LTR_SEED
    from ptranking_tpu_torch.diversification import div_forward, div_predict, init_div_scorer
    from ptranking_tpu_torch.diversification.scorers import SORT_ID
    from ptranking_tpu_torch.models.scorers import map_params

    torch.backends.cuda.matmul.allow_tf32 = False
    b = div_check_batch(seed=1)
    cpu = [torch.from_numpy(a) for a in (b.q_repr, b.doc_reprs, b.doc_mask)]
    dev = [t.to(device) for t in cpu]
    rec = {}
    for name, cfg in div_configs().items():
        params = init_div_scorer(cfg, seed=LTR_SEED, device="cpu")
        dparams = map_params(lambda t: t.to(device), params)
        with torch.no_grad():
            got = div_forward(dparams, cfg, *dev)
            want = div_forward(params, cfg, *cpu)
            errs = {k: div_rel(g.cpu(), w, cpu[2]) for k, g, w in
                    zip(("mus", "vars", "cocos"), got, want) if w is not None}
            if (got[2] is None) != (name != "listsf_co"):
                raise AssertionError(f"div scorer {name}: cocos {got[2] is not None}")
            if name in ("pointsf", "listsf_co"):
                for sort_id in SORT_ID:
                    c = dataclasses.replace(cfg, sort_id=sort_id)
                    errs[sort_id] = div_rel(div_predict(dparams, c, *dev).cpu(),
                                            div_predict(params, c, *cpu), cpu[2])
            errs["forward_ms"] = (cuda_time_ms(lambda: div_forward(dparams, cfg, *dev), 10)
                                  if device == "cuda" else None)
        rec[name] = errs
    print("div_scorers " + json.dumps(rec) + f"  [{card}]", flush=True)
    bad = {n: {k: v for k, v in e.items() if k != "forward_ms" and not v <= DIV_TOL}
           for n, e in rec.items()}
    if any(bad.values()):
        raise AssertionError(f"div scorers, card against CPU over {DIV_TOL}: {bad}")
    return rec


def div_losses(card: str, device: str = "cuda") -> dict:
    """Phase 10 (b): one step's loss and gradients of every DIV_LOSSES key
    (DIV_LOSS_CHECKS: opt_ideal=False for SuperSoft and LambdaPairCLS) at
    full width on the card against the CPU, same params and batch: the loss
    and each gradient tensor within DIV_TOL relative (in norm, floored at
    DIV_GRAD_FLOOR of the largest tensor's norm); the worst element's
    relative error is recorded beside it."""
    import torch

    from ptranking_tpu_torch import LTR_SEED
    from ptranking_tpu_torch.diversification import DIV_LOSSES, div_forward, init_div_scorer
    from ptranking_tpu_torch.models.scorers import map_params, tree_leaves

    b = div_check_batch(seed=2)
    configs = div_configs()
    rec = {}
    for key, sf, kw in DIV_LOSS_CHECKS:
        cfg = configs[sf]
        params = init_div_scorer(cfg, seed=LTR_SEED, device="cpu")

        def step(dev):
            p = map_params(lambda t: t.detach().to(dev).requires_grad_(True), params)
            q, d, rm, dm = (torch.from_numpy(a).to(dev)
                            for a in (b.q_repr, b.doc_reprs, b.rele_mat, b.doc_mask))
            mus, vars_, cocos = div_forward(p, cfg, q, d, dm, training=True)
            if key == "DALETOR":
                loss = DIV_LOSSES[key](mus, rm, dm, **kw)
            else:
                loss = DIV_LOSSES[key](mus, vars_, rm, dm, cocos=cocos, **kw)
            return float(loss.detach()), [g.cpu() for g in torch.autograd.grad(loss, tree_leaves(p))]

        got_loss, got = step(device)
        want_loss, want = step("cpu")
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"div loss {key} on {sf}: non-finite gradient")
        names = leaf_names(params)
        norms = [float(w.norm()) for w in want]
        floor = DIV_GRAD_FLOOR * max(norms)
        rel = {n: float((g - w).norm()) / max(nw, floor)
               for n, g, w, nw in zip(names, got, want, norms)}
        top = max(float(w.abs().max()) for w in want)
        elem = {n: float((g - w).abs().max()) / max(float(w.abs().max()), 1e-3 * top)
                for n, g, w in zip(names, got, want)}
        worst, worst_elem = max(rel, key=rel.get), max(elem, key=elem.get)
        rec[f"{key}/{sf}" + ("/resort" if kw.get("opt_ideal") is False else "")] = {
            "loss": got_loss, "loss_rel": abs(got_loss - want_loss) / max(abs(want_loss), 1e-30),
            "grad_rel": rel[worst], "grad_rel_tensor": worst,
            "grad_elem_rel": elem[worst_elem], "grad_elem_rel_tensor": worst_elem}
    print("div_losses " + json.dumps(rec) + f"  [{card}]", flush=True)
    bad = {k: v for k, v in rec.items()
           if not (v["loss_rel"] <= DIV_TOL and v["grad_rel"] <= DIV_TOL)}
    if bad or len({k for k, _, _ in DIV_LOSS_CHECKS}) != len(DIV_LOSSES):
        raise AssertionError(f"div losses, card against CPU over {DIV_TOL}: {bad}")
    return rec


def div_queries(n: int, seed: int, device: str = "cuda"):
    """n SyntheticDiv queries of 10..250 docs at D = 100 (the JAX package's
    generator), presorted into their greedy ideal order on the card, all in
    one batched metrics/srd.py::greedy_ideal_ranking (padded to 250 docs and
    8 subtopics; the generator's numpy presort takes minutes for 1,000
    lists of up to 250 docs); the first DIV_PRESORT_CHECK orders are held
    against the numpy greedy ranking."""
    import numpy as np
    import torch

    from ptranking_tpu_torch.diversification import DivQuery, make_synthetic_div_queries
    from ptranking_tpu_torch.metrics.srd import greedy_ideal_ranking, np_greedy_ideal_ranking

    qs = make_synthetic_div_queries(n, num_features=DIV_D, min_docs=10, max_docs=250,
                                    seed=seed, presort=False)
    S = max(q.rele_mat.shape[0] for q in qs)
    N = max(q.rele_mat.shape[1] for q in qs)
    rele = np.zeros((n, S, N), np.float32)
    mask = np.zeros((n, N), bool)
    for i, q in enumerate(qs):
        rele[i, :q.rele_mat.shape[0], :q.rele_mat.shape[1]] = q.rele_mat
        mask[i, :q.rele_mat.shape[1]] = True
    orders = greedy_ideal_ranking(torch.from_numpy(rele).to(device),
                                  torch.from_numpy(mask).to(device)).cpu().numpy()
    orders = [o[:q.rele_mat.shape[1]] for o, q in zip(orders, qs)]  # pads come last
    for q, o in list(zip(qs, orders))[:DIV_PRESORT_CHECK]:
        if not np.array_equal(o, np_greedy_ideal_ranking(q.rele_mat)):
            raise AssertionError(f"div presort of {q.qid}: the card's greedy ideal ranking "
                                 "differs from numpy's")
    return [DivQuery(q.qid, q.q_repr, q.doc_reprs[o], q.rele_mat[:, o],
                     tuple(np.asarray(q.docnos)[o])) for q, o in zip(qs, orders)]


def profile_device(fn, trace_path=None) -> dict:
    """One call of `fn` under torch.profiler with the CUDA activity alone
    (kernels and copies; the host's operator events, which made a profiled
    epoch of 130 listsf steps take minutes to process, are not recorded):
    {wall ms, device busy ms, device idle share, host->device copies, with
    `trace_path` their bytes (from the exported trace, deleted after), the
    profiler's processing s}; None values where it recorded no device time.
    The device events are read from the raw kineto results."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    busy_ns, copies = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or e.is_user_annotation():
            continue
        busy_ns += e.duration_ns()
        copies += "Memcpy HtoD" in e.name()
    busy = busy_ns / 1e6
    rec = {"wall_ms": wall, "device_busy_ms": busy or None,
           "device_idle_share": 1.0 - busy / wall if busy else None,
           "memcpy_htod": copies if busy else None, "memcpy_htod_bytes": None}
    if trace_path and busy:
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(trace_path)
        rec["memcpy_htod_bytes"] = sum(
            int(e.get("args", {}).get("bytes", 0)) for e in events
            if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))
    rec["processing_s"] = time.perf_counter() - t1
    return rec


def profile_index_copies(what: str, fn, copied: list, trace_path=None) -> dict:
    """profile_device around `fn`, a resident epoch or round whose only
    host->device copies are its index chunks, which the host counts as it
    copies them (`copied`: a list the wrapper of `index_to_device` appends
    each chunk's bytes to; emptied here). The profiler must see the host's
    copies and nothing else: all of them, or all but one (the profiler
    missed one index copy of about half the profiled epochs and rounds on
    the H100 machine; a discarded warm-up step did not stop it); with
    `trace_path`, their bytes must be the host's, less one chunk's where
    one was missed. A profile that sees no copy fails."""
    del copied[:]
    prof = profile_device(fn, trace_path)
    prof.update(index_chunks=len(copied), index_bytes=sum(copied))
    seen, nbytes = prof["memcpy_htod"], prof["memcpy_htod_bytes"]
    missed = len(copied) - seen if seen else None
    ok = missed in (0, 1) and (
        nbytes is None or (missed == 0 and nbytes == sum(copied))
        or (missed == 1 and sum(copied) - nbytes in copied))
    prof["missed_copies"] = missed
    if not ok:
        raise AssertionError(f"{what}: the profiler saw {seen} host->device copies of "
                             f"{nbytes} bytes; the host copied {len(copied)} index chunks of "
                             f"{sum(copied)} bytes ({prof})")
    return prof


def div_training(card: str, work_dir: str, queries, device: str = "cuda"):
    """Phase 10 (c): DALETOR (listsf) and DivProbRanker (SuperSoft-aNDCG,
    pointsf), at the settings' optimizers and dropout, each trained
    DIV_EPOCHS from the device-resident buckets and, from the same seed,
    streamed from the host: the same losses and params, bit for bit. Then
    an epoch each way on the host's clock (queries/s), and DALETOR's
    resident one under the profiler (profile_device): idle share, and
    host->device copies, no more than its index chunks (their count and
    bytes taken on the host). Returns (the trained DALETOR ranker, the
    resident and the host dataset)."""
    import torch

    from ptranking_tpu_torch import LTR_SEED
    from ptranking_tpu_torch.data.device_cache import DivDeviceResidentDataset, div_packed_nbytes
    from ptranking_tpu_torch.diversification import (DIV_DEFAULT_PARAS, DivBucketedDataset,
                                                     DivRanker, DivSFSetting)

    ds = DivBucketedDataset(queries, batch_queries=DIV_BATCH)
    t0 = time.perf_counter()
    res = DivDeviceResidentDataset(ds, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    data = {"queries": len(queries), "docs": int(sum(q.doc_reprs.shape[0] for q in queries)),
            "buckets": list(ds.doc_buckets), "batches_an_epoch": len(ds),
            "packed_nbytes": div_packed_nbytes(ds), "upload_s": time.perf_counter() - t0}
    print("div_data " + json.dumps(data) + f"  [{card}]", flush=True)
    out = None
    for model_id, sf_id, paras in (("DALETOR", "listsf", {}),
                                   ("DivProbRanker", "pointsf",
                                    {"opt_id": "SuperSoft", "metric": "aNDCG"})):
        sf = DivSFSetting(sf_id=sf_id).default_setting(DIV_D)
        mp = dict(DIV_DEFAULT_PARAS[model_id], **paras)

        def make():
            return DivRanker(model_id, sf["scorer"], model_paras=mp, opt_cfg=sf["optimizer"],
                             seed=LTR_SEED, device=device).init()

        resident, streamed = make(), make()
        t0 = time.perf_counter()
        got = [resident.train_epoch_resident(res, e) for e in DIV_EPOCHS]
        want = [streamed.train_epoch(ds.batches(shuffle=True, epoch=e), e) for e in DIV_EPOCHS]
        diff = params_diff(resident, streamed)
        rec = {"model": f"{model_id}/{sf_id}", "losses_resident": got, "losses_streamed": want,
               "params": diff, "two_epochs_each_way_s": time.perf_counter() - t0}
        if got != want or not diff["same_bits"] or any(stop for _, stop in got):
            raise AssertionError(f"div resident against streamed: {rec}")
        nxt = max(DIV_EPOCHS) + 1
        for name, fn in (("resident", lambda e: resident.train_epoch_resident(res, e)),
                         ("streamed", lambda e: streamed.train_epoch(
                             ds.batches(shuffle=True, epoch=e), e))):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, stop = fn(nxt)
            if device == "cuda":
                torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
            if stop or not math.isfinite(loss):
                raise AssertionError(f"div {name} epoch {nxt}: loss {loss}, stop {stop}")
            rec[name] = {"epoch_s": epoch_s, "queries_per_s": len(queries) / epoch_s}
        if model_id == "DALETOR":
            # one resident epoch profiled: its host->device copies must be
            # its index chunks, as many as the host copied (their bytes are
            # not read: the trace export of the listsf's 130 steps is slow)
            copied = []
            res.index_to_device = lambda idx: (copied.append(idx.nbytes)
                                               or type(res).index_to_device(res, idx))
            try:
                rec["resident"]["profiled_epoch"] = profile_index_copies(
                    "div resident epoch", lambda: resident.train_epoch_resident(res, nxt + 1),
                    copied)
            finally:
                del res.index_to_device
            out = resident
        print("div_epochs " + json.dumps(rec) + f"  [{card}]", flush=True)
    return out, res, ds


def div_ndeval_cases():
    """DIV_NDEVAL_TOPICS rankings of 24 docs whose ideal order takes
    ndeval's tie-break (the larger docno wins; docnos d000..d023), as in
    tests/test_ndeval.py: [(rele [S, 24] of 2..4 subtopics, system order,
    ideal order)]."""
    import numpy as np

    def ndeval_greedy(rele, alpha=0.5):
        S, N = rele.shape
        gain, remaining, order = np.ones(S), list(range(N)), []
        while remaining:
            best, best_s = None, -1.0
            for d in remaining:
                s = float(np.sum(gain * rele[:, d]))
                if best is None or s > best_s or (s == best_s and d > best):
                    best, best_s = d, s
            gain *= np.where(rele[:, best] > 0, 1.0 - alpha, 1.0)
            order.append(best)
            remaining.remove(best)
        return np.asarray(order)

    rng = np.random.RandomState(7)
    cases = []
    for _ in range(DIV_NDEVAL_TOPICS):
        S, N = rng.randint(2, 5), 24
        rele = (rng.rand(S, N) < 0.35).astype(np.float32)
        rele[rng.randint(S), rng.randint(N)] = 1.0
        cases.append((rele, rng.permutation(N), ndeval_greedy(rele)))
    return cases


def div_evaluation(card: str, work_dir: str, ranker, res, ds, queries,
                   device: str = "cuda") -> dict:
    """Phase 10 (d): aNDCG, ERR-IA and nERR-IA at DIV_KS, per query, on the
    card against the CPU metrics fed the same scores (DIV_METRIC_TOL), and
    `evaluate` on the resident data; ndeval built by the port's native
    builder (a missing compiler or a failed build fails) run on the qrels
    and the run file of the trained ranker's rankings (a finite amean row);
    ndeval's alpha-nDCG@5/10/20 against the on-card metric
    (DIV_NDEVAL_TOL) on div_ndeval_cases."""
    import numpy as np
    import torch

    from ptranking_tpu_torch.diversification import DivLTREvaluator
    from ptranking_tpu_torch.diversification.ranker import _sorted_rele
    from ptranking_tpu_torch.metrics.ndeval import ndeval_binary, run_ndeval, write_qrels, write_run
    from ptranking_tpu_torch.metrics.srd import alpha_ndcg_at_ks, err_ia_at_ks, nerr_ia_at_ks

    def metrics(scores, rm, dm, sm):
        sys_rele, sys_mask = _sorted_rele(scores, rm, dm)
        return torch.cat([alpha_ndcg_at_ks(sys_rele, rm, sys_mask, DIV_KS),
                          err_ia_at_ks(sys_rele, sys_mask, 1.0, DIV_KS, subtopic_mask=sm),
                          nerr_ia_at_ks(sys_rele, rm, sys_mask, 1.0, DIV_KS, subtopic_mask=sm)],
                         dim=-1)

    worst, n_rows = 0.0, 0
    for batch in res.batches():
        scores = ranker.predict(batch)
        arrays = (scores, batch.rele_mat, batch.doc_mask, batch.subtopic_mask)
        got = metrics(*arrays).cpu()
        want = metrics(*(a.cpu() for a in arrays))
        worst = max(worst, float((got - want).abs().max()))
        n_rows += got.shape[0]
    t0 = time.perf_counter()
    ev = ranker.evaluate(res, ks=DIV_KS)
    eval_s = time.perf_counter() - t0
    rec = {"metric_rows": n_rows, "card_vs_cpu_max_abs": worst, "evaluate_s": eval_s,
           "evaluate": {m: np.asarray(v).tolist() for m, v in ev.items()}}

    binary = ndeval_binary()
    if binary is None:
        raise AssertionError("ndeval: no C++ compiler to build native/ndeval.cpp")
    nd_dir = os.path.join(work_dir, "div_ndeval")
    os.makedirs(nd_dir, exist_ok=True)
    t0 = time.perf_counter()
    # the evaluator's fold writer: run file, qrels, and ndeval's amean (None
    # where its advisory run failed)
    amean, _ = DivLTREvaluator(device=device)._write_fold_run(ranker, ds, queries, nd_dir, 1)
    if amean is None:
        raise AssertionError(f"ndeval failed on {nd_dir}'s fold_1 qrels and run")
    rec["ndeval_binary"] = os.path.relpath(binary, os.path.dirname(os.path.abspath(__file__)))
    rec["ndeval_s"] = time.perf_counter() - t0
    rec["ndeval_amean"] = {k: amean[k] for k in ("alpha-nDCG@5", "alpha-nDCG@10",
                                                  "alpha-nDCG@20", "ERR-IA@20", "nERR-IA@20")}
    rec["aNDCG@5,10,20 (evaluate)"] = [float(ev["aNDCG"][DIV_KS.index(k)]) for k in (5, 10, 20)]

    cases = div_ndeval_cases()
    qp, rp = os.path.join(nd_dir, "cases_qrels.txt"), os.path.join(nd_dir, "cases_run.txt")
    write_qrels(qp, [(t + 1, s + 1, f"d{d:03d}", int(rele[s, d]))
                     for t, (rele, _, _) in enumerate(cases)
                     for s in range(rele.shape[0]) for d in range(rele.shape[1])])
    write_run(rp, [(t + 1, f"d{d:03d}", rank + 1, float(len(order) - rank))
                   for t, (_, order, _) in enumerate(cases) for rank, d in enumerate(order)])
    res_nd = run_ndeval(qp, rp)
    # a batch of the cases, padded to 4 subtopics (an all-zero subtopic adds no gain)
    pad = lambda m: np.pad(m, ((0, 4 - m.shape[0]), (0, 0)))  # noqa: E731
    sys_rele = torch.from_numpy(np.stack([pad(r[:, o]) for r, o, _ in cases])).to(device)
    ideal = torch.from_numpy(np.stack([pad(r[:, i]) for r, _, i in cases])).to(device)
    mask = torch.ones(sys_rele.shape[0], sys_rele.shape[2], dtype=torch.bool, device=device)
    card_nd = alpha_ndcg_at_ks(sys_rele, ideal, mask, (5, 10, 20)).cpu().numpy()
    want_nd = np.asarray([[res_nd[str(t + 1)][f"alpha-nDCG@{k}"] for k in (5, 10, 20)]
                          for t in range(len(cases))])
    rec["ndeval_vs_card_max_abs"] = float(np.abs(card_nd - want_nd).max())
    print("div_evaluation " + json.dumps(rec) + f"  [{card}]", flush=True)
    if not (worst <= DIV_METRIC_TOL and rec["ndeval_vs_card_max_abs"] <= DIV_NDEVAL_TOL
            and all(math.isfinite(v) for v in amean.values())
            and all(math.isfinite(v) for vs in rec["evaluate"].values() for v in vs)):
        raise AssertionError(f"div evaluation: {rec}")
    return rec


def div_cli(card: str, work_dir: str, device: str = "cuda") -> dict:
    """Phase 10 (e): `python -m ptranking_tpu_torch.ltr -model DALETOR -sf_id
    listsf -data SyntheticDiv -debug` (its main) and the same with
    DivProbRanker (pointsf) on the card: finite CV metrics, a run file a
    fold; then -reproduce from the saved checkpoints gives the same CV
    metrics, bit for bit."""
    import shutil

    import numpy as np

    from ptranking_tpu_torch import ltr

    rec = {}
    for model_id, sf_id in (("DALETOR", "listsf"), ("DivProbRanker", "pointsf")):
        out = os.path.join(work_dir, "div_cli", model_id)
        shutil.rmtree(out, ignore_errors=True)
        argv = ["-model", model_id, "-sf_id", sf_id, "-data", "SyntheticDiv", "-debug",
                "-dir_output", out] + (["-device", device] if device != "cuda" else [])
        t0 = time.perf_counter()
        perf = ltr.main(argv)
        t1 = time.perf_counter()
        again = ltr.main(argv + ["-reproduce"])
        t2 = time.perf_counter()
        runs = sorted(f for _, _, fs in os.walk(out) for f in fs if f.endswith("_run.txt"))
        cv = {m: np.asarray(perf[m]).tolist() for m in ("aNDCG", "ERR-IA", "nERR-IA")}
        same = all(np.array_equal(np.asarray(perf[m]), np.asarray(again[m])) for m in cv)
        rec[model_id] = {"sf_id": sf_id, "run_s": t1 - t0, "reproduce_s": t2 - t1, "cv": cv,
                         "ndeval_cv": {k: np.asarray(v).tolist() for k, v in again.items()
                                       if k.endswith("(ndeval)")},
                         "run_files": runs, "reproduce_same_bits": same}
        if (not all(math.isfinite(v) for vs in cv.values() for v in vs) or not same
                or runs != ["fold_1_run.txt", "fold_2_run.txt"]):
            raise AssertionError(f"div CLI {model_id}: {rec[model_id]}")
    print("div_cli " + json.dumps(rec) + f"  [{card}]", flush=True)
    return rec


def div_phase(card: str, work_dir: str, device: str = "cuda") -> dict:
    """Phase 10: (a) div_scorers, (b) div_losses, (c) div_training, (d)
    div_evaluation, (e) div_cli; no kernel of ops/csrc launches in it.
    Prints each sub-phase's seconds."""
    reset_counts()
    t = [time.perf_counter()]
    div_scorers(card, device)
    t.append(time.perf_counter())
    div_losses(card, device)
    t.append(time.perf_counter())
    queries = div_queries(DIV_RES_QUERIES, DIV_RES_SEED, device)
    t.append(time.perf_counter())
    ranker, res, ds = div_training(card, work_dir, queries, device)
    t.append(time.perf_counter())
    div_evaluation(card, work_dir, ranker, res, ds, queries, device)
    t.append(time.perf_counter())
    div_cli(card, work_dir, device)
    t.append(time.perf_counter())
    counts = read_counts()
    names = ("scorers", "losses", "presort", "training", "evaluation", "cli")
    print("div_phase_s " + json.dumps({n: round(b - a, 1) for n, a, b in zip(names, t, t[1:])})
          + f"  [{card}]", flush=True)
    if any(counts.values()):
        raise AssertionError(f"div phase: kernels launched {counts}; the branch has none")
    return counts


# --- phase 11: the adversarial branch (IRGAN and IRFGAN, point / pair / list) ---
#
# At the JAX package's widths for the branch (adversarial/settings.py's
# AdSFSetting and AD_DEFAULT_PARAS): the pointsf 5 layers of 100 (ReLU, no
# batch norm, dropout 0.1, which the machines' forwards never apply, as in
# the JAX package), Adam at lr 1e-3, S = 5 samples a query, top_k = 5,
# IRGAN's temperature 0.5, on MSLR-WEB30K's 136 features, 512 docs a batch.
# The JAX branch reaches no pl.pallas_call (the pointsf only; its samplers
# and losses are plain XLA), so it runs plain torch on the card and launches
# none of ops/csrc's kernels.
AD_F, AD_BATCH_DOCS = 136, 512
# (c): AD_QUERIES synthetic queries of 20..250 docs (the buckets of 32..256
# docs), made from the seed (`--seed`, default AD_SEED), device-resident
# (512 since phase 12 came: 1,024 before; the script keeps within its time)
AD_QUERIES, AD_DOCS, AD_SEED = 512, (20, 250), 11
# (a): each sampler's draws; its empirical frequencies against its analytic
# distribution within a total-variation distance of 2 * sqrt(K / n) for K
# categories of nonzero probability and n draws (E[TV] <= sqrt(K / n) / 2)
AD_DRAWS = 1 << 20
# (a): IRFGAN_Pair's flattened pair axis at MSLR-WEB30K's longest list
AD_PAIR_N = 1408
# (b): the card (fp32) against the CPU in fp64 (the exact step) from the
# same params with the same draws: the loss within AD_LOSS_TOL of
# max(|loss|, 1) (allclose's atol = rtol: IRGAN_List's D loss under
# repTrick_D is a difference of two PL log-probs of about -8 that comes to
# about 3e-3); each gradient tensor of the stepped player within
# AD_PARAM_TOL of max(its norm, 1e-2 of the player's largest) (phase 10's
# `rel_errs` gate); each player's params after the step within
# AD_PARAM_TOL relative in norm. The CPU's own fp32 step sits at up to
# 5e-5 (gradients) and 5e-6 (params) from the fp64 one; a single param
# tensor up to 7.4e-5 (a bias whose gradient entries are near Adam's eps,
# which scales each to about +-lr): reported, not gated.
AD_LOSS_TOL, AD_PARAM_TOL = 1e-5, 1e-4
# (b): each step's draws by name (the port's machines take them as `draws`)
AD_STEP_DRAWS = {
    ("IRGAN_Point", "d"): ("pos_unif", "neg_idx"), ("IRGAN_Point", "g"): ("choose_idx",),
    ("IRGAN_Pair", "d"): ("pos_unif", "neg_idx"), ("IRGAN_Pair", "g"): ("pos_unif", "neg_idx"),
    ("IRGAN_List", "d"): ("gen_unif", "std_unif"), ("IRGAN_List", "g"): ("gen_unif",),
    ("IRFGAN_Point", "d"): ("pos_unif", "neg_idx"), ("IRFGAN_Point", "g"): ("neg_unif",),
    ("IRFGAN_Pair", "joint"): ("true_idx", "fake_idx"),
    ("IRFGAN_List", "d"): ("gen_unif", "std_unif"), ("IRFGAN_List", "g"): ("gen_unif",),
}
# (d): the run directories `ltr.main -debug -epochs 2` makes, as the JAX
# package's AdLTREvaluator names them (tests/test_torch_ad_evaluator.py holds
# the port's names against JAX's)
AD_CLI_RUNS = {
    "IRGAN_Point": "IRGAN_Point_SF_R5R_Adam_Lr0.001_SyntheticMQ_MiD_10_MiR_1_TrBat_512_EP_2_V_True"
                   "/1_1_0.5_DG_5",
    "IRFGAN_List": "IRFGAN_List_SF_R5R_Adam_Lr0.001_SyntheticMQ_MiD_10_MiR_1_TrBat_512_EP_2_V_True"
                   "/KL_1_1_DG_S5_top5",
}


def ad_seed() -> int:
    """`--seed N` on the command line, else AD_SEED."""
    argv = sys.argv[1:]
    return int(argv[argv.index("--seed") + 1]) if "--seed" in argv else AD_SEED


def ad_sf_para(num_features: int = AD_F) -> dict:
    from ptranking_tpu_torch.adversarial import AdSFSetting

    return AdSFSetting(sf_id="pointsf").default_setting(num_features)


def ad_machine(model_id: str, device: str, seed: int = 137, **paras):
    from ptranking_tpu_torch.adversarial import AD_DEFAULT_PARAS, AD_MACHINES

    return AD_MACHINES[model_id](sf_para=ad_sf_para(), seed=seed, device=device,
                                 ad_para_dict=dict(AD_DEFAULT_PARAS[model_id], **paras))


def _tv(samples, probs) -> tuple:
    """(TV distance of the samples' frequencies from `probs` [K], its
    bound 2 * sqrt(K+ / n)) on the samples' device."""
    import torch

    probs = probs.double().flatten()
    emp = torch.bincount(samples.flatten(), minlength=probs.numel()).double() / samples.numel()
    tv = 0.5 * float((emp - probs).abs().sum())
    return tv, 2.0 * math.sqrt(int((probs > 0).sum()) / samples.numel())


def ad_samplers(card: str, device: str = "cuda") -> dict:
    """Phase 11 (a): every sampler of adversarial/util.py on the card over
    AD_DRAWS draws against its analytic distribution (`_tv`); a pad never
    drawn where a valid entry exists; rows with nothing valid draw without
    error; the same generator seed gives the same draws twice, bit for
    bit; the ms of each draw."""
    import itertools

    import numpy as np
    import torch

    from ptranking_tpu_torch.adversarial import util

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def timed(fn):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    rec, n = {}, AD_DRAWS
    # with replacement, a 250-doc list, shorter ones and an all-pad row
    N = AD_DOCS[1]
    lengths = torch.tensor([N, 37, 1, 0], device=device)
    logits = 2.0 * torch.randn(4, N, generator=gen(1), device=device)
    mask = torch.arange(N, device=device)[None] < lengths[:, None]
    draws, ms = timed(lambda: util.sample_categorical_masked(logits, mask, n, gen=gen(2)))
    again = util.sample_categorical_masked(logits, mask, n, gen=gen(2))
    tvs = []
    for b, k in enumerate(lengths.tolist()):
        probs = (torch.softmax(logits[b, :k].double(), -1) if k
                 else torch.full((N,), 1.0 / N, dtype=torch.float64, device=device))
        probs = torch.nn.functional.pad(probs, (0, N - probs.numel()))
        tvs.append(_tv(draws[b], probs))
        if k and int(draws[b].max()) >= k:
            raise AssertionError(f"ad sampler drew a pad: row {b} of {k} valid")
    rec["categorical"] = {"tv": [t for t, _ in tvs], "bound": [b for _, b in tvs], "ms": ms,
                          "same_bits": bool(torch.equal(draws, again))}
    # without replacement (Gumbel top-k): the first two draws' joint
    # p_i p_j / (1 - p_i) over 5 valid of 8; pads only after every valid
    lg = torch.tensor([[1.0, 0.2, -0.5, 0.7, 0.0, 3.0, 3.0, 3.0]], device=device)
    m8 = torch.arange(8, device=device)[None] < 5
    got, ms = timed(lambda: util.sample_categorical_masked(lg.expand(n, 8), m8.expand(n, 8), 8,
                                                           replacement=False, gen=gen(3)))
    p = torch.softmax(lg[0, :5].double(), -1)
    joint = torch.zeros(5, 5, dtype=torch.float64, device=device)
    for i, j in itertools.permutations(range(5), 2):
        joint[i, j] = p[i] * p[j] / (1.0 - p[i])
    tv = _tv(got[:, 0] * 5 + got[:, 1], joint)
    pads_last = bool((got[:, :5] < 5).all() and (got[:, 5:] >= 5).all())
    rec["gumbel_top_k"] = {"tv": tv[0], "bound": tv[1], "ms": ms, "pads_last": pads_last,
                           "same_bits": bool(torch.equal(got, util.sample_categorical_masked(
                               lg.expand(n, 8), m8.expand(n, 8), 8, replacement=False,
                               gen=gen(3))))}
    # uniform positions over the leading positives; a count of 0 clips to 0
    counts = torch.tensor([7, 0], device=device)
    got, ms = timed(lambda: util.sample_uniform_positions(counts, n, N, gen=gen(4)))
    tv = _tv(got[0], torch.full((7,), 1 / 7, dtype=torch.float64, device=device))
    rec["uniform_positions"] = {"tv": tv[0], "bound": tv[1], "ms": ms,
                                "zero_count_clipped": bool((got[1] == 0).all())}
    # PL rankings: the top-2 of the Gumbel PL draw against PL(softmax)
    sc = torch.tensor([[0.9, -0.3, 0.4, 0.1, 7.0]], device=device)
    m5 = torch.arange(5, device=device)[None] < 4
    (order, top_p), ms = timed(lambda: util.sample_pl_rankings(sc, m5, n, 2, 0.5, gen=gen(5)))
    p = torch.softmax(sc[0, :4].double(), -1)
    joint = torch.zeros(4, 4, dtype=torch.float64, device=device)
    for i, j in itertools.permutations(range(4), 2):
        joint[i, j] = p[i] * p[j] / (1.0 - p[i])
    tv = _tv(order[0, :, 0] * 4 + order[0, :, 1], joint)
    rec["pl_rankings"] = {"tv": tv[0], "bound": tv[1], "ms": ms,
                          "no_pad": bool(order.max() < 4),
                          "probs_finite": bool(torch.isfinite(top_p).all())}
    # tie-shuffled truth rankings: three tied labels in uniform order
    lab = torch.tensor([[2.0, 1.0, 1.0, 1.0, 0.0, 5.0]], device=device)
    m6 = torch.arange(6, device=device)[None] < 5
    got, ms = timed(lambda: util.shuffled_truth_rankings(lab, m6, n, 5, gen=gen(6)))
    tv = _tv(got[0, :, 1] - 1, torch.full((3,), 1 / 3, dtype=torch.float64, device=device))
    rec["truth_rankings"] = {"tv": tv[0], "bound": tv[1], "ms": ms,
                             "label_order": bool((got[0, :, 0] == 0).all()
                                                 and (got[0, :, 4] == 4).all())}
    # discounted true pairs over a 64-doc list of labels 0..4 (4,096 pairs)
    rng = np.random.RandomState(7)
    lab64 = torch.from_numpy(np.sort(rng.randint(0, 5, 64))[::-1].astype(np.float32).copy())
    lab64 = lab64[None].to(device)
    m64 = torch.arange(64, device=device)[None] < 60
    (h, t, has), ms = timed(lambda: util.generate_true_pairs(lab64, m64, n, gen=gen(7)))
    w = util.weighted_clipped_pos_diffs(lab64, m64)[0].double()
    tv = _tv(h[0] * 64 + t[0], (w / w.sum()).flatten())
    rec["true_pairs"] = {"tv": tv[0], "bound": tv[1], "ms": ms, "has_pairs": bool(has[0]),
                         "heads_above_tails": bool((lab64[0, h[0]] > lab64[0, t[0]]).all())}
    # the two-stage Bernoulli draws (BT and Gaussian), one Bernoulli outcome
    # a row: n rows of one draw, against the enumeration of every outcome
    vals = torch.tensor([[1.5, 0.0, -1.0, 9.9]], device=device).expand(n, 4)
    m4 = (torch.arange(4, device=device)[None] < 3).expand(n, 4)
    for name, fn, probs in (
            ("pairs_bt", lambda: util.sample_pairs_bt(vals, m4, 1, gen=gen(8)),
             torch.sigmoid(vals[0, :, None] - vals[0, None, :])),
            ("pairs_gaussian", lambda: util.sample_pairs_gaussian(vals, m4, 1, gen=gen(8)),
             util.gaussian_integral_0_inf(vals[0, :, None] - vals[0, None, :], math.sqrt(2.0)))):
        (h, t), ms = timed(fn)
        pm = torch.where(m4[0, :, None] & m4[0, None, :], probs, 0.0).clamp(0, 1)
        pm = pm.double().cpu().numpy().ravel()
        live = np.nonzero(pm > 0)[0]
        want = np.zeros_like(pm)
        for bits in itertools.product((0, 1), repeat=live.size):
            b = np.zeros_like(pm)
            b[live] = bits
            pr = np.prod(np.where(b[live] > 0, pm[live], 1.0 - pm[live]))
            want += pr * (b / b.sum() if b.sum() else pm / pm.sum())
        tv = _tv((h * 4 + t).flatten(), torch.from_numpy(want).to(device))
        rec[name] = {"tv": tv[0], "bound": tv[1], "ms": ms,
                     "no_pad": bool(h.max() <= 2 and t.max() <= 2)}
    # IRFGAN_Pair's fake pairs over the flattened axis of two 1,408-doc
    # lists (1,982,464 categories a row), one all padded: valid pairs only,
    # the padded row drawing in range
    big = torch.randn(2, AD_PAIR_N, generator=gen(9), device=device)
    mb = torch.arange(AD_PAIR_N, device=device)[None] < torch.tensor([[1000], [0]], device=device)
    bt = torch.nn.functional.logsigmoid(big[:, :, None] - big[:, None, :])
    bt = torch.where(mb[:, :, None] & mb[:, None, :], bt, -1e30).reshape(2, -1)
    got, ms = timed(lambda: util.categorical(bt, 5, gen(10)))
    rec["flat_pairs_1408"] = {"ms": ms, "valid": bool(((got[0] // AD_PAIR_N) < 1000).all()
                                                      and ((got[0] % AD_PAIR_N) < 1000).all()),
                              "in_range": bool((got[1] < AD_PAIR_N ** 2).all())}
    # rows with nothing valid, each sampler
    none = torch.zeros(3, 9, dtype=torch.bool, device=device)
    z = torch.randn(3, 9, generator=gen(11), device=device)
    ok = [util.sample_categorical_masked(z, none, 50, gen=gen(12)),
          util.sample_categorical_masked(z, none, 9, replacement=False, gen=gen(12)),
          *util.sample_points_bernoulli(torch.zeros(3, 9, 9, device=device), 50, gen=gen(12)),
          *util.generate_true_pairs(torch.zeros(3, 9, device=device), none, 50, gen=gen(12))[:2]]
    rec["all_pad_rows"] = bool(all(int(t.min()) >= 0 and int(t.max()) < 9 for t in ok))
    failed = [k for k, v in rec.items() if isinstance(v, dict) and (
        ("tv" in v and not all(a < b for a, b in zip(np.atleast_1d(v["tv"]),
                                                     np.atleast_1d(v["bound"]))))
        or not all(x for x in v.values() if isinstance(x, bool)))]
    print("ad_samplers " + json.dumps(rec) + f"  [{card}]", flush=True)
    if failed or not rec["all_pad_rows"]:
        raise AssertionError(f"ad samplers failed their checks: {failed}")
    return rec


def ad_step_draws(model_id: str, step: str, labels, mask, S: int, gen) -> dict:
    """The draws of one step (AD_STEP_DRAWS) on the CPU from `gen`: the
    uniforms, and the indices drawn uniformly over what the step's sampler
    could draw (valid docs, IRGAN_Pair's D negatives past the positives,
    valid pairs)."""
    import torch

    from ptranking_tpu_torch.adversarial import util
    from ptranking_tpu_torch.adversarial.base import num_pos

    B, N = mask.shape
    npos = num_pos(labels, mask)
    neg = mask & (torch.arange(N)[None] >= npos[:, None]) if (model_id, step) == (
        "IRGAN_Pair", "d") else mask
    pairs = (mask[:, :, None] & mask[:, None, :]).reshape(B, N * N)

    def uniform_idx(m, k):
        return util.sample_categorical_masked(torch.zeros(m.shape), m, k, gen=gen)

    make = {"pos_unif": lambda: torch.rand(B, S, generator=gen),
            "neg_idx": lambda: uniform_idx(neg, S),
            "choose_idx": lambda: uniform_idx(mask, 5 * S),
            "gen_unif": lambda: torch.rand(B, S, N, generator=gen),
            "std_unif": lambda: torch.rand(B, S, N, generator=gen),
            "neg_unif": lambda: torch.rand(B, N, generator=gen),
            "true_idx": lambda: uniform_idx(pairs, S),
            "fake_idx": lambda: uniform_idx(pairs, S)}
    return {name: make[name]() for name in AD_STEP_DRAWS[(model_id, step)]}


def ad_steps(card: str, ds, device: str = "cuda") -> dict:
    """Phase 11 (b): each machine's D and G step (IRFGAN_Pair: the joint
    step) on the card in fp32 and on the CPU in fp64, from the same params
    (a seed's init is the same on both) with the same draws
    (ad_step_draws), on the first batch of the smallest and of the largest
    bucket, both steps in turn on the same two machines: the loss, the
    stepped players' gradients and both players' params after each step
    within the gates of AD_LOSS_TOL and AD_PARAM_TOL. A second card
    machine takes the same steps: whether the card gives the same bits
    twice is reported, not gated."""
    import torch

    from ptranking_tpu_torch.adversarial import AD_MACHINES
    from ptranking_tpu_torch.models.scorers import map_params, tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    buckets = [min(ds.buckets), max(ds.buckets)]
    batches = {}
    for b in ds.batches():
        n = b.features.shape[1]
        if n in buckets and n not in batches:
            batches[n] = [torch.from_numpy(a) for a in (b.features, b.labels, b.mask)]

    def rel(a, b, floor=0.0):
        a, b = a.detach().cpu().double(), b.detach().double()
        return float(torch.linalg.norm(a - b)) / max(float(torch.linalg.norm(b)), floor, 1e-30)

    rec, worst = {}, {"loss": 0.0, "grads": 0.0, "params": 0.0, "param_tensor": 0.0}
    twice = {}
    for model_id in AD_MACHINES:
        card_m, cpu_m = ad_machine(model_id, device), ad_machine(model_id, "cpu")
        again = ad_machine(model_id, device)  # the card's step twice: the same bits?
        pairs = ((card_m.generator, cpu_m.generator), (card_m.discriminator, cpu_m.discriminator))
        for pc, ph in pairs:
            if not all(torch.equal(a.detach().cpu(), b.detach())
                       for a, b in zip(tree_leaves(pc.params), tree_leaves(ph.params))):
                raise AssertionError(f"ad steps {model_id}: the card's init differs from the CPU's")
            ph.params = map_params(lambda t: t.detach().double(), ph.params)
            ph._start_training_state()
        gen = torch.Generator().manual_seed(3)
        for n, (f, l, m) in sorted(batches.items()):
            for step in ("joint",) if model_id == "IRFGAN_Pair" else ("d", "g"):
                draws = ad_step_draws(model_id, step, l, m, cpu_m.samples_per_query, gen)
                out = []
                for mach, dev, dt in ((card_m, device, torch.float32),
                                      (cpu_m, "cpu", torch.float64),
                                      (again, device, torch.float32)):
                    args = [f.to(dev, dt), l.to(dev, dt), m.to(dev)]
                    dr = {k: v.to(dev) for k, v in draws.items()}
                    if step == "joint":
                        loss = torch.stack(mach._joint_step(*args, dr))
                    else:
                        loss = (mach._d_step if step == "d" else mach._g_step)(*args, dr)
                    out.append(loss.detach().cpu().double())
                diff = (out[0] - out[1]).abs()
                twice[f"{model_id}/{step}/{n}"] = bool(torch.equal(out[0], out[2])) and all(
                    torch.equal(a, b) for pa, pb in ((card_m.generator, again.generator),
                                                     (card_m.discriminator, again.discriminator))
                    for a, b in zip(tree_leaves(pa.params), tree_leaves(pb.params)))
                r = {"loss": out[1].tolist(),
                     "loss_rel": float((diff / out[1].abs().clamp_min(1e-30)).max()),
                     "loss_gated": float((diff / out[1].abs().clamp_min(1.0)).max())}
                stepped = {"d": pairs[1:], "g": pairs[:1], "joint": pairs}[step]
                r["grads"] = max(
                    rel(a.grad, b.grad, 1e-2 * max(float(torch.linalg.norm(t.grad))
                                                   for t in tree_leaves(ph.params)))
                    for pc, ph in stepped
                    for a, b in zip(tree_leaves(pc.params), tree_leaves(ph.params)))
                r["params"] = max(rel(torch.cat([t.detach().cpu().flatten()
                                                 for t in tree_leaves(pc.params)]),
                                      torch.cat([t.detach().flatten()
                                                 for t in tree_leaves(ph.params)]))
                                  for pc, ph in pairs)
                r["param_tensor"] = max(rel(a, b) for pc, ph in pairs
                                        for a, b in zip(tree_leaves(pc.params),
                                                        tree_leaves(ph.params)))
                rec[f"{model_id}/{step}/{n}"] = r
                for k in worst:
                    worst[k] = max(worst[k], r["loss_gated" if k == "loss" else k])
                if (r["loss_gated"] > AD_LOSS_TOL or r["grads"] > AD_PARAM_TOL
                        or r["params"] > AD_PARAM_TOL or not bool(torch.isfinite(out[1]).all())):
                    raise AssertionError(f"ad step {model_id}/{step} at {n} docs: card against "
                                         f"CPU {r}")
    # not gated: a backward through a gather with repeated indices (the
    # draws with replacement) adds with atomics on the card, in no fixed order
    print("ad_steps " + json.dumps({"worst": worst, "card_twice_same_bits": twice, "steps": rec})
          + f"  [{card}]", flush=True)
    return worst


def ad_epochs(card: str, res, ds, work_dir: str, device: str = "cuda") -> dict:
    """Phase 11 (c): one mini_max_train round (DG, 1-1) of each machine
    from the device-resident buckets, then one streamed from the host, on
    the host's clock around synchronised rounds: queries/s (a round is
    host-bound at 3..6 s, so one a way keeps the phase inside its 90 s; the
    spread of two runs is two runs of the phase).
    Then one resident IRGAN_Point round under the profiler (profile_device):
    idle share, host->device copies and their bytes, which must be the
    index chunks' (counted, and their bytes summed, on the host)."""
    import torch

    from ptranking_tpu_torch.adversarial import AD_MACHINES

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    warm = ad_machine("IRGAN_Point", device, seed=1)
    warm.mini_max_train(list(ds.batches())[:8])  # the card's libraries, once
    sync()
    rec = {}
    for model_id in AD_MACHINES:
        mach = ad_machine(model_id, device)
        rec[model_id] = {}
        for epoch, how in enumerate(("resident", "streamed"), 1):
            sync()
            t0 = time.perf_counter()
            stop = mach.mini_max_train(res if how == "resident" else ds, epoch_k=epoch)
            sync()
            secs = time.perf_counter() - t0
            if stop:
                raise AssertionError(f"ad {model_id} {how} round {epoch} went non-finite")
            rec[model_id][how] = {"round_s": secs, "queries_per_s": ds.num_queries / secs}
    mach = ad_machine("IRGAN_Point", device)
    copied = []
    res.index_to_device = lambda idx: (copied.append(idx.nbytes)
                                       or type(res).index_to_device(res, idx))
    try:
        rec["IRGAN_Point"]["resident"]["profiled_round"] = profile_index_copies(
            "ad resident round", lambda: mach.mini_max_train(res, epoch_k=9), copied,
            os.path.join(work_dir, "ad_trace.json"))
    finally:
        del res.index_to_device
    print("ad_epochs " + json.dumps(rec) + f"  [{card}]", flush=True)
    return rec


def ad_cli(card: str, work_dir: str, device: str = "cuda") -> dict:
    """Phase 11 (d): `ltr.main -model IRGAN_Point` and `-model IRFGAN_List`
    on SyntheticMQ -debug (2 folds) for 2 epochs: finite G and D CV nDCG,
    the run directory named as the JAX package names it (AD_CLI_RUNS), the
    epochs of minimax training each fold ran, at least one fold of each
    running both (a fold whose fresh G scores 0 everywhere stops at the G
    guard after epoch 1, as in the JAX package); and `-mesh data=2` refused
    on one card (two NCCL ranks need two cards)."""
    import shutil

    import numpy as np

    from ptranking_tpu_torch import ltr
    from ptranking_tpu_torch.adversarial.base import AdversarialMachine

    import torch

    rec = {}
    dev = ["-device", device] if device != "cuda" else []
    rounds = {}  # id of each fold's machine -> the epoch_k of its rounds
    mini_max_train = AdversarialMachine.mini_max_train

    def counted(self, train_data=None, epoch_k=0, shuffle=True):
        rounds.setdefault(id(self), []).append(epoch_k)
        return mini_max_train(self, train_data, epoch_k, shuffle)

    AdversarialMachine.mini_max_train = counted
    try:
        for model_id, run in AD_CLI_RUNS.items():
            out = os.path.join(work_dir, "ad_cli", model_id)
            shutil.rmtree(out, ignore_errors=True)
            rounds.clear()
            t0 = time.perf_counter()
            cv = ltr.main(["-model", model_id, "-data", "SyntheticMQ", "-debug", "-epochs", "2",
                           "-dir_output", out] + dev)
            runs = sorted(os.path.relpath(r, out) for r, ds, _ in os.walk(out) if "G" in ds)
            rec[model_id] = {"run_s": time.perf_counter() - t0, "runs": runs,
                             "fold_epochs": list(rounds.values()),
                             **{n: np.asarray(cv[n]).tolist() for n in ("G", "D")}}
            if (runs != [run] or not all(np.isfinite(cv[n]).all() for n in ("G", "D"))
                    or len(rounds) != 2 or [1, 2] not in rounds.values()):
                raise AssertionError(f"ad CLI {model_id}: {rec[model_id]}")
    finally:
        AdversarialMachine.mini_max_train = mini_max_train
    # two NCCL ranks need two cards: refused, never run on fewer ranks
    if device == "cuda" and torch.cuda.device_count() < 2:
        try:
            ltr.main(["-model", "IRGAN_Point", "-data", "SyntheticMQ", "-debug", "-mesh",
                      "data=2", "-dir_output", os.path.join(work_dir, "ad_cli", "mesh")] + dev)
        except ValueError as e:
            rec["mesh_refused"] = str(e)
        else:
            raise AssertionError("ad CLI: -mesh data=2 ran on one card")
    print("ad_cli " + json.dumps(rec) + f"  [{card}]", flush=True)
    return rec


def ad_phase(card: str, work_dir: str, device: str = "cuda") -> dict:
    """Phase 11: (a) ad_samplers, (b) ad_steps, (c) ad_epochs over
    AD_QUERIES synthetic queries uploaded once, (d) ad_cli; no kernel of
    ops/csrc launches in it. Prints each sub-phase's seconds."""
    import torch

    from ptranking_tpu_torch.data.dataset import BucketedDataset, make_synthetic_queries
    from ptranking_tpu_torch.data.device_cache import DeviceResidentDataset, packed_nbytes

    reset_counts()
    t = [time.perf_counter()]
    ad_samplers(card, device)
    t.append(time.perf_counter())
    seed = ad_seed()
    qs = make_synthetic_queries(num_queries=AD_QUERIES, num_features=AD_F, min_docs=AD_DOCS[0],
                                max_docs=AD_DOCS[1], seed=seed)
    ds = BucketedDataset(qs, batch_docs=AD_BATCH_DOCS, num_features=AD_F)
    res = DeviceResidentDataset(ds, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t.append(time.perf_counter())
    print("ad_data " + json.dumps({
        "seed": seed, "queries": len(qs), "docs": int(sum(len(q[2]) for q in qs)),
        "buckets": list(ds.buckets), "batches_a_pass": len(ds),
        "packed_nbytes": packed_nbytes(ds), "make_and_upload_s": t[-1] - t[-2]})
        + f"  [{card}]", flush=True)
    ad_steps(card, ds, device)
    t.append(time.perf_counter())
    ad_epochs(card, res, ds, work_dir, device)
    t.append(time.perf_counter())
    ad_cli(card, work_dir, device)
    t.append(time.perf_counter())
    counts = read_counts()
    names = ("samplers", "data", "steps", "epochs", "cli")
    print("ad_phase_s " + json.dumps({n: round(b - a, 1) for n, a, b in zip(names, t, t[1:])})
          + f"  [{card}]", flush=True)
    if any(counts.values()):
        raise AssertionError(f"ad phase: kernels launched {counts}; the branch has none")
    return counts


# --- phase 12: data, tensor and pipeline parallelism, expert sharding ---
PAR_STEPS = 3           # flagship LambdaRank steps in (a) and (a'), at TRAIN_B x TRAIN_N
PAR_WASS_STEPS = 1      # WassRank steps in (a)
PAR_GLOO_B = 4          # lists of TRAIN_N docs a data rank in (c); (d), (e) take 2x on each
PAR_CLI_BATCH_DOCS = 4000  # (b)'s training batches: one a bucket an epoch
PAR_GLOO_STEPS = 2
PAR_TIMEOUT_S = 300     # the gloo group's collectives and the spawn's join
PAR_LOSS_RTOL, PAR_NDCG_ATOL = 1e-5, 1e-5  # the CPU tests' tolerances (test_torch_parallel_*)
# (c)'s first step's gradients summed over the two ranks against one
# device's, per tensor as rel_errs measures them: both runs take the same
# kernels on the same rows, only the sums over rows are grouped differently.
# (c) runs the flagship in fp32, as the CPU tests do: in bf16 a GEMM over
# half the rows may round a row's activations to a neighbouring bf16 value
# (8 bits), which parts the two runs at the bf16 gate's level, not a
# reduction's. Later steps' params are not held to one device: Adagrad's
# first steps (lr times the gradient's sign) turn rounding in a near-zero
# gradient entry into lr either way, so only the two ranks' bits are held.
# (d)'s tensor-parallel gradients (joined over `model`) are held to the same
# bar: the row-parallel layers' partial sums are the only other grouping.
PAR_GRAD_RTOL = 1e-5
PAR_GLOO_DTYPE = "float32"
# (d) in bf16: the row-parallel layers sum fp32 partial products and round
# once, where one device rounds one fp32 product; that moves bf16 roundings,
# so the bf16 TP step is reported beside the bf16 one-device step and gated
# at the bf16 forward's 2e-2 (its first loss) only
PAR_BF16_FWD_RTOL = 2e-2
PAR_PP_ATOL = 1e-5      # (e): pipeline scores against one device's, fp32
PAR_PP_MICROBATCHES = 4  # the PPPlan default (the JAX package's)
PAR_EP_K, PAR_EP_B, PAR_EP_N = 4, DIV_BATCH, 256  # (f): the cluster and its batch
PAR_EP_MUS_ATOL = 1e-5
PAR_EP_VARS_RTOL, PAR_EP_VARS_ATOL = 2e-3, 1e-4  # the JAX package's own bar
PAR_CKPT = "par_dp.pt"  # (c)'s trained params, which (e) stages
# (g): context parallelism on the one-rank mesh against the AdhocRanker (the
# flagship's kernels): the first loss and nDCG at PAR_CP_*, the first
# step's gradients (worst tensor, rel_errs) under LambdaRank and RankNet at
# GRAD_TOL. The CP path's attention is plain fp32 (sdpa_block), the
# AdhocRanker's 3xTF32 kernels; at init, at 1408 docs, the flagship's step
# magnifies such rounding into its gradients (phase 5's GRAD_TOL note): the
# kernels and the dense path part by 2.9e-3 in the worst tensor, the CP path
# and the dense path by 3.3e-3 under LambdaRank, the CP path and the kernels
# by 3.1e-3 under RankNet (PR 23 calls 1 and 2), where a wrong transpose of
# a collective gives O(1). The attention's own gradients are held tightly
# in (h) (PAR_CP_ATT_*). bf16 reported beside them
PAR_CP_LOSS_RTOL, PAR_CP_NDCG_ATOL = 1e-5, 1e-5
# (h): ring and Ulysses attention alone on the two ranks, at the flagship's
# attention shape [2 * PAR_GLOO_B, 2, TRAIN_N, 68], against one device's
# reference attention: outputs atol, q, k, v gradients rtol and atol (the
# CPU tests' bar, tests/test_torch_ring.py)
PAR_CP_ATT_ATOL, PAR_CP_ATT_GRAD_RTOL, PAR_CP_ATT_GRAD_ATOL = 1e-5, 1e-4, 1e-5
# (h): the CP loss zoo on the two gloo ranks against the port's one-device
# dense losses, PAR_ZOO_B ragged lists of TRAIN_N docs (one all-padded),
# labels 0..4 (MSLR-WEB30K's levels): values rtol 1e-5; score gradients
# measured in units of the JAX package's own bar, rtol 1e-4 and atol 1e-6
# (tests/test_parallel.py:710-713), against the dense loss in fp64 (the
# exact gradient, to fp32's eyes). Where the dense loss's own fp32 gradient
# is further than that bar from its fp64 one (WassRank's, whose log-domain
# potentials reach |C| / lam, 2.2x the bar on the CPU at 4 x 32), the CP
# gradient may be twice as far as the dense fp32 one: the gate is CP's
# distance to fp64 <= max(1, 2 x the dense fp32 loss's)
PAR_ZOO_B = 8
PAR_ZOO_RTOL, PAR_ZOO_GRAD_RTOL, PAR_ZOO_GRAD_ATOL = 1e-5, 1e-4, 1e-6
CP_ZOO = [("LambdaRank", {}), ("LambdaLoss", {}), ("ApproxNDCG", {}), ("SoftRank", {}),
          ("WassRank", {"mode": "SinkhornOT"}), ("WassRank", {"mode": "EntropicOT"}),
          ("NeuralNDCG", {}), ("RankNet", {})]
# the kernels the CP path must not launch: B3 (flash off under CP), B1 (the
# ring losses take the pair space) and B2 (the doc-sharded Sinkhorn is plain)
CP_IDLE_KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dkdv", "flash_attn_bwd_dq",
                   "pairwise_lambda_fwd", "pairwise_lambda_bwd", "sinkstep")


def _par_steps(ranker, batch, steps: int) -> list:
    """`steps` optimizer steps on `batch` (ranker._step on the rank's block),
    the losses fetched at the end."""
    import torch

    if not steps:
        return []
    losses = [ranker._step(*ranker._batch_arrays(batch)) for _ in range(steps)]
    return [float(x) for x in ranker._dp.all_reduce(torch.stack(losses)).cpu()]


def _named_params(params) -> dict:
    """{leaf name: numpy array} of a param tree."""
    from ptranking_tpu_torch.models.scorers import tree_leaves

    return dict(zip(leaf_names(params), (t.detach().cpu().numpy() for t in tree_leaves(params))))


def _full_grads(ranker) -> list:
    """The gradients of the ranker's leaves, full tensors: a tensor-parallel
    trainer's shards joined over `model` (a collective)."""
    from ptranking_tpu_torch.models.scorers import tree_leaves

    grads = [p.grad.detach() for p in ranker._leaves]
    if ranker._tp is not None:
        grads = [ranker._tp.join_leaf(g, s) for g, s in zip(grads, tree_leaves(ranker._tp.spec))]
    return [g.cpu().clone() for g in grads]


def _par_run(ranker, batch, steps: int) -> dict:
    """Phase 12 (c) and (d) on one ranker: nDCG@ks of its initial params, its
    first step's loss and (summed, joined) gradients without the update,
    then `steps` steps: their losses, the (joined) params and the
    launches."""
    t0 = time.perf_counter()
    ndcg = ranker.evaluate([batch], ks=(1, 5))["nDCG"].tolist()
    update, ranker._optimizer.step = ranker._optimizer.step, lambda: None
    loss = _par_steps(ranker, batch, 1)[0]
    grads = _full_grads(ranker)
    ranker._optimizer.step = update
    reset_counts()
    losses = _par_steps(ranker, batch, steps)
    counts = read_counts()
    full = ranker.full_params() if hasattr(ranker, "full_params") else ranker.params
    return {"ndcg": ndcg, "loss": loss, "grads": grads, "losses": losses,
            "params": _named_params(full), "launches": counts,
            "run_s": time.perf_counter() - t0}


def _tp_run(mesh, batch, steps: int, dtype: str, num_features: int, device: str) -> dict:
    """Phase 12 (d) on one rank: `_par_run` of a tp=True flagship trainer on
    the model mesh, with the q shapes its attention took (the rank's heads)
    and its set-up seconds."""
    from ptranking_tpu_torch.models.scorers import listsf

    t0 = time.perf_counter()
    tr = flagship_ranker(dropout=0.0, compute_dtype=dtype, num_features=num_features,
                         mesh=mesh, device=device, tp=True)
    setup = time.perf_counter() - t0
    shapes, real = set(), listsf.flash_attention

    def recorded(q, k, v, mask):
        shapes.add(tuple(q.shape))
        return real(q, k, v, mask)

    listsf.flash_attention = recorded
    try:
        run = _par_run(tr, batch, steps)
    finally:
        listsf.flash_attention = real
    return {**run, "q_shapes": sorted(shapes), "setup_s": round(setup, 2)}


def _pp_run(mesh, batch, path: str, num_features: int, device: str) -> dict:
    """Phase 12 (e) on one rank (one stage): a pp_stages=2 flagship trainer
    from the checkpoint at `path`: predict (with the launches it takes on
    this stage) and evaluate through the pipeline."""
    import torch

    t0 = time.perf_counter()
    tr = flagship_ranker(dropout=0.0, compute_dtype=PAR_GLOO_DTYPE, num_features=num_features,
                         mesh=mesh, device=device, pp_stages=2).load(path)
    setup = time.perf_counter() - t0
    reset_counts()
    scores = tr.predict(batch)
    if device == "cuda":
        torch.cuda.synchronize()
    counts = read_counts()
    ndcg = tr.evaluate([batch], ks=(1, 5))["nDCG"].tolist()
    return {"scores": scores.cpu().numpy(), "ndcg": ndcg, "predict_launches": counts,
            "setup_s": round(setup, 2), "run_s": round(time.perf_counter() - t0 - setup, 2)}


def ep_inputs(device: str):
    """Phase 12 (f)'s batch: PAR_EP_B queries of PAR_EP_N docs at DIV_D, the
    first list cut to 10 docs; and the cluster's config."""
    import torch

    from ptranking_tpu_torch.diversification.scorers import DivScorerConfig

    gen = torch.Generator(device="cpu").manual_seed(7)
    q = torch.randn(PAR_EP_B, DIV_D, generator=gen)
    d = torch.randn(PAR_EP_B, PAR_EP_N, DIV_D, generator=gen)
    m = torch.ones(PAR_EP_B, PAR_EP_N, dtype=torch.bool)
    m[0, 10:] = False
    cfg = DivScorerConfig(sf_id="pointsf", num_features=DIV_D, K=PAR_EP_K, cluster=True)
    return cfg, q.to(device), d.to(device), m.to(device)


def _ep_run(mesh, device: str) -> dict:
    """Phase 12 (f) on one rank: the cluster's div_forward with this rank's
    experts (expert_param_sharding), their outputs gathered over `model`."""
    import torch

    from ptranking_tpu_torch import LTR_SEED
    from ptranking_tpu_torch.diversification.scorers import div_forward, init_div_scorer
    from ptranking_tpu_torch.parallel import expert_param_sharding, model_parallel

    cfg, q, d, m = ep_inputs(device)
    full = init_div_scorer(cfg, LTR_SEED, device)
    ep = model_parallel(mesh, expert_param_sharding(mesh, full))
    local = ep.shard(full)
    with torch.inference_mode():
        mus, vars_, _ = div_forward(local, cfg, q, d, m, ep=ep)
    return {"mus": mus.cpu().numpy(), "vars": vars_.cpu().numpy(),
            "experts": int(local["point_sf"]["layers"][0]["linear"]["w"].shape[0])}


def zoo_inputs(device: str, B: int, N: int):
    """(h)'s zoo batch: B lists of N docs, ragged (the last all padding),
    labels in the ideal order (the trainer presorts), scores from a seed."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(23)
    lengths = torch.linspace(N, 20, B - 1).round().long().tolist() + [0]
    mask = torch.arange(N)[None, :] < torch.tensor(lengths)[:, None]
    labels = torch.sort(torch.randint(0, 5, (B, N), generator=gen).float(), dim=1,
                        descending=True).values
    scores = torch.randn(B, N, generator=gen)
    return (scores.to(device), torch.where(mask, labels, 0.0).to(device), mask.to(device))


def cp_zoo_rank(mesh, device: str, B: int, N: int) -> dict:
    """(h)'s zoo on one rank: each CP_ZOO loss through the DistributedTrainer's
    CP routing (`_cp_loss`) on the rank's block of the zoo batch's scores:
    the rank's loss, its block's score gradient and where the block sits."""
    from ptranking_tpu_torch.models import ScorerConfig
    from ptranking_tpu_torch.parallel import DistributedTrainer

    scores, labels, mask = zoo_inputs(device, B, N)
    cfg = ScorerConfig(sf_id="pointsf", num_features=8)
    out = {}
    for model_id, paras in CP_ZOO:
        tr = DistributedTrainer(model_id, cfg, mesh, model_paras=paras, shard_docs=True,
                                device=device)
        seq = tr._cp.seq
        s_l = seq.block(scores, 1).detach().clone().requires_grad_(True)
        loss = tr._cp_loss(s_l, labels, mask)
        loss.backward()
        out[f"{model_id}{sorted(paras.items())}"] = {
            "loss": float(loss.detach()), "grad": s_l.grad.cpu().numpy(),
            "docs": [seq.index * s_l.shape[1], (seq.index + 1) * s_l.shape[1]]}
    return out


# (h)'s trainer runs take RankNet, whose pair loss follows the given order:
# its gradients do not turn on near-tied scores at init, as LambdaRank's do
# ((g)'s note); the ring losses of the sorted order are the zoo's
PAR_CP_MODEL = "RankNet"


def cp_attention_inputs(device: str, B: int, N: int, d: int):
    """(h)'s attention check: q, k, v [B, 2, N, d] from a seed, a ragged
    mask (the last list 20 docs)."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(29)
    q, k, v = (torch.randn(B, 2, N, d, generator=gen) for _ in range(3))
    mask = torch.ones(B, N, dtype=torch.bool)
    mask[-1, 20:] = False
    return [t.to(device) for t in (q, k, v, mask)]


def cp_attention_rank(mesh, device: str, B: int, N: int, d: int) -> dict:
    """(h) on one rank: ring and Ulysses attention on the rank's block of
    the docs, the output and the q, k, v gradients of sum(out^2 over real
    queries), and where the block sits."""
    from ptranking_tpu_torch.parallel import cp_plan
    from ptranking_tpu_torch.parallel.ring import ring_attention, ulysses_attention

    out = {}
    for impl, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        cp = cp_plan(mesh, impl)
        q, k, v, mask = cp_attention_inputs(device, B, N, d)
        q, k, v = (cp.seq.block(t, 2).clone().requires_grad_(True) for t in (q, k, v))
        m = cp.seq.block(mask, 1, False)
        o = fn(q, k, v, m, cp)
        (o.square() * m[:, None, :, None]).sum().backward()
        out[impl] = {"out": o.detach().cpu().numpy(),
                     "grads": [t.grad.cpu().numpy() for t in (q, k, v)],
                     "docs": [cp.seq.index * m.shape[1], (cp.seq.index + 1) * m.shape[1]]}
    return out


def cp_attention_check(out, device: str) -> dict:
    """(h)'s attention check: the two ranks' blocks joined against one
    device's reference_attention and autograd through it, at PAR_CP_ATT_*."""
    import numpy as np

    from ptranking_tpu_torch.parallel.ring import reference_attention

    q, k, v, mask = cp_attention_inputs(device, 2 * PAR_GLOO_B, TRAIN_N, NUM_FEATURES // 2)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    ref = reference_attention(q, k, v, mask)
    (ref.square() * mask[:, None, :, None]).sum().backward()
    want = [ref.detach().cpu().numpy()] + [t.grad.cpu().numpy() for t in (q, k, v)]
    rec = {}
    for impl in ("ring", "ulysses"):
        got = [np.zeros_like(w) for w in want]
        for r in out:
            d0, d1 = r["att"][impl]["docs"]
            for full, part in zip(got, [r["att"][impl]["out"]] + r["att"][impl]["grads"]):
                full[:, :, d0:d1] = part
        out_err = float(np.abs(got[0] - want[0]).max())
        over = [float((np.abs(g - w) / (PAR_CP_ATT_GRAD_ATOL + PAR_CP_ATT_GRAD_RTOL * np.abs(w)))
                      .max()) for g, w in zip(got[1:], want[1:])]
        rec[impl] = {"out_max_abs_err": out_err, "qkv_grad_err_over_bar": over}
        if not (out_err <= PAR_CP_ATT_ATOL and max(over) <= 1.0):
            raise AssertionError(f"parallel (h) {impl} attention: {rec[impl]}")
    return rec


def _cp_run(mesh, batch, steps: int, impl: str, num_features: int, device: str) -> dict:
    """(h) on one rank: `_par_run` of the flagship (fp32, dropout 0, under
    PAR_CP_MODEL) as a DistributedTrainer(shard_docs=True, cp_impl=impl) on
    the seq mesh."""
    t0 = time.perf_counter()
    tr = flagship_ranker(dropout=0.0, compute_dtype=PAR_GLOO_DTYPE, num_features=num_features,
                         model_id=PAR_CP_MODEL, mesh=mesh, device=device, shard_docs=True,
                         cp_impl=impl)
    setup = time.perf_counter() - t0
    return {**_par_run(tr, batch, steps), "route": tr._cp.seq.route,
            "setup_s": round(setup, 2)}


def one_rank_cp(mesh, batch, device: str):
    """Phase 12 (g): the flagship as a one-rank DistributedTrainer(shard_docs=
    True) on the one-rank mesh ({seq: 1}: the ring of one block, the ring
    loss over the whole pair space), fp32, against the AdhocRanker with its
    kernels: the first loss and the initial nDCG at PAR_CP_*, PAR_STEPS
    LambdaRank steps with no launch of B1, B2 or B3 (the AdhocRanker
    launches its own), the first step's gradients under LambdaRank and
    RankNet at GRAD_TOL (beside the AdhocRanker's dense path: dense
    attention, the dense loss); the same in bf16, reported. Returns
    (record, the CP path's launch counts)."""
    import numpy as np

    names = None
    runs = {}
    for dtype, model_id, name, m, kw in (
            (PAR_GLOO_DTYPE, "LambdaRank", "cp", mesh, {"shard_docs": True}),
            (PAR_GLOO_DTYPE, "LambdaRank", "kernels", None, {}),
            (PAR_GLOO_DTYPE, "LambdaRank", "dense", None, {"kernels": False}),
            (PAR_GLOO_DTYPE, "RankNet", "cp", mesh, {"shard_docs": True}),
            (PAR_GLOO_DTYPE, "RankNet", "kernels", None, {}),
            ("bfloat16", "LambdaRank", "cp", mesh, {"shard_docs": True}),
            ("bfloat16", "LambdaRank", "kernels", None, {})):
        steps = PAR_STEPS if (dtype, model_id) == (PAR_GLOO_DTYPE, "LambdaRank") else 0
        ranker = flagship_ranker(dropout=0.0, compute_dtype=dtype, num_features=NUM_FEATURES,
                                 model_id=model_id, mesh=m, device=device, **kw)
        names = names or leaf_names(ranker.params)
        runs[name, model_id, dtype] = _par_run(ranker, batch, steps)
        del ranker
    cp, ker, dense = (runs[n, "LambdaRank", PAR_GLOO_DTYPE] for n in ("cp", "kernels", "dense"))
    loss_err = abs(cp["loss"] - ker["loss"]) / abs(ker["loss"])
    grad = rel_errs(runs["cp", "RankNet", PAR_GLOO_DTYPE]["grads"],
                    runs["kernels", "RankNet", PAR_GLOO_DTYPE]["grads"], names)
    lambda_grad = rel_errs(cp["grads"], ker["grads"], names)
    ndcg_err = float(np.abs(np.asarray(cp["ndcg"]) - ker["ndcg"]).max())
    b16, k16 = runs["cp", "LambdaRank", "bfloat16"], runs["kernels", "LambdaRank", "bfloat16"]
    rec = {"steps": PAR_STEPS, "first_loss_rel_err": loss_err, "first_grads_ranknet": grad,
           "first_grads_lambdarank": lambda_grad,
           "lambdarank_vs_dense_path": rel_errs(cp["grads"], dense["grads"], names),
           "kernels_vs_dense_path": rel_errs(ker["grads"], dense["grads"], names),
           "ndcg_abs_err": ndcg_err, "losses": cp["losses"], "adhoc_losses": ker["losses"],
           "launches": cp["launches"], "adhoc_launches": ker["launches"],
           "run_s": {"cp": round(cp["run_s"], 2), "adhoc": round(ker["run_s"], 2),
                     "dense": round(dense["run_s"], 2)},
           "bf16": {"first_loss_rel_err": abs(b16["loss"] - k16["loss"]) / abs(k16["loss"]),
                    "first_grads": rel_errs(b16["grads"], k16["grads"], names),
                    "ndcg_abs_err": float(np.abs(np.asarray(b16["ndcg"]) - k16["ndcg"]).max())}}
    cuda = device == "cuda"
    idle = [k for k in CP_IDLE_KERNELS if cp["launches"].get(k, 0)]
    if cuda:
        check_counts(ker["launches"], PAR_STEPS, "parallel (g) the AdhocRanker")
    if not (loss_err <= PAR_CP_LOSS_RTOL and grad["worst"][1] <= GRAD_TOL
            and lambda_grad["worst"][1] <= GRAD_TOL and ndcg_err <= PAR_CP_NDCG_ATOL
            and not idle):
        raise AssertionError(f"parallel (g): {rec}")
    return rec, cp["launches"]


def par_gloo_rank(steps: int, rows: int, n_docs: int, num_features: int, device: str,
                  work_dir: str, zoo_rows: int):
    """Phase 12 (c) to (f) and (h), one rank of the gloo group. (c):
    `_par_run` of the flagship as a DistributedTrainer on this rank's block
    of a global batch of 2 * rows lists of n_docs docs (its set-up seconds:
    the batch, the mesh, the ranker), then rank 0 saves its params for (e).
    Then on a second mesh of the same group, {model: 2}: (d) the flagship
    with tp=True on the whole batch in fp32 and one bf16 step, (e)
    pp_stages=2 predict and evaluate, (f) the expert-sharded cluster; on a
    third, {seq: 2}: (h) the flagship with shard_docs=True under ring and
    Ulysses attention on the whole batch (each rank half the docs), and the
    CP loss zoo."""
    t = [time.perf_counter()]
    from ptranking_tpu_torch.parallel import MeshConfig, make_mesh

    batch = train_batch(2 * rows, n_docs, ragged=False, seed=5, num_features=num_features)
    t.append(time.perf_counter())
    mesh = make_mesh()
    t.append(time.perf_counter())
    tr = flagship_ranker(dropout=0.0, compute_dtype=PAR_GLOO_DTYPE, num_features=num_features,
                         mesh=mesh, device=device)
    t.append(time.perf_counter())
    out = {"dp": {**_par_run(tr, batch, steps),
                  "setup_s": [round(b - a, 2) for a, b in zip(t, t[1:])]}}
    tr.save(os.path.join(work_dir, PAR_CKPT))
    t0 = time.perf_counter()
    model_mesh = make_mesh(MeshConfig(model=2))
    out["model_mesh_s"] = round(time.perf_counter() - t0, 2)
    out["tp"] = _tp_run(model_mesh, batch, steps, PAR_GLOO_DTYPE, num_features, device)
    out["tp_bf16"] = _tp_run(model_mesh, batch, 0, "bfloat16", num_features, device)
    out["pp"] = _pp_run(model_mesh, batch, os.path.join(work_dir, PAR_CKPT), num_features,
                        device)
    t0 = time.perf_counter()
    out["ep"] = {**_ep_run(model_mesh, device), "run_s": round(time.perf_counter() - t0, 2)}
    # (h) context parallelism on a third mesh of the group, {seq: 2}
    t0 = time.perf_counter()
    seq_mesh = make_mesh(MeshConfig(seq=2))
    out["seq_mesh_s"] = round(time.perf_counter() - t0, 2)
    out["cp"] = {impl: _cp_run(seq_mesh, batch, steps, impl, num_features, device)
                 for impl in ("ring", "ulysses")}
    t0 = time.perf_counter()
    out["zoo"] = cp_zoo_rank(seq_mesh, device, zoo_rows, n_docs)
    out["att"] = cp_attention_rank(seq_mesh, device, 2 * rows, n_docs, num_features // 2)
    out["zoo_s"] = round(time.perf_counter() - t0, 2)
    return out


def write_par_cli_config(root: str, dir_output: str) -> str:
    """Data_Eval_ScoringFunction.json of phase 12 (b): SyntheticMQ, a
    pointsf with BN (its statistics an all-reduce under the mesh), training
    batches of PAR_CLI_BATCH_DOCS docs. Returns the directory."""
    os.makedirs(root, exist_ok=True)
    cfg = {"DataSetting": {"data_id": "SyntheticMQ", "dir_data": None, "min_docs": [5],
                           "min_rele": [1], "binary_rele": [False], "unknown_as_zero": [False],
                           "tr_batch_size": [PAR_CLI_BATCH_DOCS]},
           "EvalSetting": {"dir_output": dir_output, "epochs": 2, "do_validation": True,
                           "vali_k": 5, "vali_metric": "nDCG", "cutoffs": [1, 3, 5, 10],
                           "loss_guided": False, "do_log": False, "log_step": 1,
                           "do_summary": False, "mask": {"mask_label": False}},
           "SFParameter": {"sf_id": "pointsf", "opt": ["Adam"], "lr": [1e-3],
                           "pointsf": {"BN": [True], "bn_type": ["BN"], "bn_affine": [True],
                                       "layers": [2], "AF": ["R"], "TL_AF": ["S"],
                                       "apply_tl_af": [False]}}}
    with open(os.path.join(root, "Data_Eval_ScoringFunction.json"), "w") as f:
        json.dump(cfg, f)
    return root


def parallel_phase(card: str, work_dir: str, device: str = "cuda") -> dict:
    """Phase 12: (a) a one-rank NCCL DistributedTrainer against the
    AdhocRanker, (a') the same with tp=True and with pp_stages=1 (a model
    axis of 1), (b) `ltr.main -mesh data=1` against the run without it, and
    on two gloo ranks on the one card, in one spawn: (c) DP, (d) TP, (e) PP
    against one device, (f) the expert-sharded cluster, (h) CP (ring and
    Ulysses, and the loss zoo); (g) CP on the one-rank mesh against the
    AdhocRanker. Returns the launch counts of the phase's main paths: (a)'s
    DP runs, (d)'s TP steps and (e)'s pipeline predict on rank 0, and the
    CP paths' of (g) and (h) (rank 0)."""
    import numpy as np
    import torch

    from ptranking_tpu_torch import ltr
    from ptranking_tpu_torch.diversification.scorers import div_forward, init_div_scorer
    from ptranking_tpu_torch.parallel import make_mesh
    from ptranking_tpu_torch.parallel.launch import one_rank_group, run_ranks
    from ptranking_tpu_torch.parallel.pipeline import microbatches

    t = [time.perf_counter()]
    rec = {}
    cuda = device == "cuda"
    batch = train_batch(TRAIN_B, TRAIN_N, ragged=False, seed=2, num_features=NUM_FEATURES)
    dp_counts = {}
    sub_s = {}  # (a)'s seconds by part
    with one_rank_group(device):  # NCCL on the card
        mesh = make_mesh()
        sub_s["group_and_mesh"] = time.perf_counter() - t[0]
        for model_id, steps, per_step in (("LambdaRank", PAR_STEPS, LAUNCHES_PER_STEP),
                                          ("WassRank", PAR_WASS_STEPS, WASS_LAUNCHES_PER_STEP)):
            runs = {}
            for name, m in (("single", None), ("dp", mesh)):
                t0 = time.perf_counter()
                ranker = flagship_ranker(dropout=0.0, model_id=model_id,
                                         num_features=NUM_FEATURES, mesh=m, device=device)
                t1 = time.perf_counter()
                reset_counts()
                losses = _par_steps(ranker, batch, steps)
                if cuda:
                    torch.cuda.synchronize()
                runs[name] = (ranker, losses, read_counts())
                sub_s[f"{model_id}_{name}"] = [round(t1 - t0, 2),
                                               round(time.perf_counter() - t1, 2)]
            (single, l1, c1), (dp, l2, c2) = runs["single"], runs["dp"]
            p1, p2 = _named_params(single.params), _named_params(dp.params)
            same = l1 == l2 and all(np.array_equal(p1[k], p2[k]) for k in p1)
            diff = max(float(np.abs(p1[k] - p2[k]).max()) for k in p1)
            rec[f"one_rank_{model_id}"] = {"steps": steps, "losses": l2, "same_bits": same,
                                          "max_abs_param_diff": diff, "launches": c2}
            if not same:
                raise AssertionError(f"parallel (a) {model_id}: the one-rank DistributedTrainer "
                                     f"parts from the AdhocRanker: {rec[f'one_rank_{model_id}']}")
            if cuda:
                check_counts(c2, steps, f"parallel (a) {model_id}", per_step)
                if c1 != c2:
                    raise AssertionError(f"parallel (a) {model_id}: launches {c2} on the DP "
                                         f"path, {c1} on one device")
            for k, n in c2.items():
                dp_counts[k] = dp_counts.get(k, 0) + n
            del runs, single, dp
        t.append(time.perf_counter())

        # (a') tp=True and pp_stages=1 on the one-rank mesh (model = 1)
        # against the AdhocRanker from the same seed: steps, then a predict
        for name, parallel in (("tp", {"tp": True}), ("pp_stages_1", {"pp_stages": 1})):
            got = {}
            for which, m, kw in (("single", None, {}), (name, mesh, parallel)):
                ranker = flagship_ranker(dropout=0.0, num_features=NUM_FEATURES, mesh=m,
                                         device=device, **kw)
                reset_counts()
                losses = _par_steps(ranker, batch, PAR_STEPS)
                scores = ranker.predict(batch)
                if cuda:
                    torch.cuda.synchronize()
                got[which] = (losses, _named_params(ranker.params), scores.cpu().numpy(),
                              read_counts())
                del ranker
            (l1, p1, s1, c1), (l2, p2, s2, c2) = got["single"], got[name]
            same = (l1 == l2 and all(np.array_equal(p1[k], p2[k]) for k in p1)
                    and np.array_equal(s1, s2))
            rec[f"one_rank_{name}"] = {"steps": PAR_STEPS, "same_bits": same, "launches": c2}
            if not (same and c1 == c2):
                raise AssertionError(f"parallel (a') {name}: same bits {same}, launches {c2} "
                                     f"against the AdhocRanker's {c1}")
        t.append(time.perf_counter())
        rec["one_rank_cp"], cp_counts = one_rank_cp(mesh, batch, device)
    rec["one_rank_s"] = sub_s
    t.append(time.perf_counter())

    # (b) the CLI under -mesh data=1 (a one-rank NCCL group) against the plain
    # run: RankMSE's debug grid (2 folds x 5 epochs) of write_par_cli_config
    cli = {}
    for name, extra in (("plain", []), ("mesh", ["-mesh", "data=1"])):
        dj = write_par_cli_config(os.path.join(work_dir, "par_cli", name + "_json"),
                                  os.path.join(work_dir, "par_cli", name))
        cli[name] = ltr.main(["-model", "RankMSE", "-dir_json", dj, "-debug",
                              "-device", device] + extra)
    metrics = [k for k in cli["plain"] if k != "elapsed_s"]
    same = all(np.array_equal(cli["plain"][k], cli["mesh"][k]) for k in metrics)
    rec["cli_mesh_data1"] = {"nDCG": np.asarray(cli["mesh"]["nDCG"]).tolist(), "same_bits": same}
    if not same:
        raise AssertionError(f"parallel (b): -mesh data=1 gives {cli['mesh']}, the plain run "
                             f"{cli['plain']}")
    t.append(time.perf_counter())

    # (c) to (f): two gloo ranks on the one card, against one device on the
    # global batch
    print("parallel (c)-(f) show the reduction, tensor-parallel, pipeline and expert paths "
          "with the kernels on the card, not multi-GPU scaling: one H100 cannot show "
          "scaling; gloo carries these CUDA tensors' collectives through host memory itself "
          "(its CUDA work copies each to the host and back), where NCCL across cards would "
          "not", flush=True)
    out = run_ranks(par_gloo_rank, 2,
                    (PAR_GLOO_STEPS, PAR_GLOO_B, TRAIN_N, NUM_FEATURES, device, work_dir,
                     PAR_ZOO_B),
                    device_type=device, backend="gloo", timeout_s=PAR_TIMEOUT_S,
                    join_timeout_s=PAR_TIMEOUT_S)
    t.append(time.perf_counter())
    gbatch = train_batch(2 * PAR_GLOO_B, TRAIN_N, ragged=False, seed=5,
                         num_features=NUM_FEATURES)
    ref = _par_run(flagship_ranker(dropout=0.0, compute_dtype=PAR_GLOO_DTYPE,
                                   num_features=NUM_FEATURES, device=device),
                   gbatch, PAR_GLOO_STEPS)
    names = list(ref["params"])
    r0, r1 = (r["dp"] for r in out)
    ranks_same = (r0["losses"] == r1["losses"]
                  and all(np.array_equal(r0["params"][k], r1["params"][k]) for k in names))
    grad = rel_errs(r0["grads"], ref["grads"], names)
    loss_err = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
    ndcg_err = float(np.abs(np.asarray(r0["ndcg"]) - ref["ndcg"]).max())
    rec["two_gloo_ranks_one_card"] = {
        "note": "the reduction path with the kernels on the card, not multi-GPU scaling",
        "rows_a_rank": PAR_GLOO_B, "first_loss_rel_err": loss_err, "first_grads": grad,
        "ndcg_abs_err": ndcg_err, "steps": PAR_GLOO_STEPS, "losses": r0["losses"],
        "one_device_losses": ref["losses"], "ranks_same_bits": ranks_same,
        "max_abs_param_diff_vs_one_device": max(
            (float(np.abs(r0["params"][k] - ref["params"][k]).max()), k) for k in names),
        "rank0_launches": r0["launches"],
        "rank_setup_run_s": [[r["dp"]["setup_s"], round(r["dp"]["run_s"], 2)] for r in out],
        "one_device_run_s": round(ref["run_s"], 2)}
    if not (ranks_same and loss_err <= PAR_LOSS_RTOL and ndcg_err <= PAR_NDCG_ATOL
            and grad["worst"][1] <= PAR_GRAD_RTOL):
        raise AssertionError(f"parallel (c): {rec['two_gloo_ranks_one_card']}")

    # (d) TP: each rank one head, the same global batch, against one device
    d0, d1 = (r["tp"] for r in out)
    d_head = NUM_FEATURES // 2
    want_q = [(2 * PAR_GLOO_B, 1, TRAIN_N, d_head)]
    tp_same = (d0["losses"] == d1["losses"]
               and all(np.array_equal(d0["params"][k], d1["params"][k]) for k in names))
    tp_grad = rel_errs(d0["grads"], ref["grads"], names)
    tp_loss_err = abs(d0["loss"] - ref["loss"]) / abs(ref["loss"])
    tp_ndcg_err = float(np.abs(np.asarray(d0["ndcg"]) - ref["ndcg"]).max())
    ref16 = _par_run(flagship_ranker(dropout=0.0, compute_dtype="bfloat16",
                                     num_features=NUM_FEATURES, device=device), gbatch, 0)
    b16 = out[0]["tp_bf16"]
    bf16_loss_err = abs(b16["loss"] - ref16["loss"]) / abs(ref16["loss"])
    rec["tp_two_gloo_ranks"] = {
        "first_loss_rel_err": tp_loss_err, "first_grads_joined": tp_grad,
        "ndcg_abs_err": tp_ndcg_err, "losses": d0["losses"], "one_device_losses": ref["losses"],
        "ranks_same_bits": tp_same, "q_shapes": [r["tp"]["q_shapes"] for r in out],
        "launches": [r["tp"]["launches"] for r in out], "one_device_launches": ref["launches"],
        "max_abs_param_diff_vs_one_device": max(
            (float(np.abs(d0["params"][k] - ref["params"][k]).max()), k) for k in names),
        "bf16": {"first_loss_rel_err": bf16_loss_err,
                 "first_grads_joined": rel_errs(b16["grads"], ref16["grads"], names),
                 "ndcg_abs_err": float(np.abs(np.asarray(b16["ndcg"]) - ref16["ndcg"]).max())},
        "rank_setup_run_s": [[r["tp"]["setup_s"], round(r["tp"]["run_s"], 2)] for r in out],
        "model_mesh_s": [r["model_mesh_s"] for r in out]}
    print(f"parallel (d) TP: rank q shapes {rec['tp_two_gloo_ranks']['q_shapes']} "
          f"(each rank one head of {d_head})", flush=True)
    if not (tp_same and tp_loss_err <= PAR_LOSS_RTOL and tp_ndcg_err <= PAR_NDCG_ATOL
            and tp_grad["worst"][1] <= PAR_GRAD_RTOL and bf16_loss_err <= PAR_BF16_FWD_RTOL
            and all(r["tp"]["q_shapes"] == want_q for r in out)
            and (not cuda or all(r["tp"]["launches"] == ref["launches"] for r in out))):
        raise AssertionError(f"parallel (d): {rec['tp_two_gloo_ranks']}")

    # (e) PP: the checkpoint (c) saved, predicted and evaluated through a
    # two-stage pipeline against one device
    single = flagship_ranker(dropout=0.0, compute_dtype=PAR_GLOO_DTYPE,
                             num_features=NUM_FEATURES, device=device)
    single.load(os.path.join(work_dir, PAR_CKPT))
    want_scores = single.predict(gbatch).cpu().numpy()
    want_ndcg = single.evaluate([gbatch], ks=(1, 5))["nDCG"]
    mask = np.asarray(gbatch.mask)
    n_mb = microbatches(2 * PAR_GLOO_B, PAR_PP_MICROBATCHES)
    # a predict through the pipeline: each stage's 3 layers on each microbatch
    want_pp = {k: 0 for k in ref["launches"]}
    want_pp["flash_attn_fwd"] = (6 // 2) * n_mb
    pp_err = max(float(np.abs(r["pp"]["scores"][mask] - want_scores[mask]).max()) for r in out)
    pp_ndcg_err = max(float(np.abs(np.asarray(r["pp"]["ndcg"]) - want_ndcg).max()) for r in out)
    rec["pp_two_gloo_ranks"] = {
        "microbatches": n_mb, "max_abs_score_err": pp_err, "ndcg_abs_err": pp_ndcg_err,
        "predict_launches_by_stage": [r["pp"]["predict_launches"] for r in out],
        "expected_flash_attn_fwd_a_stage": want_pp["flash_attn_fwd"],
        "rank_setup_run_s": [[r["pp"]["setup_s"], r["pp"]["run_s"]] for r in out]}
    if not (pp_err <= PAR_PP_ATOL and pp_ndcg_err <= PAR_NDCG_ATOL
            and (not cuda or all(r["pp"]["predict_launches"] == want_pp for r in out))):
        raise AssertionError(f"parallel (e): {rec['pp_two_gloo_ranks']}")

    # (f) EP: the K-expert cluster, two experts a rank, against one device
    cfg, q, d, m = ep_inputs(device)
    from ptranking_tpu_torch import LTR_SEED

    with torch.inference_mode():
        mus, vars_, _ = div_forward(init_div_scorer(cfg, LTR_SEED, device), cfg, q, d, m)
    mus, vars_ = mus.cpu().numpy(), vars_.cpu().numpy()
    mus_err = max(float(np.abs(r["ep"]["mus"] - mus).max()) for r in out)
    vars_ok = all(np.allclose(r["ep"]["vars"], vars_, rtol=PAR_EP_VARS_RTOL,
                              atol=PAR_EP_VARS_ATOL) for r in out)
    rec["ep_two_gloo_ranks"] = {
        "experts_a_rank": [r["ep"]["experts"] for r in out], "mus_abs_err": mus_err,
        "vars_max_rel_err": max(float((np.abs(r["ep"]["vars"] - vars_)
                                       / np.maximum(np.abs(vars_), 1e-30)).max()) for r in out),
        "vars_within_bar": vars_ok, "run_s": [r["ep"]["run_s"] for r in out]}
    if not (mus_err <= PAR_EP_MUS_ATOL and vars_ok
            and all(r["ep"]["experts"] == PAR_EP_K // 2 for r in out)):
        raise AssertionError(f"parallel (f): {rec['ep_two_gloo_ranks']}")

    # (h) CP on {seq: 2}: ring and Ulysses under PAR_CP_MODEL against one
    # device's dense path (dense attention and the dense loss: the CP path's
    # formulas on whole lists), fp32, and the loss zoo against the dense
    # losses
    dense = _par_run(flagship_ranker(dropout=0.0, compute_dtype=PAR_GLOO_DTYPE,
                                     model_id=PAR_CP_MODEL, num_features=NUM_FEATURES,
                                     device=device, kernels=False),
                     gbatch, PAR_GLOO_STEPS)
    cp_rec = {"route": out[0]["cp"]["ring"]["route"],
              "seq_mesh_s": [r["seq_mesh_s"] for r in out]}
    for impl in ("ring", "ulysses"):
        h0, h1 = (r["cp"][impl] for r in out)
        same = (h0["losses"] == h1["losses"]
                and all(np.array_equal(h0["params"][k], h1["params"][k]) for k in names))
        g = rel_errs(h0["grads"], dense["grads"], names)
        l_err = abs(h0["loss"] - dense["loss"]) / abs(dense["loss"])
        n_err = float(np.abs(np.asarray(h0["ndcg"]) - dense["ndcg"]).max())
        cp_rec[impl] = {"first_loss_rel_err": l_err, "first_grads": g, "ndcg_abs_err": n_err,
                        "losses": h0["losses"], "one_device_losses": dense["losses"],
                        "ranks_same_bits": same, "launches": [r["cp"][impl]["launches"]
                                                              for r in out],
                        "rank_setup_run_s": [[r["cp"][impl]["setup_s"],
                                              round(r["cp"][impl]["run_s"], 2)] for r in out]}
        idle = [k for r in out for k in CP_IDLE_KERNELS if r["cp"][impl]["launches"].get(k, 0)]
        if not (same and l_err <= PAR_LOSS_RTOL and n_err <= PAR_NDCG_ATOL
                and g["worst"][1] <= GRAD_TOL and not idle):
            raise AssertionError(f"parallel (h) {impl}: {cp_rec[impl]}")
    cp_rec["one_device_run_s"] = round(dense["run_s"], 2)
    cp_rec["attention"] = cp_attention_check(out, device)
    cp_rec["zoo"] = cp_zoo_check(out, device)
    cp_rec["zoo_s"] = [r["zoo_s"] for r in out]
    rec["cp_two_gloo_ranks"] = cp_rec
    t.append(time.perf_counter())
    rec["phase_s"] = {n: round(b - a, 1)
                      for n, a, b in zip(("a", "a_prime", "g", "b", "c_to_h_ranks",
                                          "refs_and_gates"), t, t[1:])}
    print("parallel " + json.dumps(rec) + f"  [{card}]", flush=True)
    return {"dp": dp_counts, "tp": d0["launches"], "pp": out[0]["pp"]["predict_launches"],
            "cp_one_rank": cp_counts, "cp_ring": out[0]["cp"]["ring"]["launches"],
            "cp_ulysses": out[0]["cp"]["ulysses"]["launches"]}


def cp_zoo_check(out, device: str) -> dict:
    """(h)'s zoo: the two ranks' losses (each its line's, the same) and
    their blocks' score gradients joined, against the port's one-device dense
    loss of each CP_ZOO entry on the whole batch (the card's kernels where
    the dense loss takes them) and its fp64 evaluation. Returns {loss:
    errors}; raises past the PAR_ZOO_* gates."""
    import numpy as np
    import torch

    from ptranking_tpu_torch.losses import DEFAULT_PARAS, get_loss

    scores, labels, mask = zoo_inputs(device, PAR_ZOO_B, TRAIN_N)

    def dense(model_id, paras, dtype):
        """The dense loss's value and score gradient in `dtype` (fp64: the
        plain Sinkhorn half-step; the kernel takes fp32)."""
        s = scores.detach().to(dtype).clone().requires_grad_(True)
        kw = {**DEFAULT_PARAS[model_id], **paras}
        if dtype == torch.float64 and model_id == "WassRank":
            kw["use_pallas"] = False
        loss = get_loss(model_id)(s, labels.to(dtype), mask, **kw)
        loss.backward()
        return float(loss.detach()), s.grad.double().cpu().numpy()

    def over_bar(a, ref):
        bar = PAR_ZOO_GRAD_ATOL + PAR_ZOO_GRAD_RTOL * np.abs(ref)
        return float((np.abs(a - ref) / bar).max())

    rec, bad = {}, []
    for model_id, paras in CP_ZOO:
        key = f"{model_id}{sorted(paras.items())}"
        v32, g32 = dense(model_id, paras, torch.float32)
        _, g64 = dense(model_id, paras, torch.float64)
        got_g = np.zeros_like(g32)
        for r in out:
            d0, d1 = r["zoo"][key]["docs"]
            got_g[:, d0:d1] = r["zoo"][key]["grad"]
        losses = [r["zoo"][key]["loss"] for r in out]
        v_err = abs(losses[0] - v32) / abs(v32)
        cp64, d64 = over_bar(got_g, g64), over_bar(g32, g64)
        rec[key] = {"loss_rel_err": v_err, "grad_max_abs_err_vs_dense": float(
                        np.abs(got_g - g32).max()),
                    "grad_over_bar_vs_dense": over_bar(got_g, g32),
                    "grad_over_bar_vs_fp64": cp64, "dense_fp32_over_bar_vs_fp64": d64,
                    "ranks_same_loss": losses[0] == losses[1]}
        if not (v_err <= PAR_ZOO_RTOL and cp64 <= max(1.0, 2.0 * d64) and losses[0] == losses[1]
                and np.isfinite(got_g).all()):
            bad.append(key)
    if bad:
        raise AssertionError(f"parallel (h) zoo: {bad} past the bar: {rec}")
    return rec


def main() -> int:
    phase("device")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ptranking_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(ptranking_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    card = card_line()
    print(card, flush=True)

    phase("build")
    from ptranking_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    for log in cuda_build.build(cuda_build.all_kernels()):
        print(ptxas_summary(log), flush=True)
        for name, regs, spill in ptxas_entries(log):
            if spill:
                print(f"  spills: {name} {regs} registers, {spill} bytes", flush=True)
        lib = log.split(":", 1)[0]
        if lib in BUILD_KERNELS:
            check_build(log, BUILD_KERNELS[lib])
    print(f"build_s {time.perf_counter() - t0:.1f}", flush=True)

    phase("kernels")
    flash = check_attention(card)
    records = check_attention_bwd(card)
    for key, name in (((RECORD_SHAPE, "bfloat16"), "flash_attn_fwd"),
                      ((RECORD_SHAPE, "float32"), "flash_attn_fwd_fp32")):
        records[name].update({k: flash[key][k] for k in ("max_abs_err", "plain_ms",
                                                         "library_ms")})
    records.update(check_pairwise(card))
    check_grid_limits(card)
    records.update(check_packed(card))
    records.update(check_packed_fwd(card))
    records.update(check_wide_tf32(card))
    check_big(card)
    records.update(check_sinkstep(card))

    phase("serve")
    work_dir = os.path.join(here, "build", "chip_smoke")
    os.makedirs(work_dir, exist_ok=True)
    serve_phase(card, work_dir)

    phase("train")
    launches, f32_flagship = train_phase(card, work_dir)
    for name in ("flash_attn_fwd", "flash_attn_bwd_dkdv", "flash_attn_bwd_dq"):
        launches[name + "_fp32"] = f32_flagship[name]

    phase("wassrank")
    launches["sinkstep"] = wassrank_phase(card, work_dir)["sinkstep"]

    phase("wide")
    wide, f32_steps, one_head_f32 = wide_phase(card, work_dir)

    phase("resident")
    resident_phase(card, work_dir)

    phase("serving_rest")
    rest = serving_rest_phase(card, work_dir)
    print(f"flash_attn_fwd launches in int8 and artifact serving: "
          f"{rest['flash_attn_fwd']}  [{card}]", flush=True)

    phase("diversification")
    div_phase(card, work_dir)

    phase("adversarial")
    ad_phase(card, work_dir)

    phase("parallel")
    t_par = time.perf_counter()
    par_counts = parallel_phase(card, work_dir)
    print(f"parallel_phase_s {time.perf_counter() - t_par:.1f}", flush=True)
    idle_cp = {path: n for path in ("cp_one_rank", "cp_ring", "cp_ulysses")
               for name, n in par_counts[path].items() if name in CP_IDLE_KERNELS and n}
    if idle_cp:
        raise AssertionError(f"parallel: B1, B2 or B3 launched on the CP path: {idle_cp}")
    for path, names in (("dp", ("flash_attn_fwd", "flash_attn_bwd_dkdv", "flash_attn_bwd_dq",
                                "pairwise_lambda_fwd", "pairwise_lambda_bwd", "sinkstep")),
                        ("tp", ("flash_attn_fwd", "flash_attn_bwd_dkdv", "flash_attn_bwd_dq",
                                "pairwise_lambda_fwd", "pairwise_lambda_bwd")),
                        ("pp", ("flash_attn_fwd",))):
        idle_par = [name for name in names if par_counts[path].get(name, 0) <= 0]
        if idle_par:
            raise AssertionError(f"parallel: kernels never launched on the {path} path: "
                                 f"{idle_par}")
    print("parallel launches by path " + json.dumps(par_counts) + f"  [{card}]", flush=True)
    for name in ("flash_attn_fwd", "flash_attn_bwd_dkdv", "flash_attn_bwd_dq"):
        launches[name + "_wide_fp32"] = one_head_f32[name]
    for name in ("flash_attn_fwd_packed", "flash_attn_fwd_long", "flash_attn_bwd_packed",
                 "flash_attn_bwd_list", "flash_attn_bwd_long"):
        launches[name] = wide[name]
    from ptranking_tpu_torch.ops.attention import F32_PACK_MAX_N

    f32 = {}  # the fp32 steps' launches by kernel
    for N, counts in f32_steps.items():
        for name, n in counts.items():
            if name == "flash_attn_fwd_packed" and N > F32_PACK_MAX_N:
                name = "flash_attn_fwd_list"  # the fp32 list kernel, through the packed wrapper
            f32[name] = f32.get(name, 0) + n
    for name in ("flash_attn_fwd_packed", "flash_attn_fwd_list", "flash_attn_fwd_long",
                 "flash_attn_bwd_packed", "flash_attn_bwd_list", "flash_attn_bwd_long"):
        launches[name + "_fp32"] = f32.get(name, 0)
    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on their path: {idle}")

    sources = {
        "flash_attn_fwd": ("ptranking_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                           "ptranking_tpu/ops/attention.py:129"),
        "flash_attn_bwd_dkdv": ("ptranking_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                                "ptranking_tpu/ops/attention.py:172"),
        "flash_attn_bwd_dq": ("ptranking_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                              "ptranking_tpu/ops/attention.py:172"),
        # the same wrappers in fp32 at d <= 128 (3xTF32): records at
        # RECORD_SHAPE in fp32, launches from phase 5's fp32 timed steps
        "flash_attn_fwd_fp32": ("ptranking_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                                "ptranking_tpu/ops/attention.py:129"),
        "flash_attn_bwd_dkdv_fp32": ("ptranking_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                                     "ptranking_tpu/ops/attention.py:172"),
        "flash_attn_bwd_dq_fp32": ("ptranking_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                                   "ptranking_tpu/ops/attention.py:172"),
        "pairwise_lambda_fwd": ("ptranking_tpu_torch/ops/csrc/pairwise_lambda.cu",
                                "ptranking_tpu/ops/pallas/pairwise.py:60"),
        "pairwise_lambda_bwd": ("ptranking_tpu_torch/ops/csrc/pairwise_lambda.cu",
                                "ptranking_tpu/ops/pallas/pairwise.py:93"),
        "sinkstep": ("ptranking_tpu_torch/ops/csrc/sinkstep.cu",
                     "ptranking_tpu/ops/pallas/sinkhorn.py:26"),
        # the same wrappers in fp32 at d > 128 past F32_LONG_MAX_N docs: the
        # fp32 wide kernels (3xTF32), record at WIDE_F32_RECORD, launches
        # from phase 7's fp32 timed steps of the one-head model at
        # WIDE_F32_STEP: no Yahoo! bucket reaches them
        "flash_attn_fwd_wide_fp32": ("ptranking_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                                "ptranking_tpu/ops/attention.py:129"),
        "flash_attn_bwd_dkdv_wide_fp32": ("ptranking_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                                     "ptranking_tpu/ops/attention.py:172"),
        "flash_attn_bwd_dq_wide_fp32": ("ptranking_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                                   "ptranking_tpu/ops/attention.py:172"),
        # the bf16 backward of lists of at most PACK_MAX_N docs at d > 128
        # (Yahoo!'s buckets up to 64 docs): record at PACK_RECORD, launches
        # from phase 7's timed steps of the d = 350 model
        "flash_attn_bwd_packed": ("ptranking_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                                  "ptranking_tpu/ops/attention.py:172"),
        # the bf16 backward of lists of 65 .. LIST_MAX_N docs at d > 128
        # (Yahoo!'s 128-doc bucket): record at LIST_RECORD
        "flash_attn_bwd_list": ("ptranking_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                                "ptranking_tpu/ops/attention.py:172"),
        # the bf16 forward of lists of at most FWD_PACK_MAX_N docs at d > 128:
        # record at FWD_PACK_RECORD
        "flash_attn_fwd_packed": ("ptranking_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                                  "ptranking_tpu/ops/attention.py:172"),
        # the bf16 forward and backward of lists of FWD_PACK_MAX_N + 1 ..
        # LONG_MAX_N docs at d > 128 (Yahoo!'s 256-doc bucket): record at
        # LONG_RECORD, launches from phase 7's timed steps of the d = 350 model
        "flash_attn_fwd_long": ("ptranking_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                                "ptranking_tpu/ops/attention.py:172"),
        "flash_attn_bwd_long": ("ptranking_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                                "ptranking_tpu/ops/attention.py:172"),
        # the fp32 forward and backward of lists of at most F32_PACK_MAX_N
        # docs at d > 128 (3xTF32; the packed wrappers, which count either
        # dtype): records at FWD_PACK_RECORD and PACK_RECORD in fp32,
        # launches from phase 7's timed fp32 steps of the d = 350 model
        "flash_attn_fwd_packed_fp32": ("ptranking_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                                       "ptranking_tpu/ops/attention.py:172"),
        "flash_attn_bwd_packed_fp32": ("ptranking_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                                       "ptranking_tpu/ops/attention.py:172"),
        # the fp32 backward of lists of 65 .. F32_LIST_MAX_N and of
        # F32_LIST_MAX_N + 1 .. F32_LONG_MAX_N docs at d > 128 (3xTF32; the
        # list and long wrappers, which count either dtype): records at
        # LIST_RECORD and LONG_RECORD in fp32, launches from phase 7's timed
        # fp32 steps at 128 and 256 docs
        "flash_attn_bwd_list_fp32": ("ptranking_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                                     "ptranking_tpu/ops/attention.py:172"),
        "flash_attn_bwd_long_fp32": ("ptranking_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                                     "ptranking_tpu/ops/attention.py:172"),
        # the fp32 forward of lists of F32_PACK_MAX_N + 1 .. F32_FWD_LIST_MAX_N
        # and of F32_FWD_LIST_MAX_N + 1 .. F32_FWD_LONG_MAX_N docs at d > 128
        # (flash_fwd_list_tf32_kernel, 3xTF32; the packed and the long
        # forward's wrappers): records at LIST_RECORD and LONG_RECORD in
        # fp32, launches from phase 7's timed fp32 steps at 128 and 256 docs
        "flash_attn_fwd_list_fp32": ("ptranking_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                                     "ptranking_tpu/ops/attention.py:172"),
        "flash_attn_fwd_long_fp32": ("ptranking_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                                     "ptranking_tpu/ops/attention.py:172"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name],
                **{k: records[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")}}
               for name, (src, rep) in sources.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
