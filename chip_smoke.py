#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs, and stops with a non-zero exit at the first failure:

0. Requires a CUDA device; prints the card's name and power limit;
   builds the kernels of ``qgtc_ppopp22_tpu_torch/csrc`` with nvcc and
   prints ``ptxas -v``'s report; every one of the 72 instantiations of
   K2's 1/2/4-bit kernel (``csrc/packmm_k2.cuh``), of the 30 of K4's
   (``csrc/packmm_k4.cuh``: the PreparedRHS product and K2's 8-bit plane),
   of the 48 of K6's
   (``csrc/bitmm_k6.cuh``), of the 34 of K1's (``csrc/fused_model_k1.cuh``),
   of the 16 of K3's (``csrc/digitmm_k3.cuh``) and of the 2 of K5's
   (``csrc/fused_baseline_k5.cuh``) must spill 0 bytes, and ptxas must
   not serialize K5's wgmmas (warnings C7512, C7520).
1. Each kernel against its plain PyTorch version on the same CUDA
   tensors, at 1/2/4/8 bits, shifts 0 and 2, the slice's shapes
   (pn = 2560, K in {128, 2560}, N in {16, 40}) and one ragged
   multi-tile shape, plus operands built so that the accumulator hits
   every requantize edge (0, 2^b - 1, 2^b, 2^b + 1); and the whole-model
   ``fused_model`` kernel at 1/2/4/8 bits, GCN and GIN, shifts none and
   [1, 2, 1, 2, 1], dense and block-scheduled (chunks of 0, 1, odd and
   all blocks), pn in {512, 2560} with 2 batches. Equality must be
   exact, padded outputs included. Then ``fused_model`` with levels-form
   X (``x_levels_bits``: one plane of byte levels): GCN and GIN, 5 and 8
   bits, the signed chain (hidden 16) and the in-kernel digit split
   (hidden 128), feature widths 100 and 128, dense, block-scheduled and
   ``chunk_occ``, shifts none and [1, 2, 1, 2, 1], at pn 512 and 2560;
   ``clamp_bits`` 4 under 8-bit levels; 3 batches at pn 768; each equal
   to plain and to the 2-digit route's launch on the same levels, and
   each one levels-form launch. Then K1 under every forced plan
   (``torch_cases.k1_groups``): the chosen plan, 64- and 128-row CTAs,
   each stage depth on a ring of 3 and a 2-CTA cluster, at C1's shape (pn
   2560, 2 batches) and pn 768 with 3 batches, GCN hidden 16 and GIN
   hidden 64, every form of X (digit planes at 2 and 8 bits, levels at 8
   bits in the signed and split forms, levels at 1 and 2 bits signed and
   at 1, 2 and 4 bits split, 3-bit levels with every higher bit of each
   byte set), feature widths 100 and 128, dense, a schedule that leaves
   out occupied blocks and
   ``chunk_occ``, shifts from ``chain_shifts``; each output twice, both
   equal to plain. Then the bf16 baseline kernel
   ``fused_baseline`` (sage hidden 16 and gin hidden 64, 1 and 3 layers,
   pn in {512, 2560}, 2 batches): equal to plain bit for bit on the
   "integer" case (nothing rounds) and the "rounding" case (every cast
   rounds, every sum exact), and within max |kernel - plain| <= 2^-6 max
   |plain| per row of logits on random 0/1 adjacency at arxiv density
   plus a few dense rows. Then K5 under every forced plan
   (``torch_cases.k5_groups``: the chosen plan and one and two batches
   in flight; pn 512, 768 and 2560, sage hidden 16 and gin hidden 64, 1, 2, 3 and 8 layers, 2, 3
   and 5 batches, X 200 wide at ragged widths): "integer" and "rounding"
   bit for bit, "random" within 2^-6 per row, each output twice, equal.
   Then K3 under every forced plan (``torch_cases.k3_groups``: C1's three
   updates, N 16-200, K 16-700, 1 and 2 digit planes,
   ``build_tile_map_digits``'s and hand-made maps; column tiles 16 and 32,
   rows 16, 32, 64; digits, f32 and i32 out): the whole padded output bit for bit,
   each output twice. Then the one-bit tensor-core kernel ``bitmm``
   against ``bitmm_plain``, word for word: (a_bits, b_bits) in (1,1),
   (1,2), (2,2), (3,5), (4,4), (8,8), (1,8), each to 1/2/4/8-bit planes
   and to float32, at C1's aggregation (A[2560x2560] x H[2560x16]) and
   first update (X[2560x128] x W[128x16]) and the ragged M=300, K=520,
   N=40; operands that put the accumulator at 0, 2^b - 1, 2^b and
   2^b + 1; and with a TileMap: block-diagonal A with empty tiles and a
   row tile of kcnt 0 (equal to dense), and a hand-made map that omits
   occupied tiles (equal to plain's masked product, not to dense). Then
   K6 under every forced plan (``torch_cases.k6_groups``): column tiles
   16, 32 and 64 x splits 1-4, to bits and to f32, at C1's six GEMMs, N 40
   and 64, GIN's hidden update, the ragged 300 x 520 x 40 at every plane
   pair the kernel instantiates and at 3 x 5, maps (the builder's and
   hand-made ones) on C1's aggregation and a ragged 2300 x 520 x 40, and
   8 x 8 planes at 255 with K 33280 (sums past 2^31); each output twice,
   both equal to plain.
   Then the PreparedRHS kernel ``packmm_signed`` against
   ``packmm_signed_plain``, whole outputs padding included: f32, i32,
   digits (2/4/8 bits, shifts 0 and 2), the signed byte plane (8 bits,
   out_cols none and N) and low-bit packed words (1/2/4 bits, out_cols N)
   at M=700 K=300 N in {60, 120} (ragged; 120 is the last free lane),
   Fig. 8a's (1024, 1024, 16) and (4096, 4096, 64), A at level 0 or 255
   against B at 255, and M=256 K=32640 N=16 at 255 throughout (the
   largest K the int32 guard accepts); and ``packmm``'s packed-words
   epilogue: A at 1/2/4/8 bits x B at 1/2/4/8 bits to 1/2/4/8-bit packed
   out (8: the signed plane), out_cols none and N, at C1's (2560, 2560,
   16), ragged (300, 520, 40) and wide N 512 and 300, with f32 out_cols,
   and an 8-bit packed output fed back as the next product's A. Then
   K2's 1/2/4-bit kernel in every output form (``torch_cases.k2_groups``):
   N in {8, 16, 24, 40, 64, 72, 200} at 1/2/4 bits against one and two
   digit planes of B, one 256-row group at depth 448 (7 K steps); every
   split 1-4 forced through the plan; hand-made maps (kcnt 0, below the
   split, past the grid and -1, entries outside it) at every split;
   packed words at out_cols 8, 40, 64 and 200; packed words chained
   through three products; each output computed twice, both equal to
   plain. Then K4's kernel under every forced plan (``torch_cases.k4_groups``:
   each column tile 16, 32 and 64 with each split 1-4, 1-2 for packed
   words): the PreparedRHS product at N 16, 60, 64 and 120 (5- and 8-bit
   A, depth 448: odd remainders over every split; 1024²), out_cols 8, 40,
   64 and 200, A at 0, everything at 255 and K 32640; K2's 8-bit plane
   against one and two digit planes, with hand-made maps (kcnt 0, below
   the split, past the grid, -1, entries outside it) and packed words at
   out_cols 8, 64 and 200; every output form, each output computed twice,
   both equal to plain. Then zero-tile jumping, the ``TileMap`` K skip of ``packmm`` (A at 1/2/4/8
   bits, every output form, tiles (256 | 512) x (256 | 128), C1's shape
   and two multi-row-tile ragged ones) and of ``digitmm`` (1 and 2 digit
   planes each side, tiles (256 | 128)^2) against plain, with the
   builders' maps (equal to dense) and hand-made ones (occupied tiles left
   out, a tile listed twice, kcnt 0, -1 and past the grid, entries outside
   it); each call must launch once with its map. Then the kernel-study
   probes (``qgtc_ppopp22_tpu_torch/benchmarks``): P1a's ring loop
   (``exp_packmm``: word-row CTAs, split-K) in every variant at 1/2/4
   bits, tm 256 and 512, 16-, 48- and 64-column B and C1's 2560 x 2560
   (noextract against its own plain version, the int8 A and, at tm 256,
   concat on K2's row ranges against the packed product), at its default
   plan and on each K step with 3 slots; concat, slabs and int8 under
   every forced plan of ``exp_packmm_plan`` at C1's shape and at 4096^2 x
   64, each output twice after filling its block with -1, then NaN; P1b's packed out (``exp_packmm_packed.cu``, CTAs
   that own whole word rows) under every forced plan of
   ``packedout_plan`` (column tile, K step, split, ring) at 1/2/4 bits,
   layout tiles of 256, 512, 768, 1024 and 4096 rows, Np 16, 48 and 64,
   sums below 0, each output twice after filling its block with -1 and
   then 0; P2's bitcasts (``exp_bitcast_probe``) at the probes' shapes,
   shapes that take P2b's vector path and its tail, 16 MB and 128 MB, P2b
   after a -1 fill, each round trip back to its input, P2b's launches
   counted, and the fragment registers of a random tile; P3's zero body
   (``grid_overhead_study``, G 1 and 3, oc 8, 48, 120, and the study's
   geometry: pn 1024 and 2048, G 1 and 5; K1's rows a CTA and 64) and K-dot under every forced plan of
   ``kdot_plan`` (rows a CTA, cluster, ring; K 0, 1, 2; oc 8,
   48, 120; pn 256, 640 and the study's 2048), random S and x, each output
   twice after a NaN fill.
2. The main path: 2-bit 3-layer Cluster-GCN (hidden 16) on the
   full-scale synthetic ogbn-arxiv stand-in, psize 1500, batch 20, 75
   batches on the default partition, which must have resolved to the
   native multilevel partitioner (the JAX package's ``auto``); 4 of its
   batches built again without the native library must equal the native
   densify / quantize / pack byte for byte (the buckets, their batch counts
   and the K tiles the maps list are printed); then
   through ``QGTCEngine.forward_all``; launch counts are reset
   just before and must show 3 packmm + 3 digitmm launches per batch;
   logits must equal the plain versions' and, for the first batch, a
   NumPy integer reference. Then 4 batches of 2-bit GIN (hidden 64).
   Then the mega engine on the same 75 batches
   (``QGTCEngine.run_epochs_mega``: one ``fused_model`` launch per shape
   bucket, here three): launch counts reset just before, logits equal to
   the step engine's and the plain versions', no bucket falling back;
   and 4 batches of GIN through the mega engine against plain. Then the
   5-8-bit mega path: the same 75 batches packed at 8 bits through
   ``QGTCEngine(bit_width=8, shifts=...).run_epochs_mega``'s staging, each
   shift the smallest that leaves more than half of its stage's levels
   below the 255 rail on batch 0 (shares printed): counts reset just
   before, one levels-form ``fused_model`` launch per bucket (the signed
   chain), no fallback, logits equal to plain, to the 8-bit step engine
   and, for batch 0, to a NumPy chain; then 4 batches of 8-bit GIN
   (hidden 64, feature width 128) the same way. Then K1's weight
   operands (``fused_model.pack_mega_weights``): over three mega epochs of
   C1 and of C1-8 each engine builds them once (its form's, digits and
   signed) for all its buckets' launches, and C1-8's logits with them equal
   the same launches with the operands built per launch. Then the
   full-precision baseline on the same 75 batches through
   ``BaselineEngine.run_epochs_mega``'s staging (one ``fused_baseline``
   launch per bucket, counts reset just before; a bucket the kernel
   refused would stop the staging), its logits within the tolerance
   above of the step baseline's and of plain; and 4 batches of the gin
   baseline (hidden 64). Then the bit-serial path:
   ``QGTCEngine(fmt='bits').forward_all`` on the same 75 batches, counts
   reset just before: 6 bitmm launches per batch and no packmm / digitmm
   launch; logits equal to the plain versions', to the digit step
   engine's and, for the first batch, to the NumPy reference; then 4
   batches of GIN (hidden 64) against the digit engine and plain.
   Then zero-tile jumping: ``QGTCEngine(zerotile_jump=True).forward_all``
   on the same 75 batches, counts reset just before: 3 packmm launches
   with the batch's map and 3 digitmm per batch; logits equal to plain,
   the dense step engine's and the NumPy reference; the maps' processed /
   total tiles; the accuracy after the mega engine's epochs with the
   flag equal to the dense engine's; 4 batches of GCN over the adjacency
   as a digit plane with its map (``digitmm``'s K skip); and
   ``fused_model_epoch(chunk_occ=)`` at C1, 1-D and 2-D, real and
   hand-made maps, and ``resident_a=False``, against the dense launch
   and plain. Then the captured engines on the 75 batches: the fused
   epoch, dense and with the maps, and the quant-in-loop epoch, each
   captured as one CUDA graph (the wrappers' counters: 6 packmm and 6
   digitmm launches a batch at the side stream's warm-up and the capture,
   none at a replay), each replay's logits equal to the step engine's bit
   for bit, twice, the second after every output was filled with a
   sentinel, and the profiler's count of a replay's kernels: 225 K2 and
   225 K3; the mega engine with its plan refusing C1's bucket, run by the
   captured fused epoch, equal to the step engine; the baseline's fused
   loop captured against the same loop uncaptured, bit for bit or (if
   cuBLAS picks another algorithm under capture, which is then printed)
   within 2^-6 per row, again after a sentinel fill. Then the kernel sweep (``qgtc_ppopp22_tpu_torch.benchmarks.kernel_sweep``,
   figures 8a, 8c, int8 and profile, each from ``default_rng(0)``):
   counts reset before each figure; its 8-bit rows must launch
   ``packmm_signed`` once and nothing else, its other packed rows
   ``packmm`` once and nothing else, its int8 rows (``torch._int_mm``)
   neither; every row's output equals plain (the 32768-row profile
   shapes on their first 2048 rows). Then ``--use-pp`` at C1: the
   batcher's precalc features (256 wide) through the step engine (3
   packmm + 3 digitmm launches a batch, logits equal to plain, batch 0 to
   ``qgcn_golden``), the mega engine (equal to the step engine; a bucket
   K1's plan refuses falls back loudly and is recorded) and the sage
   baseline's mega mode (within 2^-6 per row of its step; a refused bucket
   recorded likewise). Then ``rebit(8)`` and ``rebit(8, quant_bits=2)``
   of C1's batcher against fresh batchers, byte for byte on 4 batches, the
   8-bit engine on them equal to plain. Then the layer API
   (``models/layers.py``): ``QGCNConv`` / ``QGINConv`` objects composed on
   batch 0 equal to ``qgcn_forward`` / ``qgin_forward``, digits (3 packmm +
   3 digitmm launches) and bits (6 bitmm). Then ``SparseEngine`` on the
   whole stand-in (GCN hidden 16, GIN hidden 64, 2-bit): the card's logits
   equal to the same engine's on the CPU, 5 epochs timed. Then the CLI
   in-process with each flag this slice ported (``--sparse``,
   ``--use-pp``, ``--bucket-rows``, ``--profile-dir``, ``--json-out``,
   ``--cache-dir``) on a small ppi stand-in: exit 0 and every record
   written. Then quantization-aware training (``models/train.py``,
   :func:`qat_phase`): ``qat_train`` of C1's model (2-bit GCN, hidden 16, 3
   layers) on C1's 75 batches on the card, ``QAT_EPOCHS`` smooth and STE
   epochs; the twin's accuracy equal to the deployed step and mega engines'
   and its logits to theirs on every batch; the checkpoint deployed by
   ``python -m qgtc_ppopp22_tpu_torch.cli --weights`` in step and mega mode
   with the same accuracy; the accuracy ladder at 1 and 2 bits on a small
   Proteins stand-in, monotone, its exact emulation equal to the 1-bit row.
   Its seconds and accuracy are printed on a line of their own before the
   card's line. Then the (dp, sp) mesh engine (``parallel/``,
   :func:`mesh_phase`) over this card repeated: C1 at (4, 1) (K1 a dp row)
   and (2, 2) (the ring of K2 raw-int32 shard GEMMs, K3 updates), GIN and
   8-bit on 4 batches at both, the dense digit-plane path in both
   aggregation modes, the CLI's ``--mesh``, ``dryrun_multichip(4)`` and two
   ``gloo`` processes on the card, each equal to the step engine bit for
   bit and each path's launches counted.
3. The kernel studies through the probe modules' entry points, launch
   counts reset just before and each probe kernel launched: P2's three
   tables (bytes in the TPU's interpret-mode order, the fragments in the
   PTX ISA's layout), JAX's ten ``run_packedout`` rows (each exact), the
   per-K-step ladder at C1's aggregation (every variant, the int8 A,
   concat on K2's row ranges, K2 and ``torch._int_mm``, each equal to
   plain first, each P1a row with its plan's K step) and P3's zero-body and K-dot rows (random
   operands, each call equal to plain first) and layer-fit rows (K1 at
   1/3/5 layers).
   Timing: ms/epoch of the step engine (host clock around all epochs
   and one synchronize, resident and transfer-inclusive, twice each,
   each beside the same engine with zero-tile jumping and the bits step
   engine),
   the mega engine's ms/epoch with and without the compacted block
   schedule (twice each); the mega engine at 2 bits (E3) beside 8 bits
   (E3-8, the levels form), twice (the kernel rows time the bucket that
   holds the most batches); the baseline's ms/epoch in step (resident),
   fused and mega modes beside the quantized mega engine's (twice each);
   E1, E1z, E5 (the captured fused epoch), E5z (with the maps), E6
   (quant-in-loop), B2 (the baseline's captured fused loop) and B3 (its
   mega mode), three runs of 20 epochs each in turns, each beside its
   epoch's device time (a step epoch's kernels, a replay's, K5's launch);
   E3 beside the mesh at (1, 1), (4, 1) and the ring at (2, 2), three runs
   each in turns, and K2's raw-int32 call at a ring shard's shape beside
   plain (:func:`mesh_timing`);
   and the device time of each kernel beside its plain version at the
   slice's shapes (torch.profiler), with ``torch._int_mm`` on the same
   operands as the library yardstick of packmm, digitmm and bitmm, each
   K2 row (and K2's sweep rows) with its plan (column tile, split,
   cluster, grid), and in the same session K2's yardsticks, P1's concat
   on a 16-column tile at C1 and P1b's 4096^2 N 64 row, each criterion
   of K2 against them printed as met or not; K6 at C1's four shapes
   (aggregation to bits, to f32 at N 40, the updates at K 128 and K 16),
   each with its plan, beside plain, its bound and ``torch._int_mm``, and
   its criteria (the aggregation at or below K2's C1 aggregation, each row
   below ``torch._int_mm``) printed as met or not; K4
   and K2's packed out at Fig. 8a's (4096, 4096, 64) beside plain,
   bound and ``torch._int_mm``, each with its plan; K2's 8-bit plane
   (8-bit A[4096²] x 8-bit B[4096x64], two digit planes) to the signed
   plane and to f32 at out_cols 64, dense and over a blocky A with its
   map, each equal to plain first, beside plain, bound, plan and
   ``torch._int_mm`` on int8 operands of the same shapes; K1 at C1 (compact and dense), at C1-8
   (the levels form dense and with C1's schedule, beside the 2-digit
   route on the same batches) and C1 with X as 2-bit levels (the 1-4-bit
   form), each with its plan (``fused_model_plan``), bound and plain time;
   and every sweep
   row's us and TFLOP/s, and its bound,
   beside ``BASELINE.md``'s sm_86 figure for it, in the same profiler
   session; and the K skip at C1 (batch 0's adjacency and its map:
   ``packmm_to_digits``, ``packmm_to_f32`` and ``digitmm_to_digits`` over
   the adjacency as a digit plane), each beside the same call without the
   map, plain, ``torch._int_mm`` and a bound that counts only the listed
   tiles, and one resident step epoch's device time with the maps; and
   each probe kernel at its study's shape beside plain, bound and a
   library yardstick where one PyTorch call computes the same function:
   for P1 ``torch._int_mm`` on the unpacked levels, for P2's bitcasts a
   strided copy of the bytes (P2a and P2b beside the launch floor, the
   device time of ``torch.zeros(1)``'s fill in the same session, and
   each at 16 MB and 128 MB, taking turns over copies, beside its bound
   and its strided copy), for P3b K ``torch._int_mm`` calls of S by
   the 50 batches' rolled columns side by side, only the round_up(oc, 8)
   that the function keeps, none for the zero body
   (taking turns over copies of X, so each call reads X from HBM); K2's
   packed words at 4096^2 x 16 beside P1b's first row.
   Last, the study modules (:func:`studies_phase`) at a cut size on C1's
   batches: ``run_all`` (C1 GCN at 2 and 8 bits in mega, fused and step,
   the sage baseline's mega mode, 3 epochs each; every row timed, no
   fallback, each mode's kernels launched), ``zero_tile_study`` (C1's tile
   counters, mega dense against zero-tile), ``transfer_study`` (one round),
   ``roofline`` (C1's rows at 2 and 8 bits on the rates ``roofline.probe``
   measures on the card, with the phase's E3 and E3-8: every measured
   time at or above its floor), ``partition_quality`` (Proteins, three
   methods) and ``ring_overlap`` (its ring and gather logits equal to the
   step engine's).

Test operands come from ``tests/torch_cases.py``. Each kernel's bound
is the larger of its bytes (inputs read once, outputs written once) over
3.35 TB/s and its operations over the card's dense peak (1,979 TOP/s
int8, 989 TFLOP/s bf16); bitmm is charged 2 M N K int8 operations per
pair of base-16 digits on the logical shapes (the data sheet gives no
one-bit rate) and the bytes of A's and B's real columns, and the work its
planned grid does is printed beside. The seventh line from the end is
``studies: {...}`` (the study phase's seconds, the measured rates, its
times, floors and overlap shares), the sixth ``mesh: {...}`` (the mesh
phase's seconds and timings), the fifth ``qat: {...}`` (the QAT
phase's seconds, epochs and accuracy), the third the card's name and power
limit, the second ``{"kernels": [...]}``; the last line is ``{"ok": true,
"device": {...}}``.
"""

import contextlib
import functools
import io
import itertools
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

SEED = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peaks (NVIDIA's data sheet)
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}


# BASELINE.md: the reference's TFLOP/s on sm_86 (an RTX 3090) for each
# kernel-sweep row, keyed (figure, bits, M = K, N)
SM86 = {("profile", 1, 32768, 16): 12.359, ("profile", 1, 32768, 64): 26.431}
for _bits, _vals in {1: (5.847, 16.605, 40.627, 11.724, 32.666, 35.032, 23.219, 37.438, 46.768),
                     2: (3.934, 10.086, 20.764, 7.864, 19.762, 20.951, 15.429, 25.055, 26.818),
                     4: (2.488, 6.561, 12.409, 4.456, 12.807, 13.929, 10.683, 12.328, 14.196),
                     8: (1.541, 3.483, 6.763, 3.074, 6.816, 7.366, 5.046, 6.165, 7.324)}.items():
    for _i, _v in enumerate(_vals):  # N outer, M = K inner
        SM86[("8a", _bits, (1024, 2048, 4096)[_i % 3], (16, 32, 64)[_i // 3])] = _v
for _mk, _vals in {1024: (5.831, 11.717, 23.158, 28.417, 32.089, 41.743, 37.954),
                   2048: (16.323, 32.027, 37.444, 40.646, 44.151, 49.687, 52.970),
                   4096: (34.425, 40.175, 46.759, 52.517, 59.508, 64.172, 66.490)}.items():
    for _n, _v in zip((16, 32, 64, 128, 256, 512, 1024), _vals):
        SM86[("8c", 1, _mk, _n)] = _v
for _mk, _vals in {1024: (0.55, 3.89, 4.38), 2048: (2.58, 5.49, 6.30),
                   4096: (3.60, 6.49, 6.65)}.items():
    for _n, _v in zip((16, 32, 64), _vals):
        SM86[("int8", 8, _mk, _n)] = _v


def bound(nbytes, ops, kind):
    """(bound_ms, bound_by): the least time for the bytes and operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


QAT_EPOCHS = (20, 10)  # the QAT phase's smooth and STE epochs (qat_train's 25 and 20 cut to stay near 60 s)


def qat_phase(dev, ds, batcher, cli_argv, root) -> dict:
    """Quantization-aware training of C1's model (2-bit GCN, hidden 16, 3
    layers) on ``batcher`` (C1's batches) on ``dev``, and its deployment:

    (a) the twin's train accuracy equals ``quantized_accuracy`` through the
        step engine and through the mega engine exactly;
    (b) the twin's logits equal, on every batch over the real extents, the
        step engine's (3 packmm + 3 digitmm launches a batch) and the mega
        engine's (one fused_model launch a bucket, none falling back);
    (c) the model saved with ``save_checkpoint`` and deployed by ``python -m
        qgtc_ppopp22_tpu_torch.cli <cli_argv> --weights ... --eval-accuracy``
        in step and in mega mode (two processes at once, from ``root``):
        exit 0, the same accuracy, the record naming the checkpoint;
    (d) the ladder at bits [1, 2] on the Proteins stand-in (scale 0.05,
        psize 8, batch 2, one seed): monotone rows, the 2-bit row's exact
        emulation of the 1-bit winner equal to the 1-bit row.

    Float32 matmuls must be at full precision (no TF32): the twin's integer
    sums are exact only there. Returns the phase's record."""
    import subprocess

    import torch

    from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
    from qgtc_ppopp22_tpu_torch.models import train
    from qgtc_ppopp22_tpu_torch.models.qmodels import QModelConfig
    from qgtc_ppopp22_tpu_torch.ops import digitmm, fused_model, packmm
    from qgtc_ppopp22_tpu_torch.runtime import QGTCEngine

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("QAT: float32 matmuls are not at full precision")
    t0 = time.perf_counter()
    cfg = QModelConfig(batcher.feat_dim, 16, ds.num_classes, bit_width=2, num_layers=3)
    ws, shifts, acc = train.qat_train(ds, batcher, cfg, smooth_epochs=QAT_EPOCHS[0], ste_epochs=QAT_EPOCHS[1],
                                      seed=SEED, device=dev)
    train_s = time.perf_counter() - t0
    deployed = {mode: train.quantized_accuracy(ds, batcher, ws, 2, shifts=shifts, device=dev, mode=mode)
                for mode in ("step", "mega")}
    if any(v != acc for v in deployed.values()) or not 0.0 < acc <= 1.0:
        raise AssertionError(f"QAT: twin accuracy {acc} != deployed {deployed}")
    nb, ncls = len(batcher.batches), ds.num_classes
    twin = train.float_twin_logits(ds, batcher, ws, 2, "gcn", shifts, device=dev)
    eng = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=ncls, bit_width=2, hidden=16, shifts=shifts, device=dev)
    eng.set_float_weights(ws)
    packmm.LAUNCHES = digitmm.LAUNCHES = fused_model.LAUNCHES = 0
    step = eng.forward_all(batcher)
    launches = {"packmm": packmm.LAUNCHES, "digitmm": digitmm.LAUNCHES}
    mega = eng._mega_logits(batcher)
    launches["fused_model"] = fused_model.LAUNCHES
    if launches != {"packmm": 3 * nb, "digitmm": 3 * nb, "fused_model": len(eng.mega_buckets)} \
            or any(bk["fallback"] for bk in eng.mega_buckets):
        raise AssertionError(f"QAT deployment: launches {launches}, buckets {eng.mega_buckets}")
    for b, t, st, mg in zip(batcher.batches, twin, step, mega):
        n = b.num_nodes
        if t.shape != (b.padded_nodes, ncls) or not torch.isfinite(t).all() \
                or not torch.equal(t[:n], st[:n, :ncls]) or not torch.equal(t[:n], mg[:n, :ncls]):
            raise AssertionError("QAT: the twin's logits != the step / mega engine's")
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        ck = os.path.join(tmp, "qat_c1.npz")
        train.save_checkpoint(ck, ws, shifts, cfg, model="gcn")
        procs = {mode: subprocess.Popen(
            [sys.executable, "-m", "qgtc_ppopp22_tpu_torch.cli", *cli_argv, "--weights", ck, "--eval-accuracy",
             "--mode", mode, "--n-epochs", "1", "--device", str(dev), "--json-out", os.path.join(tmp, mode)],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for mode in ("step", "mega")}
        for mode, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=600)
            finally:
                proc.kill()
            if proc.returncode != 0:
                raise AssertionError(f"cli --weights --mode {mode}: exit {proc.returncode}\n{err[-3000:]}")
            with open(os.path.join(tmp, mode)) as f:
                rec = json.loads(f.read())
            if rec["accuracy"] != acc or rec["weights"] != ck or rec["mode"] != mode:
                raise AssertionError(f"cli --weights --mode {mode}: record {rec}, twin accuracy {acc}")
    small = load_dataset("Proteins", scale=0.05)

    def make_batcher(bits, feature_scale=1.0, quant_bits=None):
        return ClusterBatcher(small, psize=8, batch_size=2, bit_width=bits, shuffle=False,
                              feature_scale=feature_scale, quant_bits=quant_bits)

    rows = train.qat_ladder(small, make_batcher, [1, 2], seeds=(SEED,), device=dev)
    if rows[1]["accuracy"] < rows[0]["accuracy"] or rows[1]["emulated"] != rows[0]["accuracy"]:
        raise AssertionError(f"QAT ladder: {rows}")
    return dict(seconds=time.perf_counter() - t0, train_seconds=train_s, epochs=QAT_EPOCHS, accuracy=acc,
                shifts=shifts, launches=launches,
                ladder=[{k: r[k] for k in ("bits", "accuracy", "winner", "emulated")} for r in rows])


MESH_BATCHES = 4  # the mesh phase's GIN, 8-bit and dense-path gates


def mesh_phase(dev, ds, batcher, batcher8, sh8, step, step8, gin_step, root) -> dict:
    """The (dp, sp) mesh engine (``parallel/``) on C1, every mesh over
    ``dev`` repeated (one GPU runs every shard), each gate a hard failure:

    (a) ``MeshEngine`` at dp 4, sp 1 on C1's batches: every bucket's mode
        ``mega`` (one K1 launch a dp row), logits equal to the step engine's
        (``step``) bit for bit on every batch over the real extents, read
        after the previous epoch's outputs were filled with NaN and freed;
    (b) dp 2, sp 2: every bucket ``ring`` (K2 raw int32 a rotation, K3 the
        updates), equal likewise;
    (c) GIN (hidden 64, ``gin_step``) and the 8-bit GCN with C1-8's shifts
        (``batcher8``, ``sh8``, ``step8``) on ``MESH_BATCHES`` batches at (4,
        1) and (2, 2), equal likewise;
    (d) the dense digit-plane path: ``dp_sp_epoch_step`` at (2, 2), ring
        and gather aggregation, on ``MESH_BATCHES`` batches (two copies a
        call), equal to the step engine;
    (e) the CLI with ``--mesh 1,1`` (distinct GPUs) and ``--mesh 2,2`` on
        ``dev`` repeated: exit 0, the record's engine and modes;
        ``entry.dryrun_multichip(4, [dev] * 4)`` passes;
    (f) two processes of ``parallel/multihost_worker.py`` on ``dev``
        (``gloo``), each at (dp 2, sp 1), K1 a dp row, and at (dp 2, sp 2),
        the ring: each process's gathered logits equal the single-process
        engine's, every bucket in its mesh's mode, the mesh's kernels
        launched.

    Each gate's launches are counted from 0 just before it and read just
    after; a kernel of the path launched no time fails. Returns the launches
    and seconds."""
    import subprocess
    import socket
    from types import SimpleNamespace

    import torch

    from qgtc_ppopp22_tpu_torch import cli
    from qgtc_ppopp22_tpu_torch.entry import dryrun_multichip
    from qgtc_ppopp22_tpu_torch.ops import digitmm, fused_model, packmm
    from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack, to_digit_tensor
    from qgtc_ppopp22_tpu_torch.ops.packmm import PackedTensor, packed_levels
    from qgtc_ppopp22_tpu_torch.parallel import MeshEngine, dp_sp_epoch_step, make_mesh

    t0 = time.perf_counter()
    one = torch.device(dev.type, 0) if dev.type == "cuda" else dev
    devs4 = [one] * 4
    ncls = ds.num_classes

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def counts():
        return {"fused_model": fused_model.LAUNCHES, "packmm": packmm.LAUNCHES, "digitmm": digitmm.LAUNCHES}

    def zero():
        fused_model.LAUNCHES = packmm.LAUNCHES = digitmm.LAUNCHES = 0

    def check(what, eng, bt, refs):
        """One epoch whose outputs are filled with NaN and freed, then the
        counted one, every real batch against ``refs``; its launches."""
        eng.stage(bt)
        outs = eng._epoch()
        for o in outs:
            for row in o.parts:
                for part in row:
                    part.fill_(float("nan"))
        del outs
        sync()
        zero()
        got = eng.forward_batches(bt)
        sync()
        n = counts()
        for i, (b, g, r) in enumerate(zip(bt.batches, got, refs)):
            if g.shape != (b.num_nodes, ncls) or not torch.equal(g, r[: b.num_nodes, :ncls].cpu()):
                raise AssertionError(f"mesh {what}: batch {i} != the step engine's logits")
        padded = sum(s.padded for s in eng._staged)
        layers, sp = eng.cfg.num_layers, eng.sp
        if eng.sp == 1:
            want = {"fused_model": eng.dp * len(eng._staged), "packmm": 0, "digitmm": 0}
            if eng.modes != ["mega"] * len(eng._staged) and not all(
                    s.info["fallback"] for s in eng._staged if s.mode == "ring"):
                raise AssertionError(f"mesh {what}: modes {eng.modes}")
            if "ring" in eng.modes:
                want = None
        else:
            want = {"fused_model": 0, "packmm": padded * layers * sp * sp, "digitmm": padded * layers * sp}
            if eng.modes != ["ring"] * len(eng._staged):
                raise AssertionError(f"mesh {what}: modes {eng.modes}")
        if (want is not None and n != want) or not any(n.values()):
            raise AssertionError(f"mesh {what}: launches {n}, want {want}")
        return n

    launches = {}
    few = SimpleNamespace(batches=batcher.batches[:MESH_BATCHES], bit_width=2)
    few8 = SimpleNamespace(batches=batcher8.batches[:MESH_BATCHES], bit_width=8)
    for dp, sp in ((4, 1), (2, 2)):
        kw = dict(dp=dp, sp=sp, seed=SEED, devices=devs4)
        launches[f"C1 ({dp},{sp})"] = check(f"C1 ({dp},{sp})", MeshEngine(batcher.feat_dim, ncls, **kw),
                                            batcher, step)
        launches[f"GIN ({dp},{sp})"] = check(f"GIN ({dp},{sp})", MeshEngine(batcher.feat_dim, ncls, model="gin",
                                                                            **kw), few, gin_step)
        launches[f"8-bit ({dp},{sp})"] = check(f"8-bit ({dp},{sp})", MeshEngine(
            batcher8.feat_dim, ncls, bit_width=8, shifts=sh8, **kw), few8, step8)
    # (d) the dense digit-plane path, ring and gather
    ws = MeshEngine(batcher.feat_dim, ncls, seed=SEED, devices=[one]).weights
    mesh = make_mesh(2, 2, devs4)
    zero()
    for i, b in enumerate(batcher.batches[:MESH_BATCHES]):
        pn = b.padded_nodes
        a_d = digit_pack(packed_levels(PackedTensor(words=b.a_words.to(one), shape=(pn, pn), bits=1)), 1).digits
        x = to_digit_tensor(b.bit_X.to(one))
        for mode in ("ring", "gather"):
            out = dp_sp_epoch_step(mesh, torch.stack([a_d] * 2), torch.stack([x.digits] * 2), ws, 2, x_bits=2,
                                   agg_mode=mode, x_cols=x.shape[1]).gather(one)
            for o in out:
                if not torch.equal(o[: b.num_nodes, :ncls], step[i][: b.num_nodes, :ncls]):
                    raise AssertionError(f"dense mesh path ({mode}): batch {i} != the step engine's logits")
    sync()
    launches["dense (2,2)"] = counts()
    if launches["dense (2,2)"]["digitmm"] == 0:
        raise AssertionError(f"dense mesh path: launches {launches['dense (2,2)']}")
    # (e) the CLI and the dry run
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        jout = os.path.join(tmp, "mesh.jsonl")
        base = ["--dataset", "ppi", "--dataset-scale", "0.02", "--psize", "40", "--batch-size", "4", "--n-epochs", "2",
                "--json-out", jout, "--cache-dir", os.path.join(tmp, "cache")]
        runs = [(["--mesh", "1,1", "--device", str(dev)], "qgtc-mesh-dp1-sp1"),
                (["--mesh", "2,2", "--device", str(one)], "qgtc-mesh-dp2-sp2")]
        for flags, engine in runs:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(base + flags)
            if rc != 0:
                raise AssertionError(f"cli {flags}: exit {rc}")
        with open(jout) as f:
            records = [json.loads(line) for line in f]
        if [r["engine"] for r in records] != [e for _, e in runs] or records[0]["mesh_modes"] != \
                ["mega"] * len(records[0]["mesh_modes"]) or set(records[1]["mesh_modes"]) != {"ring"} \
                or any(r["avg_epoch_ms"] <= 0 for r in records):
            raise AssertionError(f"cli --mesh: records {records}")
    with contextlib.redirect_stdout(io.StringIO()) as dry:
        dryrun_multichip(4, devs4)
    if "dryrun_multichip ok: 4 devices" not in dry.getvalue():
        raise AssertionError(f"dryrun_multichip: {dry.getvalue()}")
    # (f) two processes on one device, gloo between them
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-m", "qgtc_ppopp22_tpu_torch.parallel.multihost_worker", str(r), "2",
                               str(port), "--device", str(one)], cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    walls = []
    for r, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=300)
        finally:
            proc.kill()
        if proc.returncode != 0 or f"p{r}: MULTIHOST-OK" not in out or any(
                f"p{r}: MESH-EPOCH-OK dp=2 sp={sp} " not in out for sp in (1, 2)):
            raise AssertionError(f"two-process worker {r}: exit {proc.returncode}\n{out[-3000:]}")
        walls.append(dict(re.findall(r"EPOCH-WALL dp=2 (sp=\d) ms=([0-9.]+)", out)))
    return dict(launches=launches, seconds=time.perf_counter() - t0, worker_walls_ms=walls,
                cli=[(r["engine"], r["mesh_modes"], r["avg_epoch_ms"]) for r in records])


def mesh_timing(dev, batcher, eng, card, nb: int) -> dict:
    """Host ms/epoch, in turns (3 runs): E3 (the mega engine, ``eng``), the
    mesh at (1, 1) (the same K1 launches), at (4, 1) and the ring at (2, 2)
    over ``dev`` repeated; every engine staged once. Then K2's raw-int32
    call at a ring shard's shape (the first batch of the bucket with the
    most batches, C1's pn 2560, shard 0's first column block: A[1280²]
    1-bit words x H[1280 x 16] 2-bit) beside its
    plain version, device time. Records, not gates."""
    import torch

    from qgtc_ppopp22_tpu_torch.ops import packmm
    from qgtc_ppopp22_tpu_torch.ops.digits import digit_pack
    from qgtc_ppopp22_tpu_torch.ops.packmm import PackedTensor
    from qgtc_ppopp22_tpu_torch.parallel import MeshEngine
    from qgtc_ppopp22_tpu_torch.utils.timing import device_times_ms

    t0 = time.perf_counter()
    one = torch.device(dev.type, 0) if dev.type == "cuda" else dev
    feat, ncls = batcher.feat_dim, eng.cfg.out_dim
    meshes = {"mesh (1,1)": MeshEngine(feat, ncls, seed=SEED, devices=None if dev.type == "cuda" else [dev]),
              "mesh (4,1)": MeshEngine(feat, ncls, dp=4, seed=SEED, devices=[one] * 4),
              "ring (2,2)": MeshEngine(feat, ncls, dp=2, sp=2, seed=SEED, devices=[one] * 4)}
    fns = [fn for _, fn in eng._stage_mega(batcher)]
    runs = {"E3": (lambda: [f() for f in fns], eng, 20)}
    for k, m in meshes.items():
        m.stage(batcher)
        runs[k] = (m._epoch, m, 5 if k.startswith("ring") else 20)
    host_ms = {k: [] for k in runs}
    for _ in range(3):
        for k, (fn, e, n) in runs.items():
            host_ms[k].append(e._run_staged(fn, n, nb, False).avg_ms)
    print("phase 3: mesh host ms/epoch, 3 runs each in turns (one GPU; (4,1) and (2,2) over cuda:0 repeated: "
          "structure, not scaling): " + "; ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in vs)
                                                 for k, vs in host_ms.items()) + f" [{card}]")
    bk = max(meshes["ring (2,2)"]._staged, key=lambda s: s.padded)  # C1's: pn 2560
    blocks = bk.fn.args[1].parts[0][0]  # shard (0, 0)'s column blocks
    rows = blocks.shape[-1]
    a = PackedTensor(words=blocks[0, 0], shape=(rows, rows), bits=1)
    g = torch.Generator().manual_seed(SEED)
    h = digit_pack(torch.randint(0, 4, (rows, 16), generator=g).to(one), 2)
    same = torch.equal(packmm.packmm_to_i32(a, h), packmm.packmm_plain(a, h, raw_i32=True))
    if not same:
        raise AssertionError("K2 raw int32 at the ring shard != plain")
    dt = device_times_ms({"kernel": lambda: packmm.packmm_to_i32(a, h),
                          "plain": lambda: packmm.packmm_plain(a, h, raw_i32=True)}, iters={"kernel": 50, "plain": 5})
    nbytes = a.words.numel() * 4 + rows * 16 + rows * 16 * 4
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"phase 3: K2 raw int32 at a ring shard of the pn {bk.pn} bucket (A[{rows}²] 1-bit words, "
          f"{int((a.words != 0).sum())} nonzero words, x H[{rows}x16] 2-bit): kernel {dt['kernel'] * 1e3:.2f} us, plain {dt['plain'] * 1e3:.1f} us, "
          f"bound {b_ms * 1e3:.3f} us (bytes); == plain [{card}]")
    return dict(host_ms=host_ms, k2_i32_us=dt["kernel"] * 1e3, k2_i32_plain_us=dt["plain"] * 1e3,
                seconds=time.perf_counter() - t0)


def studies_phase(dev, ds, batcher, card) -> dict:
    """The study modules (``qgtc_ppopp22_tpu_torch/benchmarks``) through
    their ``rows`` functions at a cut size, on C1's batcher (``batcher``),
    each gate a hard failure:

    (a) ``run_all``: C1 GCN at 2 and 8 bits in mega, fused and step mode,
        and the sage baseline's mega mode, 3 epochs each: every row timed,
        no bucket falling back, each mode's kernels launched (K1 and K5 in
        mega, K2 and K3 in fused and step; counts reset just before);
    (b) ``zero_tile_study``: C1's tile counters (equal to the batcher's
        ``tile_counts``), mega dense against zero-tile, 3 epochs;
    (c) ``transfer_study``: C1's packed and dense epoch, one round;
    (d) ``roofline``: C1's GCN rows at 2 and 8 bits on the rates
        ``roofline.probe`` measures, with (a)'s mega times (E3, E3-8):
        each measured time at or above its floor on those rates (below it,
        the count is wrong);
    (e) ``partition_quality``: Proteins, native, BFS and RCM;
    (f) ``ring_overlap``: its rows, whose ring and gather logits equal the
        step engine's (the module raises otherwise).

    Returns the rows and the phase's seconds."""
    import torch

    from qgtc_ppopp22_tpu_torch.benchmarks import (partition_quality, ring_overlap, roofline, run_all,
                                                   transfer_study, zero_tile_study)
    from qgtc_ppopp22_tpu_torch.graph import load_dataset
    from qgtc_ppopp22_tpu_torch.ops import digitmm, fused_model, packmm

    t0 = time.perf_counter()
    out, launches = {}, {}
    # (a) the epoch matrix at C1
    out["run_all"] = []
    for mode, want in (("mega", ("fused_model", "fused_baseline")), ("fused", ("packmm", "digitmm")),
                       ("step", ("packmm", "digitmm"))):
        fused_model.LAUNCHES = fused_model.BASELINE_LAUNCHES = packmm.LAUNCHES = digitmm.LAUNCHES = 0
        out["run_all"] += run_all.dataset_rows(ds, batcher, [2, 8], dev, card, baseline=mode == "mega", mode=mode,
                                               n_epochs=3)
        launches[mode] = {"fused_model": fused_model.LAUNCHES, "fused_baseline": fused_model.BASELINE_LAUNCHES,
                          "packmm": packmm.LAUNCHES, "digitmm": digitmm.LAUNCHES}
        if not all(launches[mode][k] for k in want):
            raise AssertionError(f"run_all {mode}: launches {launches[mode]}")
    for r in out["run_all"]:
        if r["not_run"] or r["fallback_buckets"] or not r["epoch_ms"] > 0:
            raise AssertionError(f"run_all row {r}")
    # (b) zero-tile counters and mega dense against zero-tile
    out["zero_tile"] = zero_tile_study.dataset_rows(ds.name, batcher, ds.num_classes, ["mega"], 3, dev, card)
    processed, total = batcher.tile_counts()
    if (out["zero_tile"][0]["tiles_processed"], out["zero_tile"][0]["tiles_total"]) != (processed, total):
        raise AssertionError(f"zero_tile_study counters {out['zero_tile'][0]} != tile_counts {processed}/{total}")
    # (c) packed against dense transfer, one round
    out["transfer"] = transfer_study.study_rows(ds, batcher, dev, card, epochs=1)
    if not out["transfer"][0]["bytes_per_epoch"] < out["transfer"][1]["bytes_per_epoch"]:
        raise AssertionError(f"transfer_study {out['transfer']}")
    # (d) the roofline on the card's measured rates, with (a)'s E3 and E3-8
    rates = roofline.probe(dev)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    print(f"phase 3: roofline rates measured on the card: HBM {rates['hbm'] / 1e9:.1f} GB/s, int8 "
          f"{rates['int8'] / 1e12:.1f} TOP/s, bf16 {rates['bf16'] / 1e12:.1f} TFLOP/s, L2 {l2 / 2 ** 20:.1f} MiB "
          f"[{card}]")
    measured = {(ds.name, "gcn", r["bits"]): r["epoch_ms"] for r in out["run_all"]
                if r["engine"] == "qgtc" and r["mode"] == "mega"}
    out["roofline"] = roofline.dataset_rows(ds, batcher, [2, 8], ["gcn"], card, measured, rates, l2)
    for r in out["roofline"]:
        if r["measured_ms"] is None or r["measured_ms"] < r["floor_ms_card"]:
            raise AssertionError(f"roofline: measured below the floor on the card's rates (a wrong count): {r}")
    out["rates"] = rates
    # (e) partition quality on Proteins
    prot = load_dataset("Proteins")
    out["partition_quality"] = [partition_quality.method_row(prot, m, 1500, 20, card)
                                for m in partition_quality.METHODS]
    for r in out["partition_quality"]:
        print(r, flush=True)
    # (f) the ring's overlap, link volume and timing; its logits gates
    out["ring_overlap"] = ring_overlap.rows(dev)
    out["launches"], out["seconds"] = launches, time.perf_counter() - t0
    print(f"phase 3: studies (run_all, zero_tile_study, transfer_study, roofline, partition_quality, ring_overlap) "
          f"at C1: every gate passed; run_all launches {launches} ({out['seconds']:.1f} s) [{card}]")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    from types import SimpleNamespace

    from torch_cases import (BF16_REL_TOL, baseline_case, bf16_rel_err, blocky_levels, chain_shifts, edge_operands,
                             hand_map, k1_group, k1_groups, k2_chain, k2_group, k2_groups, k3_group, k3_groups,
                             k4_group, k4_groups, k5_group, k5_groups, k6_group, k6_groups, levels_plane, mega_case,
                             operands)
    from qgtc_ppopp22_tpu_torch import cli
    from qgtc_ppopp22_tpu_torch.bench import card_line
    from qgtc_ppopp22_tpu_torch.benchmarks import (exp_bitcast_probe, exp_packmm, gemm_times, grid_overhead_study,
                                                   kernel_sweep)
    from qgtc_ppopp22_tpu_torch.graph import ClusterBatcher, load_dataset
    from qgtc_ppopp22_tpu_torch.models.layers import QGCNConv, QGINConv
    from qgtc_ppopp22_tpu_torch.models.qmodels import qgcn_forward, qgcn_golden
    from qgtc_ppopp22_tpu_torch.ops import _build, bitgemm, digitmm, fused_model, packmm
    from qgtc_ppopp22_tpu_torch.ops.bitpack import num_digits, pack_bits, pack_bits_np, unpack_bits
    from qgtc_ppopp22_tpu_torch.ops.digits import (DigitTensor, digit_levels, digit_pack, digit_unpack,
                                                   to_digit_tensor)
    from qgtc_ppopp22_tpu_torch.ops.packmm import (PackedTensor, pack_rows, packed_levels, prepare_rhs, unpack_rows,
                                                   unpack_rows_np)
    from qgtc_ppopp22_tpu_torch.runtime import (BaselineEngine, QGTCEngine, SparseEngine, mega_block_occ,
                                                mega_block_sched,
                                                mega_chunk_occ)
    from qgtc_ppopp22_tpu_torch.utils.timing import device_times_ms, kernel_launches

    dev = torch.device("cuda")
    start = time.perf_counter()
    card = card_line(dev)
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")

    # -- phase 0: build -------------------------------------------------
    secs, report = _build.build()
    _build.library()
    print(f"phase 0: built {_build.LIB_PATH.name} in {secs:.1f} s")
    entry = ""
    # K1-K6: one line each for all their instantiations
    k2_regs, k2_spill, k6_regs, k6_spill, k1_regs, k1_spill, k3_regs, k3_spill = {}, {}, {}, {}, {}, {}, {}, {}
    k5_regs, k5_spill, k4_regs, k4_spill, serialized = {}, {}, {}, {}, []
    p1_regs, p1_spill = {}, {}  # P1a's kernel, likewise
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            k = re.search(r"exp_packmm_kernelILi(\d)ELi(\d)ELi(\d+)E", entry)
            if k:
                variant = ("concat", "slabs", "noextract", "bres", "bres_chunk", "int8", "rowrange")[int(k[1])]
                entry = f"exp_packmm_kernel<{variant}, f {k[2]}, {k[3]} columns>"
                p1_spill[entry] = 0
                continue
            k = re.search(r"k2_kernelILi(\d)ELi(\d)ELi(\d+)ELb(\d)ELb(\d)E", entry)
            if k:
                entry = (f"k2_kernel<{k[1]}-bit A, {k[2]} B plane(s), {k[3]} columns"
                         f"{', mapped' if k[4] == '1' else ''}{', packed words' if k[5] == '1' else ''}>")
                k2_spill[entry] = 0
                continue
            k = re.search(r"k4_kernelILi(\d)ELi(\d)ELi(\d+)ELb(\d)ELb(\d)E", entry)
            if k:
                entry = (f"k4_kernel<{k[1]} B plane(s), {('', 'colsum', 'PreparedRHS')[int(k[2])]}, {k[3]} "
                         f"columns{', mapped' if k[4] == '1' else ''}{', packed words' if k[5] == '1' else ''}>")
                k4_spill[entry] = 0
                continue
            k = re.search(r"k6_kernelILi(\d)ELi(\d)ELi(\d+)ELb(\d)E", entry)
            if k:
                entry = f"k6_kernel<{k[1]}x{k[2]} planes, {k[3]} columns{', mapped' if k[4] == '1' else ''}>"
                k6_spill[entry] = 0
                continue
            k = re.search(r"k3_kernelILi(\d)ELi(\d)ELi(\d+)ELb(\d)E", entry)
            if k:
                entry = f"k3_kernel<{k[1]}x{k[2]} planes, {k[3]} columns{', mapped' if k[4] == '1' else ''}>"
                k3_spill[entry] = 0
                continue
            k = re.search(r"k5_kernelILi(\d+)E", entry)
            if k:
                entry = f"k5_kernel<{k[1]} update n-tiles>"
                k5_spill[entry] = 0
                continue
            k = re.search(r"k1_kernelILi(\d)ELi(\d)ELi(\d)ELi(\d)ELi(\d+)E", entry)
            if k:
                entry = (f"k1_kernel<{('digits', 'split', 'signed')[int(k[1])]} X x{k[2]}, W x{k[3]}, "
                         f"H x{k[4]}, {k[5]} rows>")
                k1_spill[entry] = 0
                continue
            entry = next((entry[entry.find(k):][:60] for k in ("packedout_kernel", "bitcast",
                                                                  "fragment_probe", "zero_body_kernel",
                                                                  "kdot_kernel")
                          if k in entry), entry[-60:])
        elif "wgmma" in line and "serialized" in line:  # ptxas C7512 / C7520
            serialized.append((entry, line.strip()))
        elif entry in k2_spill or entry in k6_spill or entry in k1_spill or entry in k3_spill or entry in k5_spill \
                or entry in k4_spill or entry in p1_spill:
            regs, spill = ((k2_regs, k2_spill) if entry in k2_spill else
                           (p1_regs, p1_spill) if entry in p1_spill else
                           (k4_regs, k4_spill) if entry in k4_spill else
                           (k6_regs, k6_spill) if entry in k6_spill else
                           (k3_regs, k3_spill) if entry in k3_spill else
                           (k5_regs, k5_spill) if entry in k5_spill else (k1_regs, k1_spill))
            if "Used" in line:
                regs[entry] = int(re.search(r"Used (\d+) registers", line)[1])
            elif "spill" in line:
                spill[entry] += sum(map(int, re.findall(r"(\d+) bytes spill", line)))
        elif "Used" in line:
            print(f"  ptxas: {entry}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"):
            print(f"  ptxas: {entry}: {line.strip()}")
    if len(k2_regs) != 72 or any(k2_spill.values()):
        raise AssertionError(f"k2_kernel: {len(k2_regs)} instantiations (want 72), spills "
                             f"{ {k: v for k, v in k2_spill.items() if v} }")
    print(f"  ptxas: k2_kernel, {len(k2_regs)} instantiations (field 1/2/4 x B planes 1/2 x columns "
          f"16/32/64 x dense/mapped x per-tile/packed words): {min(k2_regs.values())}-"
          f"{max(k2_regs.values())} registers, 0 bytes of spill")
    if len(k4_regs) != 30 or any(k4_spill.values()) or any(e in k4_spill for e, _ in serialized):
        raise AssertionError(f"k4_kernel: {len(k4_regs)} instantiations (want 30), spills "
                             f"{ {k: v for k, v in k4_spill.items() if v} }, serialized: {serialized}")
    print(f"  ptxas: k4_kernel, {len(k4_regs)} instantiations (PreparedRHS x columns 16/32/64 x per-tile/packed "
          f"words; colsum x B planes 1/2 x columns x dense/mapped x per-tile/packed words): "
          f"{min(k4_regs.values())}-{max(k4_regs.values())} registers, 0 bytes of spill, no serialized wgmma")
    if len(k6_regs) != 48 or any(k6_spill.values()):
        raise AssertionError(f"k6_kernel: {len(k6_regs)} instantiations (want 48), spills "
                             f"{ {k: v for k, v in k6_spill.items() if v} }")
    print(f"  ptxas: k6_kernel, {len(k6_regs)} instantiations (planes 1x1/1x2/1x4/1x8/2x2/4x4/8x8/run-time x "
          f"columns 16/32/64 x dense/mapped): {min(k6_regs.values())}-{max(k6_regs.values())} registers, "
          f"0 bytes of spill; " + ", ".join(f"{k} {v}" for k, v in k6_regs.items() if "16 columns>" in k))

    if len(k3_regs) != 16 or any(k3_spill.values()):
        raise AssertionError(f"k3_kernel: {len(k3_regs)} instantiations (want 16), spills "
                             f"{ {k: v for k, v in k3_spill.items() if v} }")
    print(f"  ptxas: k3_kernel, {len(k3_regs)} instantiations (planes 1x1/1x2/2x1/2x2 x columns 16/32 x "
          f"dense/mapped): {min(k3_regs.values())}-{max(k3_regs.values())} registers, 0 bytes of spill")
    if len(k5_regs) != 2 or any(k5_spill.values()) or serialized:
        raise AssertionError(f"k5_kernel: {len(k5_regs)} instantiations (want 2), spills "
                             f"{ {k: v for k, v in k5_spill.items() if v} }, serialized wgmma: {serialized}")
    print(f"  ptxas: k5_kernel, 2 instantiations: " + ", ".join(f"{k} {v} registers" for k, v in k5_regs.items())
          + ", 0 bytes of spill, no serialized wgmma")
    if len(k1_regs) != 34 or any(k1_spill.values()):
        raise AssertionError(f"k1_kernel: {len(k1_regs)} instantiations (want 34), spills "
                             f"{ {k: v for k, v in k1_spill.items() if v} }")
    print(f"  ptxas: k1_kernel, {len(k1_regs)} instantiations (X digits x1/x2, split x1/x2, signed x W "
          f"planes x H planes x 64/128 rows): {min(k1_regs.values())}-{max(k1_regs.values())} registers, "
          f"0 bytes of spill; " + ", ".join(f"{k} {v}" for k, v in k1_regs.items() if "x1, W x1, H x1" in k))
    if len(p1_regs) != 57 or any(p1_spill.values()):
        raise AssertionError(f"exp_packmm_kernel: {len(p1_regs)} instantiations (want 57), spills "
                             f"{ {k: v for k, v in p1_spill.items() if v} }")
    print(f"  ptxas: exp_packmm_kernel (P1a), {len(p1_regs)} instantiations (6 packed variants x f 1/2/4 x "
          f"columns 16/32/64, int8 x columns): {min(p1_regs.values())}-{max(p1_regs.values())} registers, "
          f"0 bytes of spill; " + ", ".join(f"{k} {v}" for k, v in p1_regs.items() if "f 1, 16 columns" in k))

    # -- phase 1: kernel vs plain --------------------------------------
    err = {"packmm": 0.0, "digitmm": 0.0, "fused_model": 0.0, "fused_baseline": 0.0, "bitmm": 0.0,
           "packmm_signed": 0.0, "int_mm": 0.0, "packmm_skip": 0.0, "digitmm_skip": 0.0,
           "fused_model_levels": 0.0, "exp_packmm": 0.0, "exp_packmm_packedout": 0.0, "bitcast32to8": 0.0,
           "bitcast8to32": 0.0, "fragment_probe": 0.0, "zero_body": 0.0, "kdot": 0.0}
    ncase = dict.fromkeys(err, 0)
    worst_rel = 0.0  # fused_baseline, random cases: the worst row's relative error

    def compare(kind, got, want, what):
        if hasattr(got, "planes"):
            if got.shape != want.shape or got.bits != want.bits or got.planes.shape != want.planes.shape:
                raise AssertionError(f"{what}: container shapes differ")
            diff = (unpack_bits(got).long() - unpack_bits(want).long()).abs().max().item()
            same = torch.equal(got.planes, want.planes)
        elif hasattr(got, "words"):
            if got.shape != want.shape or got.bits != want.bits or got.words.shape != want.words.shape \
                    or got.words.dtype != want.words.dtype:
                raise AssertionError(f"{what}: container shapes differ")
            diff = (packed_levels(got) - packed_levels(want)).abs().max().item()
            same = torch.equal(got.words, want.words)
        elif hasattr(got, "digits"):
            if got.shape != want.shape or got.digits.shape != want.digits.shape:
                raise AssertionError(f"{what}: container shapes differ")
            diff = (digit_levels(got) - digit_levels(want)).abs().max().item()
            same = torch.equal(got.digits, want.digits)
        else:
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                                     f"{tuple(want.shape)} {want.dtype}")
            diff = (got.double() - want.double()).abs().max().item()
            same = torch.equal(got, want)
        torch.cuda.synchronize()
        err[kind] = max(err[kind], diff)
        ncase[kind] += 1
        if not same:
            raise AssertionError(f"{what}: kernel != plain (max abs err {diff})")

    def check_pair(qa, qb, a_bits, b_bits, tag, shifts=(0, 2)):
        b = digit_pack(torch.from_numpy(qb).to(dev), b_bits)
        pa = pack_rows(torch.from_numpy(qa).to(dev), a_bits)
        da = digit_pack(torch.from_numpy(qa).to(dev), a_bits)
        for sh in shifts:
            compare("packmm", packmm.packmm_to_digits(pa, b, b_bits, shift=sh),
                    packmm.packmm_plain(pa, b, b_bits, sh), f"packmm_to_digits {tag} shift={sh}")
            compare("digitmm", digitmm.digitmm_to_digits(da, b, b_bits, shift=sh),
                    digitmm.digitmm_plain(da, b, b_bits, sh), f"digitmm_to_digits {tag} shift={sh}")
        compare("packmm", packmm.packmm_to_f32(pa, b), packmm.packmm_plain(pa, b), f"packmm_to_f32 {tag}")
        compare("digitmm", digitmm.digitmm_to_f32(da, b), digitmm.digitmm_plain(da, b), f"digitmm_to_f32 {tag}")

    t0 = time.perf_counter()
    shapes = [(2560, 128, 16), (2560, 2560, 16), (2560, 128, 40), (2560, 2560, 40), (1000, 700, 200)]
    for bits in (1, 2, 4, 8):
        for (M, K, N) in shapes:
            for sh in (0, 2):
                check_pair(*operands(SEED + M + K + N + sh, M, K, N, bits, bits, bits, sh), bits, bits,
                           f"bits={bits} M={M} K={K} N={N}", shifts=(sh,))
        # the slice's own pairing: 1-bit adjacency x bits-wide features
        check_pair(*operands(SEED + bits, 2560, 2560, 16, 1, bits, bits, 0), 1, bits,
                   f"1-bit A x {bits}-bit B")
        for sh in (0, 2):
            qa, qb = edge_operands(bits, sh)
            check_pair(qa, qb, bits, bits, f"requant edges bits={bits}", shifts=(sh,))
    # the whole-model kernel; keep[b][c]: occupied column blocks of row
    # chunk c in batch b (chunks of 0, 1, an odd count and all blocks)
    keeps = {512: [[[0, 1]], [[]]],
             2560: [[[0, 1, 2, 3, 4], [], [2], [0, 2, 4], [1, 3]],
                    [[0, 1, 2], [4], [0, 1, 2, 3, 4], [], [0, 3]]]}
    for pn, keep in keeps.items():
        cb = fused_model.mega_colblock(pn)
        for bits in (1, 2, 4, 8):
            for model in ("gcn", "gin"):
                for shifts in (None, [1, 2, 1, 2, 1]):
                    _, _, qws, aw, xd = mega_case(SEED + bits + pn, 2, pn, bits,
                                                  16 if model == "gcn" else 64, keep=keep,
                                                  cb=cb, shift=1 if shifts else 0)
                    a, x = torch.from_numpy(aw).to(dev), torch.from_numpy(xd).to(dev)
                    ws = [digit_pack(torch.from_numpy(w).to(dev), bits) for w in qws]
                    sched = torch.from_numpy(np.stack(
                        [mega_block_sched(w[None], 512, cb) for w in aw])).to(dev)
                    for blk in (None, sched):
                        kw = dict(model=model, shifts=shifts, out_cols=40 if shifts else None,
                                  blk_sched=blk)
                        compare("fused_model", fused_model.fused_model_epoch(a, x, ws, bits, **kw),
                                fused_model.fused_model_epoch_plain(a, x, ws, bits, **kw),
                                f"fused_model {model} bits={bits} pn={pn} shifts={shifts} "
                                f"sched={blk is not None}")
    # levels-form X: the signed chain (hidden 16: every weight has a free
    # lane) and the in-kernel digit split (hidden 128), dense, scheduled
    # and chunk_occ, each against plain and against the 2-digit route's
    # launch on the same levels (equal, padded columns included)
    lv_forms = {"signed": 0, "split": 0}

    def check_levels(a, xl, x2, ws, out_bits, tag, **kw):
        form = fused_model.plan(a.shape, xl.shape, ws, out_bits, kw["model"], kw.get("shifts"),
                                kw.get("out_cols"), x_levels_bits=kw["x_levels_bits"]).form
        before = fused_model.LEVELS_LAUNCHES
        got = fused_model.fused_model_epoch(a, xl, ws, out_bits, **kw)
        if fused_model.LEVELS_LAUNCHES != before + 1:
            raise AssertionError(f"{tag}: no levels-form launch")
        compare("fused_model_levels", got, fused_model.fused_model_epoch_plain(a, xl, ws, out_bits, **kw),
                f"{tag} ({form})")
        if not torch.equal(got, fused_model.fused_model_epoch(a, x2, ws, out_bits,
                                                              **dict(kw, x_levels_bits=None))):
            raise AssertionError(f"{tag}: levels form != the 2-digit route")
        lv_forms[form] += 1

    def levels_case(seed, B, pn, bits, hidden, **mkw):
        _, _, qws, aw, xd = mega_case(seed, B, pn, bits, hidden, **mkw)
        chunk = 512 if pn % 512 == 0 else 256
        cb = mkw.get("cb", 256)
        occ = np.stack([mega_block_occ(w[None], chunk, cb) for w in aw])
        sched = np.stack([mega_block_sched(w[None], chunk, cb) for w in aw])
        return ([torch.from_numpy(t).to(dev) for t in (aw, levels_plane(xd), xd, occ, sched)],
                [digit_pack(torch.from_numpy(w).to(dev), bits) for w in qws])

    for pn, keep in keeps.items():
        cb = fused_model.mega_colblock(pn)
        for bits in (5, 8):
            for model in ("gcn", "gin"):
                for hidden in (16, 128):
                    for feat in (100, 128):
                        for shifts in (None, [1, 2, 1, 2, 1]):
                            (a, xl, x2, occ, sched), ws = levels_case(
                                SEED + bits + pn + hidden + feat, 2, pn, bits, hidden, keep=keep, cb=cb,
                                feat=feat, shift=1 if shifts else 0)
                            for zname, zkw in (("dense", {}), ("blk_sched", dict(blk_sched=sched)),
                                               ("chunk_occ", dict(chunk_occ=occ))):
                                check_levels(a, xl, x2, ws, bits,
                                             f"fused_model levels {model} bits={bits} pn={pn} hidden={hidden} "
                                             f"feat={feat} shifts={shifts} {zname}",
                                             model=model, shifts=shifts, out_cols=40 if shifts else None,
                                             x_levels_bits=bits, **zkw)
    # clamp_bits 4 under 8-bit levels; 3 batches at pn 768 (12 row tiles
    # over a cluster of 8, hidden 48: a 64- and a 32-column tile)
    for model in ("gcn", "gin"):
        for hidden in (16, 128):
            (a, xl, x2, occ, sched), ws = levels_case(SEED + hidden, 2, 512, 8, hidden, shift=2)
            for zkw in ({}, dict(blk_sched=sched)):
                check_levels(a, xl, x2, ws, 4, f"fused_model levels {model} clamp_bits=4 hidden={hidden}",
                             model=model, shifts=[2, 1, 2, 1, 2], out_cols=40, x_levels_bits=8, **zkw)
        (a, xl, x2, occ, sched), ws = levels_case(SEED + 7, 3, 768, 8, 48, shift=1)
        for zkw in ({}, dict(blk_sched=sched), dict(chunk_occ=occ)):
            check_levels(a, xl, x2, ws, 8, f"fused_model levels {model} B=3 pn=768",
                         model=model, shifts=[1, 2, 1, 2, 1], out_cols=40, x_levels_bits=8, **zkw)
    print(f"phase 1: fused_model levels form == plain == the 2-digit route in "
          f"{ncase['fused_model_levels']} cases ({lv_forms})")
    # K1 under every forced plan (torch_cases.k1_groups): each output twice
    t1, k1_cases = time.perf_counter(), 0
    for gid, kw in k1_groups():
        for tag, kernel, plain in k1_group(dev, **kw):
            before = fused_model.LAUNCHES
            got = kernel()
            if fused_model.LAUNCHES != before + 1:
                raise AssertionError(f"{tag}: not one fused_model launch")
            compare("fused_model", got, plain(), tag)
            compare("fused_model", kernel(), got, f"{tag}, computed again")
            k1_cases += 1
    print(f"phase 1: K1 in {len(k1_groups())} case groups under every forced plan ({k1_cases} cases, each "
          f"output twice) == plain ({time.perf_counter() - t1:.1f} s)")
    # the bf16 baseline kernel: bit-exact ("integer", "rounding") and
    # random cases
    for model, hidden in (("sage", 16), ("gin", 64)):
        for layers in (1, 3):
            dims = [128] + [hidden] * (layers - 1) + [40]
            for pn in (512, 2560):
                for kind in ("integer", "rounding", "random"):
                    a, x, ws = baseline_case(SEED + pn + layers + hidden, 2, pn, dims, kind=kind)
                    a, x = torch.from_numpy(a).to(dev), torch.from_numpy(x).to(dev)
                    ws = [torch.from_numpy(w).to(dev) for w in ws]
                    got = fused_model.fused_baseline_epoch(a, x, ws)
                    want = fused_model.fused_baseline_epoch_plain(a, x, ws)
                    torch.cuda.synchronize()
                    what = f"fused_baseline {model} layers={layers} pn={pn} {kind}"
                    if got.shape != want.shape or not torch.isfinite(got).all():
                        raise AssertionError(f"{what}: {tuple(got.shape)} vs {tuple(want.shape)}")
                    err["fused_baseline"] = max(err["fused_baseline"],
                                                (got - want).abs().max().item())
                    ncase["fused_baseline"] += 1
                    if kind != "random":
                        if not torch.equal(got, want):
                            raise AssertionError(f"{what}: kernel != plain bit for bit")
                        continue
                    rel = bf16_rel_err(got, want)
                    worst_rel = max(worst_rel, rel)
                    if rel > BF16_REL_TOL:
                        raise AssertionError(f"{what}: relative error {rel} > {BF16_REL_TOL} in a row")
    # K5 under every forced plan (torch_cases.k5_groups): the "integer" and
    # "rounding" cases bit for bit, "random" within BF16_REL_TOL per row,
    # each output twice
    t1, k5_cases = time.perf_counter(), 0
    for _, kw in k5_groups():
        for tag, kind, kernel, plain in k5_group(dev, **kw):
            before = fused_model.BASELINE_LAUNCHES
            got = kernel()
            if fused_model.BASELINE_LAUNCHES != before + 1:
                raise AssertionError(f"{tag}: not one fused_baseline launch")
            want = plain()
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.isfinite(got).all():
                raise AssertionError(f"{tag}: {tuple(got.shape)} vs {tuple(want.shape)}")
            err["fused_baseline"] = max(err["fused_baseline"], (got - want).abs().max().item())
            if kind != "random":
                if not torch.equal(got, want):
                    raise AssertionError(f"{tag}: kernel != plain bit for bit")
            else:
                rel = bf16_rel_err(got, want)
                worst_rel = max(worst_rel, rel)
                if rel > BF16_REL_TOL:
                    raise AssertionError(f"{tag}: relative error {rel} > {BF16_REL_TOL} in a row")
            if not torch.equal(kernel(), got):
                raise AssertionError(f"{tag}: computed again, the output differs")
            k5_cases += 1
    print(f"phase 1: K5 in {len(k5_groups())} case groups under every forced plan ({k5_cases} cases, each "
          f"output twice) == plain ({time.perf_counter() - t1:.1f} s)")
    # K3 under every forced plan (torch_cases.k3_groups): every out form,
    # bit for bit over the whole padded output, each output twice
    t1, k3_cases = time.perf_counter(), 0
    for _, kw in k3_groups():
        for tag, kernel, plain in k3_group(dev, **kw):
            before = digitmm.LAUNCHES
            got = kernel()
            if digitmm.LAUNCHES != before + 1:
                raise AssertionError(f"{tag}: not one digitmm launch")
            compare("digitmm", got, plain(), tag)
            compare("digitmm", kernel(), got, f"{tag}, computed again")
            k3_cases += 1
    print(f"phase 1: K3 in {len(k3_groups())} case groups under every forced plan ({k3_cases} cases, each "
          f"output twice) == plain ({time.perf_counter() - t1:.1f} s)")

    # the one-bit tensor-core kernel, word for word against plain
    def on_bits(q, bits):
        return pack_bits(torch.from_numpy(q).to(dev), bits)

    def check_bits(a, b, tag, outs=(1, 2, 4, 8, None), tile_map=None):
        for ob in outs:
            got = (bitgemm.bitmm_to_int(a, b, tile_map=tile_map) if ob is None
                   else bitgemm.bitmm_to_bits(a, b, ob, tile_map=tile_map))
            compare("bitmm", got, bitgemm.bitmm_plain(a, b, ob, tile_map),
                    f"bitmm {tag} out_bits={ob} tile_map={tile_map is not None}")

    for a_bits, b_bits in ((1, 1), (1, 2), (2, 2), (3, 5), (4, 4), (8, 8), (1, 8)):
        for (M, K, N) in ((2560, 2560, 16), (2560, 128, 16), (300, 520, 40)):
            qa, qb = operands(SEED + 9 * a_bits + b_bits + M + N, M, K, N, a_bits, b_bits,
                              min(b_bits, 4), 0)
            check_bits(on_bits(qa, a_bits), on_bits(qb, b_bits), f"{a_bits}x{b_bits} M={M} K={K} N={N}")
    for bits in (1, 2, 4, 8):
        qa, qb = edge_operands(bits, 0)
        check_bits(on_bits(qa, 1), on_bits(qb, bits), f"requant edges bits={bits}", outs=(bits,))
        col0 = unpack_bits(bitgemm.bitmm_to_bits(on_bits(qa, 1), on_bits(qb, bits), bits))[:, 0]
        ub = 1 << bits
        if col0[ub - 1] != ub - 1 or col0[ub] != 0 or col0[ub + 1] != ub - 1:
            raise AssertionError(f"bitmm requant edges bits={bits}: {col0[ub - 1:ub + 2].tolist()}")
    rng = np.random.default_rng(SEED)
    qd = np.zeros((2560, 2560), np.int32)  # block diagonal; row tile 2 empty (kcnt 0)
    for s0 in (0, 512, 1536, 2048):
        qd[s0:s0 + 512, s0:s0 + 512] = rng.random((512, 512)) < 0.02
    bd, hb = on_bits(qd, 1), on_bits(rng.integers(0, 4, (2560, 16)).astype(np.int32), 2)
    tmap = bitgemm.build_tile_map(bd)
    if tmap.kcnt.tolist() != [1, 1, 0, 1, 1]:
        raise AssertionError(f"block-diagonal tile map kcnt {tmap.kcnt.tolist()}")
    check_bits(bd, hb, "block-diagonal A", outs=(2, None), tile_map=tmap)
    if not torch.equal(bitgemm.bitmm_to_bits(bd, hb, 2, tile_map=tmap).planes,
                       bitgemm.bitmm_to_bits(bd, hb, 2).planes):
        raise AssertionError("bitmm: the occupancy map changed the product")
    ad = on_bits((rng.random((2560, 2560)) < 0.02).astype(np.int32), 1)
    full = bitgemm.build_tile_map(ad)
    hand = bitgemm.TileMap(full.kidx, torch.tensor([2, 5, 0, 4, 1], dtype=torch.int32, device=dev),
                           full.tile_m, full.tile_k)  # visits fewer than the 5 occupied K tiles
    check_bits(ad, hb, "hand-made map", outs=(2, None), tile_map=hand)
    if torch.equal(bitgemm.bitmm_to_int(ad, hb, tile_map=hand), bitgemm.bitmm_to_int(ad, hb)):
        raise AssertionError("bitmm: a map that omits occupied tiles gave the dense product")
    # K6 (csrc/bitmm_k6.cuh) under every forced column tile and split, to
    # bits and to f32, with and without maps; each output twice
    k6_before, t_k6 = bitgemm.LAUNCHES, time.perf_counter()
    for _, group in k6_groups():
        for tag, kernel, plain in k6_group(dev, **group):
            got = kernel()
            compare("bitmm", got, plain(), f"K6 {tag}")
            compare("bitmm", kernel(), got, f"K6 {tag}, again")
    print(f"phase 1: K6 {len(k6_groups())} case groups, {bitgemm.LAUNCHES - k6_before} launches, each output "
          f"twice, == plain ({time.perf_counter() - t_k6:.1f} s)")
    # K4: the PreparedRHS kernel against packmm_signed_plain, whole outputs
    def check_signed(qa, qb, tag):
        a = pack_rows(torch.from_numpy(qa).to(dev), 8)
        bp = prepare_rhs(digit_pack(torch.from_numpy(qb).to(dev), 8))
        n = qb.shape[1]
        forms = [(None, "f32", 0, False, None), (None, "f32", 0, True, None)]
        forms += [(ob, "digits", sh, False, None) for ob in (2, 4, 8) for sh in (0, 2)]
        forms += [(8, "packed", 0, False, oc) for oc in (None, n)]
        forms += [(ob, "packed", 0, False, n) for ob in (1, 2, 4)]
        for ob, form, sh, raw, oc in forms:
            if ob is None:
                got = packmm.packmm_to_i32(a, bp) if raw else packmm.packmm_to_f32(a, bp)
            elif form == "digits":
                got = packmm.packmm_to_digits(a, bp, ob, shift=sh)
            else:
                got = packmm.packmm_to_packed(a, bp, ob, shift=sh, out_cols=oc)
            compare("packmm_signed", got, packmm.packmm_signed_plain(a, bp, ob, form, sh, raw, oc),
                    f"packmm_signed {tag} out_bits={ob} {form} shift={sh} i32={raw} out_cols={oc}")

    before = packmm.SIGNED_LAUNCHES
    for (M, K, N) in ((700, 300, 60), (700, 300, 120), (1024, 1024, 16), (4096, 4096, 64)):
        check_signed(*operands(SEED + M + N, M, K, N, 8, 8, 8, 0), f"M={M} K={K} N={N}")
    full = np.full((300, 60), 255, np.int32)
    check_signed(np.zeros((700, 300), np.int32), full, "A at level 0, B at 255")
    check_signed(np.full((700, 300), 255, np.int32), full, "A and B at 255")
    check_signed(np.full((256, 32640), 255, np.int32), np.full((32640, 16), 255, np.int32),
                 "K=32640 (largest the guard accepts), A and B at 255")
    if packmm.SIGNED_LAUNCHES - before != ncase["packmm_signed"]:
        raise AssertionError("packmm_signed: a case did not launch the kernel")
    # K2's packed-words epilogue: bit in, bit out, against plain
    for a_bits in (1, 2, 4, 8):
        for b_bits in (1, 2, 4, 8):
            for (M, K, N) in ((2560, 2560, 16), (300, 520, 40), (512, 512, 512), (512, 512, 300)):
                qa, qb = operands(SEED + 9 * a_bits + b_bits + M + N, M, K, N, a_bits, b_bits,
                                  min(b_bits, 4), 0)
                a = pack_rows(torch.from_numpy(qa).to(dev), a_bits)
                b = digit_pack(torch.from_numpy(qb).to(dev), b_bits)
                tag = f"{a_bits}-bit A x {b_bits}-bit B M={M} K={K} N={N}"
                for ob in (1, 2, 4, 8):
                    for oc in (None, N):
                        compare("packmm", packmm.packmm_to_packed(a, b, ob, out_cols=oc),
                                packmm.packmm_plain(a, b, ob, out_form="packed", out_cols=oc),
                                f"packmm_to_packed {tag} out_bits={ob} out_cols={oc}")
                compare("packmm", packmm.packmm_to_f32(a, b, out_cols=N),
                        packmm.packmm_plain(a, b, out_form="f32", out_cols=N),
                        f"packmm_to_f32 {tag} out_cols={N}")
    # the chain: an 8-bit packed (signed plane) output fed back as A
    rng = np.random.default_rng(SEED)
    qx, qw = rng.integers(0, 256, (200, 256)), rng.integers(0, 256, (256, 60))
    qw2 = rng.integers(0, 256, (64, 40))
    x = pack_rows(torch.from_numpy(qx).to(dev), 8)
    w, w2 = (digit_pack(torch.from_numpy(q).to(dev), 8) for q in (qw, qw2))
    xw = packmm.packmm_to_packed(x, w, 8)
    compare("packmm", xw, packmm.packmm_plain(x, w, 8, out_form="packed"), "chain: packed 8-bit out")
    xw2 = PackedTensor(words=xw.words, shape=(200, 64), bits=8)
    compare("packmm", packmm.packmm_to_f32(xw2, w2), packmm.packmm_plain(xw2, w2),
            "chain: the packed output as the next A")

    # K2's 1/2/4-bit kernel (csrc/packmm_k2.cuh): widths 8-200 against one
    # and two B planes at depth 448, every split, hand-made maps at every
    # split, packed words at out_cols 8-200 and chained; each case twice
    k2_before, t_k2 = packmm.LAUNCHES, time.perf_counter()
    for _, group in k2_groups():
        for tag, kernel, plain in k2_group(dev, **group):
            got = kernel()
            compare("packmm", got, plain(), f"K2 {tag}")
            compare("packmm", kernel(), got, f"K2 {tag}, again")
    for a_bits in (1, 2, 4):
        tag, kernel, plain = k2_chain(dev, a_bits)
        got = kernel()
        compare("packmm", got, plain(), f"K2 {tag}")
        compare("packmm", kernel(), got, f"K2 {tag}, again")
    print(f"phase 1: K2 {len(k2_groups())} case groups and 3 chains, {packmm.LAUNCHES - k2_before} launches, "
          f"each output twice, == plain ({time.perf_counter() - t_k2:.1f} s)")
    # K4's kernel (csrc/packmm_k4.cuh): the PreparedRHS product and K2's
    # 8-bit plane, every form under each column tile and split, each twice
    k4_before, t_k4, k4_calls = (packmm.LAUNCHES, packmm.SIGNED_LAUNCHES), time.perf_counter(), 0
    for _, group in k4_groups():
        for tag, kernel, plain in k4_group(dev, **group):
            got = kernel()
            compare("packmm_signed", got, plain(), tag)
            compare("packmm_signed", kernel(), got, f"{tag}, again")
            k4_calls += 2
    if packmm.LAUNCHES - k4_before[0] + packmm.SIGNED_LAUNCHES - k4_before[1] != k4_calls:
        raise AssertionError("K4: a case did not launch the kernel once")
    print(f"phase 1: K4 {len(k4_groups())} case groups under every forced plan, "
          f"{packmm.SIGNED_LAUNCHES - k4_before[1]} PreparedRHS and {packmm.LAUNCHES - k4_before[0]} 8-bit "
          f"plane launches, each output twice, == plain ({time.perf_counter() - t_k4:.1f} s)")

    # zero-tile jumping: K2's and K3's TileMap K skip against plain, with
    # maps from the builders and hand-made ones (occupied tiles left out,
    # a tile listed twice, rows of kcnt 0, -1 and past nk, entries outside
    # the grid), on A whose occupied 256 x 256 tiles are known
    def mapped(mod, kind, tag, run, plain):
        before = (mod.LAUNCHES, mod.MAPPED_LAUNCHES)
        got = run()
        if (mod.LAUNCHES - before[0], mod.MAPPED_LAUNCHES - before[1]) != (1, 1):
            raise AssertionError(f"{tag}: {mod.__name__} did not launch once with its map")
        compare(kind, got, plain(), tag)

    skip_shapes = ((2560, 2560, 16), (2560, 1280, 40), (1792, 1280, 200))  # C1; multi-row-tile, odd remainders
    for a_bits in (1, 2, 4, 8):
        for (M, K, N) in skip_shapes:
            qa = blocky_levels(SEED + a_bits + M + N, M, K, a_bits)
            qb = operands(SEED + N, M, K, N, 1, 2, 2, 0)[1]
            a = pack_rows(torch.from_numpy(qa).to(dev), a_bits)
            b = digit_pack(torch.from_numpy(qb).to(dev), 2)
            for tmk in ((256, 256), (512, 256), (256, 128), (512, 128)):
                if a.padded_rows % tmk[0] or a.padded_cols % tmk[1]:
                    continue
                real = packmm.build_tile_map_packed(a, *tmk)
                for mkind, tm in (("real", real), ("hand", hand_map(real))):
                    tag = f"packmm K skip {a_bits}-bit A M={M} K={K} N={N} tiles={tmk} {mkind} map"
                    mapped(packmm, "packmm_skip", f"{tag} digits",
                           lambda: packmm.packmm_to_digits(a, b, 2, tm, shift=1),
                           lambda: packmm.packmm_plain(a, b, 2, 1, tile_map=tm))
                    mapped(packmm, "packmm_skip", f"{tag} f32",
                           lambda: packmm.packmm_to_f32(a, b, tm, out_cols=N),
                           lambda: packmm.packmm_plain(a, b, out_form="f32", out_cols=N, tile_map=tm))
                    mapped(packmm, "packmm_skip", f"{tag} i32", lambda: packmm.packmm_to_i32(a, b, tm),
                           lambda: packmm.packmm_plain(a, b, raw_i32=True, tile_map=tm))
                    for ob in (1, 2, 4, 8):  # words; 8: the signed byte plane
                        mapped(packmm, "packmm_skip", f"{tag} packed {ob}-bit",
                               lambda: packmm.packmm_to_packed(a, b, ob, tm, out_cols=N),
                               lambda: packmm.packmm_plain(a, b, ob, out_form="packed", out_cols=N,
                                                           tile_map=tm))
                    if mkind == "real" and not torch.equal(packmm.packmm_to_i32(a, b, tm),
                                                           packmm.packmm_to_i32(a, b)):
                        raise AssertionError(f"{tag}: the occupancy map changed the product")
                    if mkind == "hand" and torch.equal(packmm.packmm_to_i32(a, b, tm),
                                                       packmm.packmm_to_i32(a, b)):
                        raise AssertionError(f"{tag}: a map that leaves tiles out gave the dense product")
    for a_bits in (2, 8):  # 1 and 2 digit planes on each side
        for b_bits in (2, 8):
            M, K, N = 1280, 1536, 40
            qa = blocky_levels(SEED + a_bits * 3 + b_bits, M, K, a_bits, density=0.01)
            qb = operands(SEED + b_bits, M, K, N, 1, b_bits, b_bits, 0)[1]
            da = digit_pack(torch.from_numpy(qa).to(dev), a_bits)
            b = digit_pack(torch.from_numpy(qb).to(dev), b_bits)
            for tmk in ((256, 256), (128, 128), (256, 128), (128, 256)):
                real = digitmm.build_tile_map_digits(da, *tmk)
                for mkind, tm in (("real", real), ("hand", hand_map(real))):
                    tag = f"digitmm K skip {a_bits}x{b_bits} bits tiles={tmk} {mkind} map"
                    mapped(digitmm, "digitmm_skip", f"{tag} digits",
                           lambda: digitmm.digitmm_to_digits(da, b, b_bits, tm, shift=2),
                           lambda: digitmm.digitmm_plain(da, b, b_bits, 2, tile_map=tm))
                    mapped(digitmm, "digitmm_skip", f"{tag} f32", lambda: digitmm.digitmm_to_f32(da, b, tm),
                           lambda: digitmm.digitmm_plain(da, b, tile_map=tm))
                    mapped(digitmm, "digitmm_skip", f"{tag} i32", lambda: digitmm.digitmm_to_i32(da, b, tm),
                           lambda: digitmm.digitmm_plain(da, b, raw_i32=True, tile_map=tm))

    # the kernel-study probes: P1's template in every variant (noextract
    # against its own plain version) and its packed out under every forced
    # plan, P2's bitcasts and fragment registers, P3's zero body and K-dot
    # under every forced plan
    def probe_words(seed, m, k, np_, bits, tm, dense=True):
        rng = np.random.default_rng(seed)
        qa = rng.integers(0, 1 << bits, (m, k)) if dense else operands(seed, m, k, 16, bits, bits, bits, 0)[0]
        qb = rng.integers(0, 1 << bits, (k, np_))
        qb[:, 1] *= -1  # sums below 0
        return (qa, torch.from_numpy(exp_packmm.pack_rows_np(qa, bits, tm)[None]).to(dev),
                torch.from_numpy(qb.astype(np.int8)[None]).to(dev))

    # each output of a forced plan twice, its block first filled with each
    # of `fills` (freed: the output may take it), so that an element the
    # kernel leaves unwritten shows
    def twice(kind, run, want, what, fills):
        for i, fill in enumerate(fills):
            torch.full_like(want, fill)
            compare(kind, run(), want, what if i == 0 else f"{what}, computed again")

    # P1a (csrc/exp_packmm.cuh: the probes' ring, word-row CTAs, split-K):
    # every variant at its default plan at 1, 2 and 4 bits over tm 256 and
    # 512, 16-64 columns, K of 2-10 deep steps; each variant also on each
    # K step that divides K with 3 slots; then concat, slabs and int8 under
    # every forced plan (column tile x split 1-8 x slots x K step) at C1's
    # shape and at 4096^2 x 64, each output twice
    t1, p1_before, p1_calls = time.perf_counter(), exp_packmm.LAUNCHES, 0
    for bits in (1, 2, 4):
        for (M, K, Np, tm) in ((512, 256, 16, 256), (768, 640, 64, 256), (1024, 512, 48, 512), (2560, 2560, 16, 256)):
            qa, words, b = probe_words(SEED + bits + M + Np, M, K, Np, bits, tm)
            a8 = torch.from_numpy(qa.astype(np.int8)[None]).to(dev)
            tag = f"bits={bits} M={M} K={K} Np={Np} tm={tm}"
            ref = exp_packmm.packmm_exp_plain(words, b, bits, tm)
            runs = {v: (lambda pl=None, v=v: exp_packmm.packmm_exp(words, b, bits, tm, v, _plan=pl),
                        exp_packmm.packmm_exp_plain(words, b, bits, tm, v) if v == "noextract" else ref)
                    for v in exp_packmm.VARIANTS if not v.startswith("bres") or exp_packmm.bres_fits(M, K, Np, bits, tm)}
            runs["int8"] = (lambda pl=None: exp_packmm.packmm_exp_int8(a8, b, _plan=pl), ref)
            if tm == 256:
                runs["rowrange"] = (lambda pl=None: exp_packmm.packmm_exp_rowrange(words, b, bits, _plan=pl), ref)
            for v, (run, want) in runs.items():
                compare("exp_packmm", run(), want, f"packmm_exp {v} {tag}")
                p1_calls += 1
                for depth in (d for d in exp_packmm.DEPTHS if K % d == 0):
                    plan = exp_packmm.exp_packmm_plan(M, K, Np, bits, tm, v, stages=3, depth=depth)
                    compare("exp_packmm", run(plan), want, f"packmm_exp {v} {tag} plan {plan}")
                    p1_calls += 1
    for M, K, Np, bits in ((2560, 2560, 16, 1), (4096, 4096, 64, 1), (4096, 4096, 64, 2), (4096, 4096, 64, 4)):
        qa, words, b = probe_words(SEED + bits + M + Np, M, K, Np, bits, 256)
        a8 = torch.from_numpy(qa.astype(np.int8)[None]).to(dev)
        ref = exp_packmm.packmm_exp_plain(words, b, bits, 256)
        for v, run in (("concat", lambda pl: exp_packmm.packmm_exp(words, b, bits, 256, "concat", _plan=pl)),
                       ("slabs", lambda pl: exp_packmm.packmm_exp(words, b, bits, 256, "slabs", _plan=pl)),
                       ("int8", lambda pl: exp_packmm.packmm_exp_int8(a8, b, _plan=pl))):
            if v == "int8" and bits != 1:
                continue  # one int8 A a shape
            for bnt, splits, stages, depth in itertools.product(
                    exp_packmm.TILES, range(1, exp_packmm.MAX_SPLIT + 1), exp_packmm.STAGES,
                    exp_packmm.DEPTHS):
                try:
                    plan = exp_packmm.exp_packmm_plan(M, K, Np, bits, 256, v, bnt, splits, stages, depth)
                except ValueError:
                    continue
                twice("exp_packmm", lambda: run(plan), ref,
                      f"packmm_exp {v} bits={bits} M=K={M} Np={Np} plan {plan}", (-1.0, float("nan")))
                p1_calls += 2
    if exp_packmm.LAUNCHES - p1_before != p1_calls:
        raise AssertionError("P1a: a case did not launch the kernel once")
    print(f"phase 1: P1a every variant at its default plan and each K step, then concat, slabs and int8 under "
          f"every forced plan, {p1_calls} launches (forced plans twice), == plain "
          f"({time.perf_counter() - t1:.1f} s)")

    # P1b's packed output (csrc/exp_packmm_packed.cu: CTAs that own whole
    # word rows) under every forced plan of packedout_plan (column tile; K
    # step of 64, 128 or 256 columns, so 12, 6 or 3 steps over K 768; split
    # of 1-8, uneven shares included; ring depth), at 1, 2 and 4 bits over
    # layout tiles of 256-4096 rows (2 to 3 tiles, or one of 4096), Np 16,
    # 48 and 64, sums below 0; filled with -1, then 0
    t1, po_before, po_calls = time.perf_counter(), exp_packmm.PACKEDOUT_LAUNCHES, 0
    for bits in (1, 2, 4):
        for g, M in ((256, 768), (512, 1024), (768, 1536), (1024, 2048), (4096, 4096)):
            for Np in (16, 48, 64):
                K = 768
                _, words, b = probe_words(SEED + bits + g + Np, M, K, Np, bits, g, dense=False)
                group = 0 if g == M else g  # layout tile g: as tm, or as the group of a tm of M
                want = exp_packmm.packmm_exp_packedout_plain(words, b, bits, M, group)
                for bnt, splits, stages, depth in itertools.product(
                        exp_packmm.TILES, range(1, exp_packmm.MAX_SPLIT + 1),
                        exp_packmm.STAGES, exp_packmm.DEPTHS):
                    try:
                        plan = exp_packmm.packedout_plan(M, K, Np, bits, g, bnt, splits, stages, depth)
                    except ValueError:
                        continue
                    twice("exp_packmm_packedout",
                          lambda: exp_packmm.packmm_exp_packedout(words, b, bits, M, group, _plan=plan),
                          want, f"packmm_exp_packedout bits={bits} M={M} K={K} Np={Np} g={g} plan {plan}", (-1, 0))
                    po_calls += 2
    if exp_packmm.PACKEDOUT_LAUNCHES - po_before != po_calls:
        raise AssertionError("P1b: a case did not launch the kernel once")
    print(f"phase 1: P1b packed out (word-row CTAs) under every forced plan, {po_calls} launches, each output "
          f"twice, == plain ({time.perf_counter() - t1:.1f} s)")
    # P2: the probes' shapes, P2b's vector path (n % 4 == 0) and its tail,
    # then 16 MB and 128 MB of bytes (int32 [1024x4096], [4096x8192]); P2b
    # after its output's block is filled with -1, and the round trip back
    # to x, each call counted by the wrapper
    p2_shapes = ((8, 128), (5, 40), (64, 300), (16, 6), (3, 7), (1, 1), (1024, 4096), (4096, 8192))
    t1, exp_bitcast_probe.TO32_LAUNCHES = time.perf_counter(), 0
    for shape in p2_shapes:
        x = torch.from_numpy(np.random.default_rng(shape[1]).integers(-2**31, 2**31, shape).astype(np.int32)).to(dev)
        y = exp_bitcast_probe.bitcast32to8(x)
        compare("bitcast32to8", y, exp_bitcast_probe.bitcast32to8_plain(x), f"bitcast32to8 {shape}")
        want = exp_bitcast_probe.bitcast8to32_plain(y)
        torch.full(shape, -1, dtype=torch.int32, device=dev)  # a freed block the output may reuse
        compare("bitcast8to32", exp_bitcast_probe.bitcast8to32(y), want, f"bitcast8to32 {tuple(y.shape)}")
        compare("bitcast8to32", exp_bitcast_probe.bitcast8to32(y), x, f"bitcast8to32(bitcast32to8) {shape}")
        del x, y, want
    p2_launches = exp_bitcast_probe.TO32_LAUNCHES
    if p2_launches != 2 * len(p2_shapes):
        raise AssertionError(f"P2b: {p2_launches} launches, not {2 * len(p2_shapes)}")
    print(f"phase 1: P2 bitcasts at {len(p2_shapes)} shapes to 128 MB, P2b on its vector path and tail "
          f"({p2_launches} launches), == plain, round trip == x ({time.perf_counter() - t1:.1f} s)")
    tiles = torch.from_numpy(np.random.default_rng(SEED).integers(-128, 128, (2, 64, 64)).astype(np.int8)).to(dev)
    for got, want in zip(exp_bitcast_probe.fragment_registers(tiles[0], tiles[1]),
                         exp_bitcast_probe.fragment_registers_plain(tiles[0], tiles[1])):
        compare("fragment_probe", got, want, "fragment registers of a random tile")
    # zero body: small shapes, then the study's geometry (pn 1024 and 2048:
    # 4 and 8 row tiles of 128 over clusters of 4 and 8; G 5: 5 batches a
    # cluster), each on K1's rows a CTA and forced to 64
    nan = float("nan")
    for B, pn, G, xp, oc in [(6, 512, G, xp, oc) for G in (1, 3) for xp, oc in ((128, 8), (128, 48), (64, 120))] \
            + [(10, pn, G, 128, 48) for pn in (1024, 2048) for G in (1, 5)]:
        x = torch.from_numpy(np.random.default_rng(G + oc + pn).integers(-128, 128, (B, pn, xp)).astype(np.int8)).to(dev)
        want = grid_overhead_study.zero_body_plain(x, oc, G)
        for rows in (None, 64):
            twice("zero_body", lambda: grid_overhead_study.zero_body(x, oc, G, rows), want,
                  f"zero_body B={B} pn={pn} G={G} xp={xp} oc={oc} rows={rows}", (nan, nan))
    # P3b's K-dot (K1's ring, the roll as an address) under every forced
    # plan of kdot_plan (rows a CTA, cluster, ring depth): 640 is 5 row
    # tiles of 128 or 10 of 64 over clusters up to 8, 2048 the study's; K
    # 0-2, oc 8, 48 and 120; NaN fills
    t1, kd_before, kd_calls = time.perf_counter(), grid_overhead_study.KDOT_LAUNCHES, 0
    for pn in (256, 640, 2048):
        rng = np.random.default_rng(pn)
        x = torch.from_numpy(rng.integers(-128, 128, (3, pn, 128)).astype(np.int8)).to(dev)
        s = torch.from_numpy(rng.integers(-128, 128, (pn, pn)).astype(np.int8)).to(dev)
        for K in (0, 1, 2):
            for oc in (8, 48, 120):
                want = grid_overhead_study.kdot_plain(x, s, oc, K)
                for rows in (r for r in grid_overhead_study.ROWS if pn % r == 0):
                    for cl, stages in itertools.product(
                            range(1, min(grid_overhead_study.MAX_CLUSTER, pn // rows) + 1),
                            grid_overhead_study.STAGES):
                        plan = grid_overhead_study.kdot_plan(pn, oc, K, rows, cl, stages)
                        twice("kdot", lambda: grid_overhead_study.kdot(x, s, oc, K, _plan=plan), want,
                              f"kdot pn={pn} K={K} oc={oc} plan {plan}", (nan, nan))
                        kd_calls += 2
    if grid_overhead_study.KDOT_LAUNCHES - kd_before != kd_calls:
        raise AssertionError("P3b: a case did not launch the kernel once")
    print(f"phase 1: P3b kdot under every forced plan, {kd_calls} launches, each output twice, == plain "
          f"({time.perf_counter() - t1:.1f} s)")
    print(f"phase 1: kernel == plain exactly in {ncase} cases (fused_baseline: the integer "
          f"and rounding ones; worst row's relative error of its random ones {worst_rel:.3e}) "
          f"({time.perf_counter() - t0:.1f} s); max abs err {err}")

    # -- phase 2: the main path ----------------------------------------
    t0 = time.perf_counter()
    ds = load_dataset("ogbn-arxiv", data_dir="qgtc_graphs")
    batcher = ClusterBatcher(ds, psize=1500, batch_size=20, bit_width=2, seed=SEED,
                             cache_dir="./datasets")
    nb = len(batcher)
    host_s = time.perf_counter() - t0
    if nb != 75:
        raise AssertionError(f"expected 75 batches, got {nb}")
    # the default partition is the JAX package's: 'auto' resolved to the
    # native multilevel partitioner (the card's host has g++), and the
    # native densify / quantize / pack of every batch equal to the NumPy
    # path's byte for byte (the same partition, from the cache, built
    # again with native=False); bit_A of 4 batches against NumPy's packer
    if batcher.partition_method != "native":
        raise AssertionError(f"partition 'auto' resolved to {batcher.partition_method!r}, want 'native'")
    t1 = time.perf_counter()
    numpy_batcher = ClusterBatcher(ds, psize=1500, batch_size=20, bit_width=2, seed=SEED,
                                   cache_dir="./datasets", native=False)
    numpy_s = time.perf_counter() - t1
    for i, (b, nb_) in enumerate(zip(batcher.batches, numpy_batcher.batches)):
        pn_ = b.padded_nodes
        pairs = [("nodes", b.nodes, nb_.nodes), ("a_words", b.a_words.numpy(), nb_.a_words.numpy()),
                 ("bit_X", b.bit_X.planes.numpy(), nb_.bit_X.planes.numpy()),
                 ("tile map", b.tile_kidx.numpy(), nb_.tile_kidx.numpy()),
                 ("tile counts", b.tile_kcnt.numpy(), nb_.tile_kcnt.numpy())]
        if i < 4:
            pairs.append(("bit_A", b.bit_A.planes.numpy(),
                          pack_bits_np(unpack_rows_np(nb_.a_words.numpy(), 1)[:pn_, :pn_], 1).planes.numpy()))
        for what_, x_, y_ in pairs:
            if not np.array_equal(x_, y_):
                raise AssertionError(f"native batch {i} {what_} != the NumPy path's")
    del numpy_batcher
    c1_listed, c1_tiles = batcher.tile_counts()
    print(f"phase 2: {ds.name} {ds.num_nodes} nodes {ds.graph.num_edges} edges, partition 'auto' -> "
          f"{batcher.partition_method}, {nb} batches, buckets {batcher.buckets()} "
          f"({', '.join(str(sum(b.padded_nodes == p for b in batcher.batches)) for p in batcher.buckets())} "
          f"batches), K tiles listed {c1_listed}/{c1_tiles}, host pipeline {host_s:.1f} s; native densify / "
          f"quantize / pack of {nb} batches == the NumPy path byte for byte (which took {numpy_s:.1f} s "
          f"on the cached partition)")
    eng = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gcn",
                     bit_width=2, seed=SEED, device=dev)
    eng.warmup(batcher)
    packmm.LAUNCHES = digitmm.LAUNCHES = fused_model.LAUNCHES = bitgemm.LAUNCHES = 0
    logits = eng.forward_all(batcher)
    torch.cuda.synchronize()
    launches = {"packmm": packmm.LAUNCHES, "digitmm": digitmm.LAUNCHES,
                "fused_model": fused_model.LAUNCHES, "bitmm": bitgemm.LAUNCHES}
    if launches != {"packmm": 3 * nb, "digitmm": 3 * nb, "fused_model": 0, "bitmm": 0}:
        raise AssertionError(f"main path launches {launches}, want 3 each per batch")
    ref = eng.forward_all(batcher, plain=True)
    for b, got, want in zip(batcher.batches, logits, ref):
        if got.shape != (b.padded_nodes, ds.num_classes) or not torch.isfinite(got).all():
            raise AssertionError(f"bad logits {tuple(got.shape)}")
        n = b.num_nodes
        if not torch.equal(got[:n, :ds.num_classes], want[:n, :ds.num_classes]):
            raise AssertionError("main path: kernel logits != plain logits")
    # independent NumPy integer reference for the first batch
    b0 = batcher.batches[0]
    a_lv = packed_levels(eng.put_batch(b0)[0]).cpu().numpy().astype(np.int64)
    h = unpack_bits(b0.bit_X).numpy().astype(np.int64)
    ws = [digit_unpack(w).cpu().numpy().astype(np.int64) for w in eng.weights]

    def requant(acc):
        return np.where(acc > 4, 3, np.where(acc < 0, 1, acc)) & 3

    for i, w in enumerate(ws):
        h = requant(h @ w)
        if i < len(ws) - 1:
            h = requant(a_lv[:, : h.shape[0]] @ h)
    golden = (a_lv[:, : h.shape[0]] @ h).astype(np.float32)
    if not np.array_equal(logits[0].cpu().numpy(), golden[: b0.padded_nodes]):
        raise AssertionError("main path: batch 0 logits != NumPy integer reference")
    nz = sum(int((lg[:bb.num_nodes] != 0).sum()) for lg, bb in zip(logits, batcher.batches))
    accuracy = eng.evaluate(batcher, ds.labels)
    print(f"phase 2: GCN logits of {nb} batches == plain == NumPy reference (batch 0); "
          f"launches {launches}; nonzero logits {nz}; accuracy {accuracy:.4f}")

    # zero-tile jumping on the same batches: the step engine with each
    # batch's pack-time TileMap, every aggregation one mapped packmm launch
    t0 = time.perf_counter()
    zeng = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gcn",
                      bit_width=2, seed=SEED, device=dev, zerotile_jump=True)
    zeng.warmup(batcher)
    packmm.LAUNCHES = packmm.MAPPED_LAUNCHES = digitmm.LAUNCHES = digitmm.MAPPED_LAUNCHES = 0
    fused_model.LAUNCHES = bitgemm.LAUNCHES = 0
    zlogits = zeng.forward_all(batcher)
    torch.cuda.synchronize()
    zero_launches = {"packmm": packmm.LAUNCHES, "packmm with a map": packmm.MAPPED_LAUNCHES,
                     "digitmm": digitmm.LAUNCHES, "digitmm with a map": digitmm.MAPPED_LAUNCHES,
                     "fused_model": fused_model.LAUNCHES, "bitmm": bitgemm.LAUNCHES}
    if zero_launches != {"packmm": 3 * nb, "packmm with a map": 3 * nb, "digitmm": 3 * nb,
                         "digitmm with a map": 0, "fused_model": 0, "bitmm": 0}:
        raise AssertionError(f"zero-tile path launches {zero_launches}, want 3 mapped packmm and "
                             f"3 digitmm per batch")
    for got, want, dense in zip(zlogits, zeng.forward_all(batcher, plain=True), logits):
        if not torch.equal(got, want) or not torch.equal(got, dense):
            raise AssertionError("zero-tile path: logits != plain / dense step engine logits")
    if not np.array_equal(zlogits[0].cpu().numpy(), golden[: b0.padded_nodes]):
        raise AssertionError("zero-tile path: batch 0 logits != NumPy integer reference")
    tiles_processed, tiles_total = batcher.tile_counts()
    # evaluation after the mega engine's epochs with zerotile_jump=True
    zeng.run_epochs_mega(batcher, n_epochs=1)
    zaccuracy = zeng.evaluate(batcher, ds.labels)
    if zaccuracy != accuracy or not all(bk["compact"] for bk in zeng.mega_buckets):
        raise AssertionError(f"zero-tile accuracy {zaccuracy} != {accuracy}, or mega not compact")
    print(f"phase 2: zero-tile GCN logits of {nb} batches == plain == dense step engine == NumPy "
          f"reference (batch 0); launches {zero_launches}; tiles processed "
          f"{tiles_processed}/{tiles_total} (jumped {1 - tiles_processed / tiles_total:.1%}); "
          f"accuracy {zaccuracy:.4f} == dense, after the mega engine's epochs too "
          f"({time.perf_counter() - t0:.1f} s)")
    # K3's skip on the slice: the adjacency as a digit plane (qgcn_forward
    # with a digit-plane A and its map), 4 batches
    packmm.LAUNCHES = digitmm.LAUNCHES = digitmm.MAPPED_LAUNCHES = 0
    for b, dense in zip(batcher.batches[:4], logits):
        a_b, x_b, _ = eng.put_batch(b)
        da = DigitTensor(digits=packed_levels(a_b).to(torch.int8)[None], shape=a_b.shape, bits=1)
        got = qgcn_forward(da, to_digit_tensor(x_b), eng.weights, 2,
                           tile_map=digitmm.build_tile_map_digits(da))
        if not torch.equal(got, dense):
            raise AssertionError("digit-plane A with its map: logits != the step engine's")
    digit_a_launches = {"digitmm": digitmm.LAUNCHES, "digitmm_skip": digitmm.MAPPED_LAUNCHES,
                        "packmm": packmm.LAUNCHES}
    if digit_a_launches != {"digitmm": 24, "digitmm_skip": 12, "packmm": 0}:
        raise AssertionError(f"digit-plane A launches {digit_a_launches}")
    print(f"phase 2: GCN over a digit-plane A with its map, 4 batches == step engine; launches "
          f"{digit_a_launches}")
    # K1's chunk_occ at C1: the JAX kernel's predicated map, compacted onto
    # the block-schedule launch; resident_a=False, the same launch
    mfn = eng._stage_mega(batcher)[0][1]
    a_st, x_st, ws_st = mfn.args[:3]
    mkw = dict(mfn.keywords, blk_sched=None)
    k1_dense = fused_model.fused_model_epoch(a_st, x_st, ws_st, 2, **mkw)
    aw_np = a_st.cpu().numpy()
    occ1 = torch.from_numpy(np.stack([mega_chunk_occ(w[None], 512) for w in aw_np]))
    occ2 = torch.from_numpy(np.stack([mega_block_occ(w[None], 512, 512) for w in aw_np]))
    hand1, hand2 = occ1.clone(), occ2.clone()
    hand1[0, int(occ1[0].nonzero()[0])] = 0  # an occupied chunk flagged 0
    hand2[1, 0, int(occ2[1, 0].nonzero()[0])] = 0  # an occupied block flagged 0
    fused_model.LAUNCHES = 0
    for what, occ in (("1-D", occ1), ("2-D", occ2), ("1-D hand-made", hand1), ("2-D hand-made", hand2)):
        occ = occ.to(dev)
        got = fused_model.fused_model_epoch(a_st, x_st, ws_st, 2, **mkw, chunk_occ=occ)
        compare("fused_model", got, fused_model.fused_model_epoch_plain(a_st, x_st, ws_st, 2, **mkw,
                                                                       chunk_occ=occ),
                f"fused_model chunk_occ {what} at C1")
        if torch.equal(got, k1_dense) == what.endswith("hand-made"):
            raise AssertionError(f"fused_model chunk_occ {what}: dense equality wrong way round")
    compare("fused_model", fused_model.fused_model_epoch(a_st, x_st, ws_st, 2, **mkw, resident_a=False),
            k1_dense, "fused_model resident_a=False at C1")
    if fused_model.LAUNCHES != 5:
        raise AssertionError(f"chunk_occ / resident_a: {fused_model.LAUNCHES} fused_model launches")
    print(f"phase 2: fused_model chunk_occ at C1 (1-D {tuple(occ1.shape)}, 2-D {tuple(occ2.shape)}, "
          f"{int(occ2.sum())} of {occ2.numel()} blocks flagged) == dense launch == plain; hand-made "
          f"maps == plain; resident_a=False == dense")

    # the mega path: one fused_model launch per shape bucket
    packmm.LAUNCHES = digitmm.LAUNCHES = fused_model.LAUNCHES = 0
    mega = eng._mega_logits(batcher)
    torch.cuda.synchronize()
    mega_launches = {"packmm": packmm.LAUNCHES, "digitmm": digitmm.LAUNCHES,
                     "fused_model": fused_model.LAUNCHES}
    buckets = eng.mega_buckets
    if any(bk["fallback"] for bk in buckets):
        raise AssertionError(f"mega: a bucket fell back to the captured fused epoch: {buckets}")
    if mega_launches != {"packmm": 0, "digitmm": 0, "fused_model": len(buckets)}:
        raise AssertionError(f"mega launches {mega_launches}, want one fused_model per bucket")
    for b, got, step, want in zip(batcher.batches, mega, logits, ref):
        n, c = b.num_nodes, ds.num_classes
        if not torch.isfinite(got).all() or not torch.equal(got[:n, :c], step[:n, :c]) \
                or not torch.equal(got[:n, :c], want[:n, :c]):
            raise AssertionError("mega logits != step engine / plain logits")
    print(f"phase 2: mega GCN logits of {nb} batches == step engine == plain; buckets "
          + ", ".join(f"pn={bk['pn']} x {bk['batches']}: compact schedule "
                      f"{'chosen' if bk['compact'] else 'not chosen'}, skippable blocks "
                      f"{bk['skippable']:.4f}" for bk in buckets)
          + f"; launches {mega_launches} = one fused_model per bucket; no bucket fell back")

    gin = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gin",
                     bit_width=2, seed=SEED, device=dev)
    packmm.LAUNCHES = 0
    digitmm.LAUNCHES = 0
    gl = [gin.forward_batch(b) for b in batcher.batches[:4]]
    torch.cuda.synchronize()
    gin_launches = {"packmm": packmm.LAUNCHES, "digitmm": digitmm.LAUNCHES}
    if gin_launches != {"packmm": 12, "digitmm": 12}:
        raise AssertionError(f"GIN launches {gin_launches}")
    for b, got in zip(batcher.batches[:4], gl):
        want = gin.forward_batch(b, plain=True)
        n = b.num_nodes
        if not torch.equal(got[:n, :ds.num_classes], want[:n, :ds.num_classes]):
            raise AssertionError("GIN: kernel logits != plain logits")
    print(f"phase 2: GIN (hidden 64) logits of 4 batches == plain; launches {gin_launches}")
    fused_model.LAUNCHES = 0
    gm = gin._mega_logits(SimpleNamespace(batches=batcher.batches[:4]))
    torch.cuda.synchronize()
    if fused_model.LAUNCHES != len(gin.mega_buckets) or any(bk["fallback"] for bk in gin.mega_buckets):
        raise AssertionError(f"GIN mega: {fused_model.LAUNCHES} launches, buckets {gin.mega_buckets}")
    for b, got in zip(batcher.batches[:4], gm):
        want = gin.forward_batch(b, plain=True)
        n, c = b.num_nodes, ds.num_classes
        if not torch.equal(got[:n, :c], want[:n, :c]):
            raise AssertionError("GIN mega logits != plain logits")
    print(f"phase 2: GIN (hidden 64) mega logits of 4 batches == plain; "
          f"{fused_model.LAUNCHES} fused_model launch(es)")

    # the bit-serial path: BitTensor planes throughout, one bitmm per GEMM
    t0 = time.perf_counter()
    beng4 = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gcn",
                       bit_width=2, seed=SEED, device=dev, fmt="bits")
    beng4.warmup(batcher)
    packmm.LAUNCHES = digitmm.LAUNCHES = fused_model.LAUNCHES = bitgemm.LAUNCHES = 0
    blogits = beng4.forward_all(batcher)
    torch.cuda.synchronize()
    bits_launches = {"bitmm": bitgemm.LAUNCHES, "packmm": packmm.LAUNCHES,
                     "digitmm": digitmm.LAUNCHES, "fused_model": fused_model.LAUNCHES}
    if bits_launches != {"bitmm": 6 * nb, "packmm": 0, "digitmm": 0, "fused_model": 0}:
        raise AssertionError(f"bits path launches {bits_launches}, want 6 bitmm per batch only")
    bref = beng4.forward_all(batcher, plain=True)
    for b, got, want, step in zip(batcher.batches, blogits, bref, logits):
        if got.shape != (b.padded_nodes, ds.num_classes) or not torch.isfinite(got).all():
            raise AssertionError(f"bits path: bad logits {tuple(got.shape)}")
        if not torch.equal(got, want) or not torch.equal(got, step):
            raise AssertionError("bits path: logits != plain / digit step engine logits")
    if not np.array_equal(blogits[0].cpu().numpy(), golden[: b0.padded_nodes]):
        raise AssertionError("bits path: batch 0 logits != NumPy integer reference")
    print(f"phase 2: bits GCN logits of {nb} batches == plain == digit step engine == NumPy "
          f"reference (batch 0); launches {bits_launches}; accuracy "
          f"{beng4.evaluate(batcher, ds.labels):.4f} ({time.perf_counter() - t0:.1f} s)")
    gin4 = QGTCEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gin",
                      bit_width=2, seed=SEED, device=dev, fmt="bits")
    bitgemm.LAUNCHES = 0
    gl4 = [gin4.forward_batch(b) for b in batcher.batches[:4]]
    torch.cuda.synchronize()
    if bitgemm.LAUNCHES != 24:
        raise AssertionError(f"bits GIN: {bitgemm.LAUNCHES} bitmm launches, want 24")
    for b, got, dig in zip(batcher.batches[:4], gl4, gl):
        if not torch.equal(got, gin4.forward_batch(b, plain=True)) or not torch.equal(got, dig):
            raise AssertionError("bits GIN logits != plain / digit engine logits")
    print("phase 2: bits GIN (hidden 64) logits of 4 batches == plain == digit engine; "
          "24 bitmm launches")

    # the full-precision baseline: one fused_baseline launch per bucket
    t0 = time.perf_counter()
    beng = BaselineEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="sage",
                          seed=SEED, device=dev)
    bstaged = beng._stage_mega(batcher, ds)
    fused_model.BASELINE_LAUNCHES = packmm.LAUNCHES = digitmm.LAUNCHES = fused_model.LAUNCHES = 0
    bouts = [(idx, fn()) for idx, fn in bstaged]
    torch.cuda.synchronize()
    base_launches = {"fused_baseline": fused_model.BASELINE_LAUNCHES, "fused_model": fused_model.LAUNCHES,
                     "packmm": packmm.LAUNCHES, "digitmm": digitmm.LAUNCHES}
    if base_launches != {"fused_baseline": len(beng.mega_buckets), "fused_model": 0,
                         "packmm": 0, "digitmm": 0}:
        raise AssertionError(f"baseline mega launches {base_launches}, want one per bucket")
    bmega = [None] * nb
    for idx, out in bouts:
        for i, lg in zip(idx, out):
            bmega[i] = lg
    base_rel = 0.0
    for (idx, fn), (_, out) in zip(bstaged, bouts):
        plain = fused_model.fused_baseline_epoch_plain(*fn.args)
        for i, got, want in zip(idx, out, plain):
            step = beng.forward_batch(batcher.batches[i], ds, batcher.features)
            if got.shape != (batcher.batches[i].padded_nodes, ds.num_classes) \
                    or not torch.isfinite(got).all():
                raise AssertionError(f"baseline mega: bad logits {tuple(got.shape)}")
            rel = max(bf16_rel_err(got, step), bf16_rel_err(got, want))
            base_rel = max(base_rel, rel)
            if rel > BF16_REL_TOL:
                raise AssertionError(f"baseline mega batch {i}: relative error {rel} in a row")
    print(f"phase 2: baseline (sage, hidden 16) mega logits of {nb} batches within 2^-6 per row "
          f"of the step baseline and plain (worst row's relative error {base_rel:.3e}); buckets "
          + ", ".join(f"pn={bk['pn']} x {bk['batches']}" for bk in beng.mega_buckets)
          + f"; launches {base_launches}, one per bucket; accuracy "
          f"{beng.evaluate(batcher, ds, ds.labels):.4f} ({time.perf_counter() - t0:.1f} s)")
    bgin = BaselineEngine(feat_dim=batcher.feat_dim, num_classes=ds.num_classes, model="gin",
                          seed=SEED, device=dev)
    sub = SimpleNamespace(batches=batcher.batches[:4], features=batcher.features)
    fused_model.BASELINE_LAUNCHES = 0
    gbm = bgin._mega_logits(sub, ds)
    torch.cuda.synchronize()
    if fused_model.BASELINE_LAUNCHES != len(bgin.mega_buckets):
        raise AssertionError(f"gin baseline mega: {fused_model.BASELINE_LAUNCHES} launches, "
                             f"buckets {bgin.mega_buckets}")
    gin_rel = max(bf16_rel_err(got, bgin.forward_batch(b, ds)) for b, got in zip(sub.batches, gbm))
    if gin_rel > BF16_REL_TOL:
        raise AssertionError(f"gin baseline mega: relative error {gin_rel} in a row")
    print(f"phase 2: gin baseline (hidden 64) mega logits of 4 batches within 2^-6 per row of "
          f"the step baseline (worst row's relative error {gin_rel:.3e}); "
          f"{fused_model.BASELINE_LAUNCHES} fused_baseline launch(es)")

    # the 5-8-bit mega path: C1 at 8 bits, every requantize shift the
    # smallest that keeps more than half of the stage's levels below the
    # rail on batch 0 (a NumPy chain); features cross as one plane of byte
    # levels and the kernel runs the signed chain (hidden 16, 40 classes)
    t0 = time.perf_counter()
    batcher8 = ClusterBatcher(ds, psize=1500, batch_size=20, bit_width=8, seed=SEED,
                              cache_dir="./datasets")
    b8 = batcher8.batches[0]

    def numpy_chain(model):
        """Batch 0's NumPy chain at 8 bits with the engine's weights."""
        probe = QGTCEngine(feat_dim=batcher8.feat_dim, num_classes=ds.num_classes, model=model,
                           bit_width=8, seed=SEED, device=dev)
        a_lv8 = packed_levels(probe.put_batch(b8)[0]).cpu().numpy()
        x_lv8 = np.zeros((a_lv8.shape[0], batcher8.feat_dim), np.int64)
        x_lv8[:b8.bit_X.shape[0]] = unpack_bits(b8.bit_X).numpy()
        return chain_shifts(a_lv8, x_lv8, [digit_unpack(w).cpu().numpy() for w in probe.weights], model, 8,
                            rows=b8.num_nodes)

    sh8, share8, gold8 = numpy_chain("gcn")
    eng8 = QGTCEngine(feat_dim=batcher8.feat_dim, num_classes=ds.num_classes, model="gcn", bit_width=8,
                      seed=SEED, device=dev, shifts=sh8)
    eng8.warmup(batcher8)
    packmm.LAUNCHES = digitmm.LAUNCHES = 0
    step8 = eng8.forward_all(batcher8)
    torch.cuda.synchronize()
    if (packmm.LAUNCHES, digitmm.LAUNCHES) != (3 * nb, 3 * nb):
        raise AssertionError(f"8-bit step engine: {packmm.LAUNCHES} packmm, {digitmm.LAUNCHES} digitmm")
    fused_model.LAUNCHES = fused_model.LEVELS_LAUNCHES = packmm.LAUNCHES = digitmm.LAUNCHES = 0
    mega8 = eng8._mega_logits(batcher8)
    torch.cuda.synchronize()
    levels_launches = {"fused_model_levels": fused_model.LEVELS_LAUNCHES, "fused_model": fused_model.LAUNCHES,
                       "packmm": packmm.LAUNCHES, "digitmm": digitmm.LAUNCHES}
    buckets8 = eng8.mega_buckets
    nbk = len(buckets8)
    if any(bk["fallback"] or bk["form"] != "signed" for bk in buckets8) or levels_launches != {
            "fused_model_levels": nbk, "fused_model": nbk, "packmm": 0, "digitmm": 0}:
        raise AssertionError(f"8-bit mega: launches {levels_launches}, buckets {buckets8}")
    plain8 = [None] * nb
    for idx, fn in eng8._stage_mega(batcher8):
        for i, lg in zip(idx, fused_model.fused_model_epoch_plain(*fn.args, **fn.keywords)):
            plain8[i] = lg
    ncls = ds.num_classes
    for b, got, step, want in zip(batcher8.batches, mega8, step8, plain8):
        n = b.num_nodes
        if not torch.isfinite(got).all() or not torch.equal(got, want) \
                or not torch.equal(got[:n, :ncls], step[:n, :ncls]):
            raise AssertionError("8-bit mega logits != plain / the 8-bit step engine's")
    if not np.array_equal(mega8[0][:, :ncls].cpu().numpy(), gold8[:, :ncls].astype(np.float32)):
        raise AssertionError("8-bit mega: batch 0 logits != NumPy chain")
    print(f"phase 2: 8-bit mega GCN logits of {nb} batches == plain == the 8-bit step engine == NumPy "
          f"chain (batch 0); shifts {sh8}, each stage's share of levels below the rail on batch 0 "
          + ", ".join(f"{x:.3f}" for x in share8)
          + "; buckets " + ", ".join(f"pn={bk['pn']} x {bk['batches']}: {bk['form']}, compact "
                                      f"{bk['compact']}" for bk in buckets8)
          + f"; launches {levels_launches}; accuracy {eng8.evaluate(batcher8, ds.labels):.4f} "
          f"({time.perf_counter() - t0:.1f} s)")
    # GIN at 8 bits (hidden 64, feat 128: the first aggregation's degree
    # case), 4 batches through the mega engine
    shg8, shareg8, goldg8 = numpy_chain("gin")
    gin8 = QGTCEngine(feat_dim=batcher8.feat_dim, num_classes=ds.num_classes, model="gin", bit_width=8,
                      seed=SEED, device=dev, shifts=shg8)
    fused_model.LEVELS_LAUNCHES = 0
    gm8 = gin8._mega_logits(SimpleNamespace(batches=batcher8.batches[:4]))
    torch.cuda.synchronize()
    if fused_model.LEVELS_LAUNCHES != len(gin8.mega_buckets) or any(
            bk["fallback"] or bk["form"] != "signed" for bk in gin8.mega_buckets):
        raise AssertionError(f"8-bit GIN mega: {fused_model.LEVELS_LAUNCHES} launches, {gin8.mega_buckets}")
    for b, got in zip(batcher8.batches[:4], gm8):
        n = b.num_nodes
        if not torch.equal(got[:n, :ncls], gin8.forward_batch(b)[:n, :ncls]) \
                or not torch.equal(got[:n, :ncls], gin8.forward_batch(b, plain=True)[:n, :ncls]):
            raise AssertionError("8-bit GIN mega logits != step engine / plain")
    if not np.array_equal(gm8[0][:, :ncls].cpu().numpy(), goldg8[:, :ncls].astype(np.float32)):
        raise AssertionError("8-bit GIN mega: batch 0 logits != NumPy chain")
    print(f"phase 2: 8-bit GIN (hidden 64) mega logits of 4 batches == step engine == plain == NumPy "
          f"chain (batch 0); shifts {shg8}, shares below the rail "
          + ", ".join(f"{x:.3f}" for x in shareg8) + f"; {fused_model.LEVELS_LAUNCHES} levels launch(es)")

    # K1's weight operands (fused_model.pack_mega_weights) built once a
    # staging for each form, not once a launch: three mega epochs of C1 and
    # of C1-8, the counts reset just before; C1-8's logits the same with the
    # operands built per launch
    pack_mega_weights, built = fused_model.pack_mega_weights, []
    fused_model.pack_mega_weights = lambda ws_, form_: built.append(form_) or pack_mega_weights(ws_, form_)
    try:
        fused_model.LAUNCHES = 0
        eng.run_epochs_mega(batcher, n_epochs=3)
        eng8.run_epochs_mega(batcher8, n_epochs=3)
        torch.cuda.synchronize()
    finally:
        fused_model.pack_mega_weights = pack_mega_weights
    k1_calls = fused_model.LAUNCHES
    if built != ["digits", "signed"] or k1_calls != 4 * (len(eng.mega_buckets) + len(eng8.mega_buckets)):
        raise AssertionError(f"K1 weight prep: built {built} over {k1_calls} launches")
    for idx, fn in eng8._stage_mega(batcher8):
        per_launch = fused_model.fused_model_epoch(*fn.args, **dict(fn.keywords, packed=None))
        for i, lg in zip(idx, per_launch):
            if not torch.equal(lg, mega8[i]):
                raise AssertionError("8-bit mega: logits with the staged weight operands != built per launch")
    print(f"phase 2: K1's weight operands built once a staging ({built}) over {k1_calls} launches of three mega "
          f"epochs (C1 and C1-8, one warm-up each); C1-8's logits with them == built per launch == plain")

    # the captured engines on C1's 75 batches: the fused and quant-in-loop
    # epochs, each one CUDA graph replayed once an epoch, the mega engine's
    # fallback, and the baseline's fused loop; the wrappers count their
    # Python calls, which a replay makes none of, so the profiler counts a
    # replay's kernels
    t0 = time.perf_counter()
    k2_name, k3_name = "k2_kernel", "k3_kernel"
    captured, replay_counts = {}, {}
    for what, e, want in (("fused (E5)", eng, logits), ("fused with the maps (E5z)", zeng, zlogits),
                          ("quant-in-loop (E6)", eng, logits)):
        packmm.LAUNCHES = packmm.MAPPED_LAUNCHES = digitmm.LAUNCHES = fused_model.LAUNCHES = 0
        epoch = e._fused_epoch(batcher, quant_in_loop=what.startswith("quant"))
        at_capture = (packmm.LAUNCHES, packmm.MAPPED_LAUNCHES, digitmm.LAUNCHES, fused_model.LAUNCHES)
        maps = 6 * nb if e is zeng else 0
        if at_capture != (6 * nb, maps, 6 * nb, 0):  # the side stream's warm-up and the capture
            raise AssertionError(f"{what}: launches at capture {at_capture}")
        outs = epoch()
        for rep in range(2):
            torch.cuda.synchronize()
            if len(outs) != nb or any(not torch.equal(o, w) for o, w in zip(outs, want)):
                raise AssertionError(f"{what}: replay {rep} logits != the step engine's")
            for o in outs:  # a sentinel: the next replay must write every batch again
                o.fill_(-1.0)
            if epoch() is not outs:
                raise AssertionError(f"{what}: a replay returned other outputs")
        torch.cuda.synchronize()
        if (packmm.LAUNCHES, digitmm.LAUNCHES) != (6 * nb, 6 * nb):
            raise AssertionError(f"{what}: a replay moved the wrappers' counters")
        counts = kernel_launches(epoch, iters=2)
        replay_counts[what] = {"packmm": sum(n for k, n in counts.items() if k2_name in k),
                               "digitmm": sum(n for k, n in counts.items() if k3_name in k),
                               "kernels and copies": sum(counts.values())}
        if (replay_counts[what]["packmm"], replay_counts[what]["digitmm"]) != (3 * nb, 3 * nb):
            raise AssertionError(f"{what}: a replay ran {replay_counts[what]}, want {3 * nb} + {3 * nb}")
        captured[what] = epoch
    print(f"phase 2: captured GCN epochs of {nb} batches == the step engine's logits bit for bit, twice, "
          f"each replay after a sentinel fill; per replay (profiler) "
          + "; ".join(f"{w}: {c}" for w, c in replay_counts.items())
          + f" ({time.perf_counter() - t0:.1f} s)")
    # the mega engine with its plan refusing C1's bucket: the captured
    # fused epoch runs it, loudly
    t0 = time.perf_counter()
    mega_plan = fused_model.plan

    def refuse(*args, **kw):
        raise ValueError("refused for the fallback check")

    fused_model.plan = refuse
    try:
        fused_model.LAUNCHES = packmm.LAUNCHES = digitmm.LAUNCHES = 0
        fb = eng._mega_logits(batcher)
        torch.cuda.synchronize()
    finally:
        fused_model.plan = mega_plan
    fb_launches = {"fused_model": fused_model.LAUNCHES, "packmm": packmm.LAUNCHES, "digitmm": digitmm.LAUNCHES}
    if not all(bk["fallback"] for bk in eng.mega_buckets) or fb_launches != {
            "fused_model": 0, "packmm": 6 * nb, "digitmm": 6 * nb}:
        raise AssertionError(f"forced mega fallback: buckets {eng.mega_buckets}, launches {fb_launches}")
    if any(not torch.equal(g, w) for g, w in zip(fb, logits)):
        raise AssertionError("forced mega fallback: logits != the step engine's")
    print(f"phase 2: mega engine with its plan refusing every bucket: the captured fused epoch, "
          f"{nb} batches == the step engine's logits; launches at capture {fb_launches} "
          f"({time.perf_counter() - t0:.1f} s)")
    # the baseline's fused loop captured against the same loop uncaptured
    t0 = time.perf_counter()
    bepoch = beng._fused_epoch(batcher, ds)
    bouts = bepoch()
    torch.cuda.synchronize()
    bloop = [None] * nb
    for idx, a_s, x_s in beng._stage(batcher, ds, torch.uint8):
        for i, lg in zip(idx, beng._fused_bucket(a_s, x_s)):
            bloop[i] = lg
    torch.cuda.synchronize()
    b_exact = all(torch.equal(g, w) for g, w in zip(bouts, bloop))
    b_rel = max(bf16_rel_err(g, w) for g, w in zip(bouts, bloop))
    if b_rel > BF16_REL_TOL:
        raise AssertionError(f"captured baseline fused loop: relative error {b_rel} in a row")
    for o in bouts:
        o.fill_(-1.0)
    torch.cuda.synchronize()
    bepoch()
    torch.cuda.synchronize()
    if max(bf16_rel_err(g, w) for g, w in zip(bouts, bloop)) > BF16_REL_TOL:
        raise AssertionError("captured baseline fused loop: a replay left a sentinel")
    captured["baseline fused (B2)"] = bepoch
    print(f"phase 2: captured baseline fused loop, {nb} batches: "
          + ("== the uncaptured loop bit for bit" if b_exact else
             f"within 2^-6 per row of the uncaptured loop (worst row {b_rel:.3e}; cuBLAS took another "
             f"algorithm under capture)")
          + f", again after a sentinel fill ({time.perf_counter() - t0:.1f} s)")

    # the kernel sweep: each figure's rows through the port's own
    # functions, counts reset before each figure
    t0 = time.perf_counter()
    sweep, sweep_launches = {}, {"packmm": 0, "packmm_signed": 0}
    for fig in kernel_sweep.FIGURES:
        cases = kernel_sweep.figure_cases(fig, np.random.default_rng(0), dev)
        packmm.LAUNCHES = packmm.SIGNED_LAUNCHES = digitmm.LAUNCHES = bitgemm.LAUNCHES = 0
        for c in cases:
            before = (packmm.LAUNCHES, packmm.SIGNED_LAUNCHES)
            out = c.run()
            got = (packmm.LAUNCHES - before[0], packmm.SIGNED_LAUNCHES - before[1])
            want = (0, 0) if c.int8 else (0, 1) if c.bits == 8 else (1, 0)
            if got != want:
                raise AssertionError(f"sweep {fig} {c.row(1.0)}: (packmm, packmm_signed) launches "
                                     f"{got}, want {want}")
            what = f"sweep {fig} bits={c.bits} M={c.M} K={c.K} N={c.N}"
            if c.M > 4096:  # the profile shapes: the first 2048 rows, whole 256-row groups
                want_out = c.plain(2048)
                out = PackedTensor(words=out.words[:, :want_out.words.shape[1]], shape=want_out.shape,
                                   bits=out.bits)
                compare("packmm", out, want_out, f"{what} (first 2048 rows)")
            else:
                compare("int_mm" if c.int8 else "packmm_signed" if c.bits == 8 else "packmm", out,
                        c.plain(), what)
        if digitmm.LAUNCHES or bitgemm.LAUNCHES:
            raise AssertionError(f"sweep {fig}: digitmm / bitmm launched")
        sweep[fig] = cases
        sweep_launches["packmm"] += packmm.LAUNCHES
        sweep_launches["packmm_signed"] += packmm.SIGNED_LAUNCHES
        print(f"phase 2: kernel sweep figure {fig}: {len(cases)} rows == plain; launches packmm "
              f"{packmm.LAUNCHES}, packmm_signed {packmm.SIGNED_LAUNCHES}")
    print(f"phase 2: kernel sweep {sum(map(len, sweep.values()))} rows, launches {sweep_launches} "
          f"({time.perf_counter() - t0:.1f} s)")

    # --use-pp at C1: the batcher's precalc features [X, (A X) / degree],
    # 256 wide, through the step engine (K2 and K3 at X[pn x 256]), the mega
    # engine (K1, or its loud fallback) and the sage baseline's mega mode (K5)
    t0 = time.perf_counter()
    batcher_pp = ClusterBatcher(ds, psize=1500, batch_size=20, bit_width=2, seed=SEED, cache_dir="./datasets",
                                precalc=True)
    pp_host = time.perf_counter() - t0
    if batcher_pp.feat_dim != 2 * ds.feat_dim or len(batcher_pp) != nb:
        raise AssertionError(f"--use-pp batcher: feat {batcher_pp.feat_dim}, {len(batcher_pp)} batches")
    engpp = QGTCEngine(feat_dim=batcher_pp.feat_dim, num_classes=ncls, model="gcn", bit_width=2, seed=SEED,
                       device=dev)
    engpp.warmup(batcher_pp)
    packmm.LAUNCHES = digitmm.LAUNCHES = fused_model.LAUNCHES = bitgemm.LAUNCHES = 0
    pp_logits = engpp.forward_all(batcher_pp)
    torch.cuda.synchronize()
    pp_launches = {"packmm": packmm.LAUNCHES, "digitmm": digitmm.LAUNCHES, "fused_model": fused_model.LAUNCHES,
                   "bitmm": bitgemm.LAUNCHES}
    if pp_launches != {"packmm": 3 * nb, "digitmm": 3 * nb, "fused_model": 0, "bitmm": 0}:
        raise AssertionError(f"--use-pp step launches {pp_launches}, want 3 each per batch")
    for got, want in zip(pp_logits, engpp.forward_all(batcher_pp, plain=True)):
        if not torch.isfinite(got).all() or not torch.equal(got, want):
            raise AssertionError("--use-pp step engine: logits != plain")
    bp0 = batcher_pp.batches[0]
    gold_pp = qgcn_golden(packed_levels(engpp.put_batch(bp0)[0]).cpu().numpy(), unpack_bits(bp0.bit_X).numpy(),
                          [digit_unpack(w).cpu().numpy() for w in engpp.weights], 2, 2)
    if not np.array_equal(pp_logits[0].cpu().numpy(), gold_pp[: bp0.padded_nodes]):
        raise AssertionError("--use-pp step engine: batch 0 logits != qgcn_golden")
    fused_model.LAUNCHES = 0
    pp_mega = engpp._mega_logits(batcher_pp)
    torch.cuda.synchronize()
    pp_fb = [bk["pn"] for bk in engpp.mega_buckets if bk["fallback"]]
    if fused_model.LAUNCHES != len(engpp.mega_buckets) - len(pp_fb):
        raise AssertionError(f"--use-pp mega: {fused_model.LAUNCHES} launches, buckets {engpp.mega_buckets}")
    for b, got, step in zip(batcher_pp.batches, pp_mega, pp_logits):
        n = b.num_nodes
        if not torch.equal(got[:n, :ncls], step[:n, :ncls]):
            raise AssertionError("--use-pp mega logits != the step engine's")
    bpp = BaselineEngine(feat_dim=batcher_pp.feat_dim, num_classes=ncls, model="sage", seed=SEED, device=dev)
    fused_model.BASELINE_LAUNCHES = 0
    bpp_mega = bpp._mega_logits(batcher_pp, ds)
    torch.cuda.synchronize()
    bpp_fb = [bk["pn"] for bk in bpp.mega_buckets if bk["fallback"]]
    if fused_model.BASELINE_LAUNCHES != len(bpp.mega_buckets) - len(bpp_fb):
        raise AssertionError(f"--use-pp baseline mega: {fused_model.BASELINE_LAUNCHES} launches, "
                             f"buckets {bpp.mega_buckets}")
    pp_rel = max(bf16_rel_err(got, bpp.forward_batch(b, ds, batcher_pp.features))
                 for b, got in zip(batcher_pp.batches, bpp_mega))
    if pp_rel > BF16_REL_TOL:
        raise AssertionError(f"--use-pp baseline mega: relative error {pp_rel} in a row")
    print(f"phase 2: --use-pp at C1 (feat {batcher_pp.feat_dim}, host pipeline {pp_host:.1f} s): step GCN logits "
          f"of {nb} batches == plain, batch 0 == qgcn_golden, launches {pp_launches}; mega == step, "
          f"{fused_model.LAUNCHES} fused_model launch(es), fallback buckets {pp_fb or 'none'}; sage baseline "
          f"mega within 2^-6 per row of its step (worst {pp_rel:.3e}), {fused_model.BASELINE_LAUNCHES} "
          f"fused_baseline launch(es), fallback buckets {bpp_fb or 'none'} ({time.perf_counter() - t0:.1f} s)")
    del bpp, bpp_mega

    # rebit: C1's batcher at 8 bits (and at 8 bits on the 2-bit grid) from
    # its bit-independent artifacts, byte for byte a fresh batcher's on 4
    # batches, and the 8-bit engine on them equal to plain
    t0 = time.perf_counter()
    fresh82 = ClusterBatcher(ds, psize=1500, batch_size=20, bit_width=8, quant_bits=2, seed=SEED,
                             cache_dir="./datasets")
    packmm.LAUNCHES = digitmm.LAUNCHES = 0
    for what_, rb, fresh in (("rebit(8)", batcher.rebit(8), batcher8),
                             ("rebit(8, quant_bits=2)", batcher.rebit(8, quant_bits=2), fresh82)):
        for b, f in zip(rb.batches[:4], fresh.batches[:4]):
            if not (np.array_equal(b.nodes, f.nodes) and torch.equal(b.a_words, f.a_words)
                    and torch.equal(b.bit_X.planes, f.bit_X.planes) and torch.equal(b.tile_kidx, f.tile_kidx)):
                raise AssertionError(f"{what_}: a batch != the fresh batcher's")
            if not torch.equal(eng8.forward_batch(b), eng8.forward_batch(b, plain=True)):
                raise AssertionError(f"{what_}: the 8-bit engine's logits != plain")
    torch.cuda.synchronize()
    if (packmm.LAUNCHES, digitmm.LAUNCHES) != (24, 24):
        raise AssertionError(f"rebit: {packmm.LAUNCHES} packmm, {digitmm.LAUNCHES} digitmm launches, want 24 each")
    print(f"phase 2: rebit(8) and rebit(8, quant_bits=2) of C1's batcher == fresh batchers byte for byte on 4 "
          f"batches; the 8-bit engine on them == plain, 24 packmm + 24 digitmm launches "
          f"({time.perf_counter() - t0:.1f} s)")
    del fresh82

    # the layer API: QGCNConv / QGINConv objects composed into the 3-layer
    # models on C1's batch 0 equal the engines' qgcn_forward / qgin_forward,
    # digits (K2, K3) and bits (K6)
    layer_launches = {}
    for what_, conv, e, want in (("GCN digits", QGCNConv, eng, logits[0]), ("GIN digits", QGINConv, gin, gl[0]),
                                 ("GCN bits", QGCNConv, beng4, blogits[0]), ("GIN bits", QGINConv, gin4, gl4[0])):
        a_, h, _ = e.put_batch(b0)
        h = h if e.fmt == "bits" else to_digit_tensor(h)
        layers = [conv.create(w, 2, fmt=e.fmt, device=dev) for w in e.float_weights]
        packmm.LAUNCHES = digitmm.LAUNCHES = bitgemm.LAUNCHES = 0
        for lay in layers[:-1]:
            h = lay(a_, h)
        got = layers[-1](a_, h, final=True)
        torch.cuda.synchronize()
        layer_launches[what_] = (packmm.LAUNCHES, digitmm.LAUNCHES, bitgemm.LAUNCHES)
        if layer_launches[what_] != ((0, 0, 6) if e.fmt == "bits" else (3, 3, 0)) or not torch.equal(got, want):
            raise AssertionError(f"layer API {what_}: launches (packmm, digitmm, bitmm) {layer_launches[what_]}, "
                                 f"or logits != the engine's forward")
    print(f"phase 2: the layer API on C1's batch 0 == qgcn_forward / qgin_forward; launches (packmm, digitmm, "
          f"bitmm) {layer_launches}")

    # the full-graph sparse engine on the whole arxiv stand-in: the card's
    # logits equal the same engine's on the CPU, a few epochs timed
    t0 = time.perf_counter()
    sparse_rows = []
    for model in ("gcn", "gin"):
        se = SparseEngine(ds, model=model, bit_width=2, seed=SEED, device=dev)
        got = se.forward().cpu()
        want = SparseEngine(ds, model=model, bit_width=2, seed=SEED, device="cpu").forward()
        if got.shape != (ds.num_nodes, ncls) or not torch.equal(got, want) or not (got != 0).any():
            raise AssertionError(f"sparse {model}: the card's logits != the CPU's")
        st = se.run_epochs(5)
        sparse_rows.append(f"{model} (hidden {se.cfg.hidden}) {st.avg_ms:.3f} ms/epoch, accuracy "
                           f"{se.evaluate(ds.labels):.4f}")
        del se
    print(f"phase 2: SparseEngine on {ds.name} ({ds.num_nodes} nodes, feat {ds.feat_dim}, 2-bit): the card's "
          f"logits == the CPU's; " + "; ".join(sparse_rows) + f", 5 epochs, one synchronize [{card}] "
          f"({time.perf_counter() - t0:.1f} s)")

    # the CLI in-process once with each flag this slice ported, on a small
    # dataset, each record appended to --json-out
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        jout = os.path.join(tmp, "records.jsonl")
        base_argv = ["--dataset", "ppi", "--dataset-scale", "0.02", "--psize", "40", "--batch-size", "4",
                     "--n-epochs", "2", "--json-out", jout, "--cache-dir", os.path.join(tmp, "cache")]
        cli_runs = [["--sparse", "--eval-accuracy"], ["--use-pp"], ["--bucket-rows", "256", "--mode", "mega"],
                    ["--profile-dir", os.path.join(tmp, "prof"), "--mode", "fused"],
                    ["--use-pp", "--regular", "--mode", "mega"]]
        for flags in cli_runs:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(base_argv + flags)
            if rc != 0:
                raise AssertionError(f"cli {flags}: exit {rc}")
        with open(jout) as f:
            records = [json.loads(line) for line in f]
        if len(records) != len(cli_runs) or not os.path.exists(os.path.join(tmp, "prof", "trace.json")) \
                or any(r["avg_epoch_ms"] <= 0 or r["engine"] != "sparse-full-graph"
                       and r.get("partition_method") != "native" for r in records):
            raise AssertionError(f"cli: records {records}")
    print("phase 2: the CLI, exit 0 and the record written: " + "; ".join(
        f"{' '.join(fl for fl in flags if fl.startswith('--'))} -> {r['engine']} {r['avg_epoch_ms']:.3f} ms"
        for flags, r in zip(cli_runs, records)) + f" ({time.perf_counter() - t0:.1f} s)")

    # quantization-aware training at C1's width on C1's batches, deployed
    # through the step and mega engines and through the CLI's --weights
    qat = qat_phase(dev, ds, batcher, ["--dataset", "ogbn-arxiv", "--psize", "1500", "--batch-size", "20",
                                       "--cache-dir", "./datasets"], root)
    print(f"phase 2: QAT at C1 (2-bit GCN, hidden 16, 3 layers, {qat['epochs']} epochs, {nb} batches): twin "
          f"accuracy {qat['accuracy']:.4f} == deployed step (K2, K3) == mega (K1) == the CLI's --weights in step "
          f"and mega modes; twin logits == step == mega engine on every batch (launches {qat['launches']}); "
          f"shifts {qat['shifts']}; training {qat['train_seconds']:.1f} s of {qat['seconds']:.1f} s; ladder "
          f"{qat['ladder']} [{card}]")

    # the (dp, sp) mesh engine on C1, every shard on this one card
    mesh = mesh_phase(dev, ds, batcher, batcher8, sh8, logits, step8, gl, root)
    print(f"phase 2: mesh engine (parallel/) at C1 over {dev} repeated: (4,1) every bucket mega, (2,2) every bucket "
          f"ring, == the step engine bit for bit on all {nb} batches after a NaN fill; GIN (hidden 64) and 8-bit "
          f"(shifts {sh8}) on {MESH_BATCHES} batches at both meshes ==; dense dp_sp_epoch_step ring and gather ==; "
          f"CLI " + ", ".join(f"{e} {m} {ms:.3f} ms" for e, m, ms in mesh["cli"]) + "; dryrun_multichip(4) ok; two "
          f"gloo processes on one device == the single-process engine (walls {mesh['worker_walls_ms']} ms); "
          f"mesh launches {mesh['launches']} ({mesh['seconds']:.1f} s) [{card}]")

    # -- phase 3: timing ------------------------------------------------
    print(f"phase 3 starts {time.perf_counter() - start:.0f} s into the run")
    # the kernel studies through their entry points (the probe modules'
    # tables, JAX's run_packedout rows, the per-K-step ladder at C1's
    # aggregation, the zero-body, K-dot and layer-fit rows); launch counts
    # reset just before and read just after
    t0 = time.perf_counter()
    exp_packmm.LAUNCHES = exp_packmm.PACKEDOUT_LAUNCHES = 0
    exp_bitcast_probe.TO8_LAUNCHES = exp_bitcast_probe.TO32_LAUNCHES = exp_bitcast_probe.FRAGMENT_LAUNCHES = 0
    grid_overhead_study.ZERO_BODY_LAUNCHES = grid_overhead_study.KDOT_LAUNCHES = 0
    table8, table32 = exp_bitcast_probe.probe32to8(dev), exp_bitcast_probe.probe8to32(dev)
    if table8[:, 0].tolist() != list(range(32)) or table32[0, 0] != 0x3020100 \
            or not exp_bitcast_probe.probe_fragments(dev):
        raise AssertionError("P2: a byte lands off the TPU's interpret-mode order or the PTX fragment layout")
    prng = np.random.default_rng(0)
    packedout_rows = [exp_packmm.run_packedout(*r[:6], prng, r[6], iters=10, device=dev)
                      for r in exp_packmm.PACKEDOUT_ROWS]
    ladder_rows = exp_packmm.ladder([exp_packmm.C1_SHAPE], iters=10, device=dev)
    study_rows = (grid_overhead_study.zero_body_rows(10, dev) + grid_overhead_study.kdot_rows(5, dev)
                  + grid_overhead_study.layer_rows(np.random.default_rng(0), 10, dev))
    torch.cuda.synchronize()
    probe_launches = {"exp_packmm": exp_packmm.LAUNCHES, "exp_packmm_packedout": exp_packmm.PACKEDOUT_LAUNCHES,
                      "bitcast32to8": exp_bitcast_probe.TO8_LAUNCHES, "bitcast8to32": exp_bitcast_probe.TO32_LAUNCHES,
                      "fragment_probe": exp_bitcast_probe.FRAGMENT_LAUNCHES,
                      "zero_body": grid_overhead_study.ZERO_BODY_LAUNCHES, "kdot": grid_overhead_study.KDOT_LAUNCHES}
    if not all(probe_launches.values()):
        raise AssertionError(f"the kernel studies left a probe kernel unlaunched: {probe_launches}")
    for r in packedout_rows:
        print(f"phase 3: P1 packed out bits={r['bits']} M=K={r['M']} N={r['N']} tm={r['tm']} g={r['g']}: "
              f"{r['us']:.2f} us, {r['tflops']:.3f} TFLOP/s, exact [{card}]")
    for r in ladder_rows:
        print(f"phase 3: P1 ladder bits={r['bits']} M=K={r['M']} N={r['N']} {r['row']}: {r['us']:.2f} us, "
              f"{exp_packmm.ladder_step(r)}, {r['tflops']:.3f} TFLOP/s [{card}]")
    for r in study_rows:
        print("phase 3: P3 " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                         for k, v in r.items()) + f" [{card}]")
    print(f"phase 3: kernel studies, launches {probe_launches} ({time.perf_counter() - t0:.1f} s)")
    for rep in range(2):
        for resident in (True, False):
            st = eng.run_epochs(batcher, n_epochs=5, resident=resident)
            stz = zeng.run_epochs(batcher, n_epochs=5, resident=resident)
            st4 = beng4.run_epochs(batcher, n_epochs=5, resident=resident)
            print(f"phase 3: step engine GCN 2-bit arxiv, resident={resident}: digits "
                  f"{st.avg_ms:.3f}, digits with zero-tile jumping {stz.avg_ms:.3f}, bits "
                  f"{st4.avg_ms:.3f} ms/epoch over {st.n_batches} batches [{card}]")
    for rep in range(2):
        for zj in (None, False):
            eng.zerotile_jump = zj
            st = eng.run_epochs_mega(batcher, n_epochs=20)
            sched_on = [bk["compact"] for bk in eng.mega_buckets]
            print(f"phase 3: mega engine GCN 2-bit arxiv, compact schedule {sched_on}: "
                  f"{st.avg_ms:.3f} ms/epoch over {st.n_batches} batches "
                  f"({len(eng.mega_buckets)} launch(es) per epoch) [{card}]")
    eng.zerotile_jump = None
    for rep in range(2):
        st2, st8 = eng.run_epochs_mega(batcher, n_epochs=20), eng8.run_epochs_mega(batcher8, n_epochs=20)
        print(f"phase 3: mega engine GCN arxiv: 2-bit (E3) {st2.avg_ms:.3f}, 8-bit levels form (E3-8) "
              f"{st8.avg_ms:.3f} ms/epoch over {nb} batches [{card}]")
    for rep in range(2):
        runs = [("baseline step (resident)", lambda: beng.run_epochs(batcher, ds, n_epochs=5)),
                ("baseline fused", lambda: beng.run_epochs_fused(batcher, ds, n_epochs=5)),
                ("baseline mega", lambda: beng.run_epochs_mega(batcher, ds, n_epochs=20)),
                ("quantized mega (2-bit GCN)", lambda: eng.run_epochs_mega(batcher, n_epochs=20))]
        print("phase 3: " + "; ".join(f"{what} {run().avg_ms:.3f}" for what, run in runs)
              + f" ms/epoch over {nb} batches, arxiv [{card}]")
    # the epochs side by side in turns, three runs of 20 epochs each (every
    # staged engine staged and captured anew a run); their device times follow
    epoch_runs = {"E1": lambda: eng.run_epochs(batcher, n_epochs=20, resident=True),
                  "E1z": lambda: zeng.run_epochs(batcher, n_epochs=20, resident=True),
                  "E5": lambda: eng.run_epochs_fused(batcher, n_epochs=20),
                  "E5z": lambda: zeng.run_epochs_fused(batcher, n_epochs=20),
                  "E6": lambda: eng.run_epochs_quant_in_loop(batcher, n_epochs=20),
                  "B2": lambda: beng.run_epochs_fused(batcher, ds, n_epochs=20),
                  "B3": lambda: beng.run_epochs_mega(batcher, ds, n_epochs=20)}
    host_ms = {k: [] for k in epoch_runs}
    for rep in range(3):
        for k, run in epoch_runs.items():
            host_ms[k].append(run().avg_ms)
    print("phase 3: host ms/epoch, all epochs launched and one synchronize, 3 runs each in turns: "
          + "; ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in vs) for k, vs in host_ms.items())
          + f" [{card}]")
    mesh_times = mesh_timing(dev, batcher, eng, card, nb)

    def on_card(q, bits, packed=False):
        t = torch.from_numpy(q).to(dev)
        return pack_rows(t, bits) if packed else digit_pack(t, bits)

    qa, qh16 = operands(SEED, 2560, 2560, 16, 1, 2, 2, 0)
    qx, qw1 = operands(SEED, 2560, 128, 16, 2, 2, 2, 0)
    a, h16, x, w1 = on_card(qa, 1, True), on_card(qh16, 2), on_card(qx, 2), on_card(qw1, 2)
    qh40 = operands(SEED, 2560, 2560, 40, 1, 2, 2, 0)[1]
    h40 = on_card(qh40, 2)
    # the same levels as bit planes, for bitmm
    ab, hb16, xb, wb1, hb40 = (on_bits(q, bw) for q, bw in
                               ((qa, 1), (qh16, 2), (qx, 2), (qw1, 2), (qh40, 2)))
    qw2 = operands(SEED, 16, 16, 16, 2, 2, 2, 0)[1]
    w2, wb2 = on_card(qw2, 2), on_bits(qw2, 2)
    w40 = on_card(operands(SEED, 16, 16, 40, 2, 2, 2, 0)[1], 2)
    def plan_of(a_, b_, out_bits, out_form="digits", raw=False, out_cols=None, tile_map=None):
        """The launch a packmm call takes, as printed beside its time:
        packmm_plan's for a 1/2/4-bit A (K2), packmm_signed_plan's for a
        5-8-bit one (K4's kernel: the PreparedRHS product or K2's 8-bit
        plane)."""
        form = packmm._plan_form(out_bits, out_form, raw)
        if isinstance(b_, packmm.PreparedRHS):
            ocp, n = packmm._signed_stores(a_, b_, out_bits, out_form, out_cols)
            p = packmm.packmm_signed_plan(a_.padded_rows, a_.padded_cols, b_.plane.shape[1], n, form, ocp)
        else:
            ocp = packmm._stored_cols(out_form, out_cols, b_.padded_cols)
            choose = packmm.packmm_signed_plan if a_.bits > 4 else packmm.packmm_plan
            p = choose(a_.padded_rows, a_.padded_cols, b_.padded_cols, b_.shape[1], form, ocp, tile_map)
        return f"BNT {p.bnt}, S {p.splits}, cluster {p.cluster}, grid {p.grid}"

    k2_plans = {"packmm_to_digits A[2560x2560] x H[2560x16]": plan_of(a, h16, 2),
                "packmm_to_f32 A[2560x2560] x H[2560x40]": plan_of(a, h40, None, "f32")}
    # K6 at C1's four GEMM shapes, each with bitmm_plan's choice: (kind,
    # what, A, B, out_bits or None for f32)
    k6_rows = [("bitmm", "bitmm_to_bits A[2560x2560] 1-bit x H[2560x16] 2-bit", ab, hb16, 2),
               ("bitmm f32", "bitmm_to_int A[2560x2560] x H[2560x40]", ab, hb40, None),
               ("bitmm update", "bitmm_to_bits X[2560x128] x W[128x16], 2-bit", xb, wb1, 2),
               ("bitmm update K16", "bitmm_to_bits H[2560x16] x W[16x16], 2-bit", hb16, wb2, 2)]
    for _, what, l, r, ob in k6_rows:
        p6 = bitgemm.bitmm_plan(l.padded_rows, l.padded_cols, r.padded_cols, r.shape[1], "bits" if ob else "f32")
        k2_plans[what] = f"BNT {p6.bnt}, S {p6.splits}, cluster {p6.cluster}, grid {p6.grid}"
    for what, l, r in (("digitmm_to_digits X[2560x128] x W[128x16]", x, w1),
                       ("digitmm_to_digits H[2560x16] x W[16x16]", h16, w2),
                       ("digitmm_to_digits H[2560x16] x W[16x40]", h16, w40)):
        p3_ = digitmm.digitmm_plan(l.ndigits, r.ndigits, l.padded_rows, l.padded_cols, r.digits.shape[2],
                                   l.shape[1], r.shape[1])
        k2_plans[what] = (f"K {p3_.kr}, N {p3_.nr}, BNT {p3_.bnt}, rows {p3_.rows}, stage {p3_.ks}, "
                          f"grid {p3_.grid}")
    timed = [
        ("packmm", "packmm_to_digits A[2560x2560] x H[2560x16]",
         lambda: packmm.packmm_to_digits(a, h16, 2), lambda: packmm.packmm_plain(a, h16, 2)),
        ("packmm", "packmm_to_f32 A[2560x2560] x H[2560x40]",
         lambda: packmm.packmm_to_f32(a, h40), lambda: packmm.packmm_plain(a, h40)),
        ("digitmm", "digitmm_to_digits X[2560x128] x W[128x16]",
         lambda: digitmm.digitmm_to_digits(x, w1, 2), lambda: digitmm.digitmm_plain(x, w1, 2)),
        ("digitmm", "digitmm_to_digits H[2560x16] x W[16x16]",
         lambda: digitmm.digitmm_to_digits(h16, w2, 2), lambda: digitmm.digitmm_plain(h16, w2, 2)),
        ("digitmm", "digitmm_to_digits H[2560x16] x W[16x40]",
         lambda: digitmm.digitmm_to_digits(h16, w40, 2), lambda: digitmm.digitmm_plain(h16, w40, 2)),
    ] + [(kind, what, lambda l=l, r=r, ob=ob: bitgemm.bitmm_to_bits(l, r, ob) if ob else bitgemm.bitmm_to_int(l, r),
          lambda l=l, r=r, ob=ob: bitgemm.bitmm_plain(l, r, ob)) for kind, what, l, r, ob in k6_rows]
    # the mega paths launch once a bucket an epoch (C1's native partition
    # has three buckets): every bucket's launch is timed beside plain, and
    # the kernels line sums the buckets into the epoch that `launches`
    # counts. The variants (dense, 2-bit levels, 2-digit, first layer...)
    # take the bucket that holds the most batches.
    bucket_parts = {}  # kernel -> the timed kinds of its epoch's launches, one a bucket

    def time_buckets(kernel, stage, bks, label, plain_of):
        big_ = max(range(len(stage)), key=lambda i: len(stage[i][0]))
        bucket_parts[kernel] = []
        for j, ((idx_, fn_), bk) in enumerate(zip(stage, bks)):
            if j == big_:  # timed with the variants below, under the kernel's own name
                bucket_parts[kernel].append((kernel, bk["pn"], fn_))
                continue
            kind_ = f"{kernel} pn={bk['pn']}"
            bucket_parts[kernel].append((kind_, bk["pn"], fn_))
            timed.append((kind_, f"{label}, {len(idx_)} batches of pn={bk['pn']}", fn_,
                          functools.partial(plain_of, fn_)))
        return big_

    staged = eng._stage_mega(batcher)
    big = time_buckets("fused_model", staged, eng.mega_buckets, "fused_model epoch",
                       lambda f: fused_model.fused_model_epoch_plain(*f.args, **f.keywords))
    mega_fn = staged[big][1]
    args, kw = mega_fn.args, mega_fn.keywords
    dense_kw = dict(kw, blk_sched=None)
    what = f"fused_model epoch, {len(staged[big][0])} batches of pn={eng.mega_buckets[big]['pn']}"
    timed.append(("fused_model", f"{what}, compact schedule {kw['blk_sched'] is not None}",
                  mega_fn, lambda: fused_model.fused_model_epoch_plain(*args, **kw)))
    # the plain epoch is the same chain with or without the schedule's
    # mask, and the profiler's cost grows with its ~10^4 ops per epoch:
    # the dense kernel is timed alone
    timed.append(("fused_model dense", f"{what}, dense",
                  lambda: fused_model.fused_model_epoch(*args, **dense_kw), None))
    # the 1-4-bit levels form (no caller stages it): C1's 2-bit X read as
    # one plane of 2-bit levels, the signed chain
    low_kw = dict(kw, x_levels_bits=2, packed=fused_model.pack_mega_weights(args[2], "signed"))
    if fused_model.plan(args[0].shape, args[1].shape, args[2], 2, "gcn", kw["shifts"], kw["out_cols"],
                        None if kw["blk_sched"] is None else kw["blk_sched"].shape, 2).form != "signed" \
            or not torch.equal(fused_model.fused_model_epoch(*args, **low_kw),
                               fused_model.fused_model_epoch_plain(*args, **low_kw)):
        raise AssertionError("C1 as 2-bit levels: not the signed chain, or the kernel != plain")
    timed.append(("fused_model_levels low", f"{what}, X as 2-bit levels (the signed chain), compact schedule",
                  lambda: fused_model.fused_model_epoch(*args, **low_kw), None))
    # K1's levels form at C1 8-bit beside the 2-digit route on the same
    # batches (the levels split back into 2 digit planes on the card)
    staged8 = eng8._stage_mega(batcher8)
    big8 = time_buckets("fused_model_levels", staged8, eng8.mega_buckets, "fused_model epoch 8-bit, levels form",
                        lambda f: fused_model.fused_model_epoch_plain(*f.args, **f.keywords))
    idx8, fn8 = staged8[big8]
    a8s, xl8, ws8 = fn8.args[:3]
    lv8 = xl8.to(torch.int32) & 255
    x2_8 = torch.cat([lv8 & 15, lv8 >> 4], dim=1).to(torch.int8)
    kw2_8 = dict(fn8.keywords, x_levels_bits=None, packed=None)  # the digit planes' operands, per launch
    if not torch.equal(fn8(), fused_model.fused_model_epoch(a8s, x2_8, ws8, 8, **kw2_8)):
        raise AssertionError("C1 8-bit: the levels form != the 2-digit route")
    what8 = f"fused_model epoch 8-bit, {len(idx8)} batches of pn={eng8.mega_buckets[big8]['pn']}"
    timed.append(("fused_model_levels", f"{what8}, levels form ({eng8.mega_buckets[big8]['form']})", fn8,
                  lambda: fused_model.fused_model_epoch_plain(*fn8.args, **fn8.keywords)))
    timed.append(("fused_model 2-digit", f"{what8}, the 2-digit route",
                  lambda: fused_model.fused_model_epoch(a8s, x2_8, ws8, 8, **kw2_8), None))
    # the same launch with the compacted block schedule, which the engine's
    # gate keeps for <= 4 bits (a TPU measurement)
    pn8 = eng8.mega_buckets[big8]["pn"]
    sched8 = torch.from_numpy(np.stack([mega_block_sched(batcher8.batches[i].a_words.numpy(), 512,
                                                         fused_model.mega_colblock(pn8)) for i in idx8])).to(dev)
    kwc_8 = dict(fn8.keywords, blk_sched=sched8)
    if not torch.equal(fn8(), fused_model.fused_model_epoch(a8s, xl8, ws8, 8, **kwc_8)):
        raise AssertionError("C1 8-bit: the compacted schedule changed the logits")
    timed.append(("fused_model_levels compact", f"{what8}, levels form with the compacted block schedule",
                  lambda: fused_model.fused_model_epoch(a8s, xl8, ws8, 8, **kwc_8), None))

    def k1_plan_of(a_, x_, ws_, ob, k):
        """fused_model_plan's choice for a K1 call, as printed beside its time."""
        p = fused_model.plan(a_.shape, x_.shape, ws_, ob, k["model"], k.get("shifts"), k.get("out_cols"),
                             None if k.get("blk_sched") is None else k["blk_sched"].shape, k.get("x_levels_bits"))
        kp = fused_model.fused_model_plan(p, k["model"])
        return (f"rows {kp.rows}, cl {kp.cl}, stages {kp.stages}, depth {kp.depth}, "
                f"smem {kp.smem}, grid {kp.grid}")

    k1_plan_str = {"fused_model": k1_plan_of(*args[:3], 2, kw),
                   "fused_model dense": k1_plan_of(*args[:3], 2, dense_kw),
                   "fused_model_levels": k1_plan_of(a8s, xl8, ws8, 8, fn8.keywords),
                   "fused_model 2-digit": k1_plan_of(a8s, x2_8, ws8, 8, kw2_8),
                   "fused_model_levels compact": k1_plan_of(a8s, xl8, ws8, 8, kwc_8),
                   "fused_model_levels low": k1_plan_of(*args[:3], 2, low_kw)}
    for kind, what_, *_ in timed:
        if kind in k1_plan_str:
            k2_plans[what_] = k1_plan_str[kind]
    bbig = time_buckets("fused_baseline", bstaged, beng.mega_buckets, "fused_baseline epoch (sage hidden 16)",
                        lambda f: fused_model.fused_baseline_epoch_plain(*f.args))
    bfn = bstaged[bbig][1]
    timed.append(("fused_baseline", f"fused_baseline epoch (sage hidden 16), {len(bstaged[bbig][0])} batches of "
                  f"pn={beng.mega_buckets[bbig]['pn']}", bfn,
                  lambda: fused_model.fused_baseline_epoch_plain(*bfn.args)))
    # where K5's time goes: the first layer alone (A @ X, 128 columns, then
    # [128 x 40]), and gin's widths (hidden 64) on the same stacks
    w_one = [torch.randn(128, ds.num_classes, generator=torch.Generator().manual_seed(SEED)).to(dev)]
    p_one, p_gin = (fused_model.pack_baseline_weights(w) for w in (w_one, bgin.weights))
    timed.append(("fused_baseline 1 layer", "fused_baseline epoch, first layer only [128 -> 40]",
                  lambda: fused_model.fused_baseline_epoch(*bfn.args[:2], w_one, packed=p_one), None))
    timed.append(("fused_baseline gin", "fused_baseline epoch, gin widths (hidden 64)",
                  lambda: fused_model.fused_baseline_epoch(*bfn.args[:2], bgin.weights, packed=p_gin),
                  None))
    # a record, not the library column: cuBLAS's bf16 batched product for
    # the first layer's aggregation (A and X in bf16), whether the hand
    # kernel's MMAs reach it
    k5_bmm = (bfn.args[0].to(torch.bfloat16), bfn.args[1].to(torch.bfloat16))
    timed.append(("fused_baseline bmm", "torch.bmm bf16 A x X, the first layer's aggregation (a record)",
                  lambda: torch.bmm(*k5_bmm), None))
    for what_, fws in ((timed[-4][1], bfn.args[2]), (timed[-3][1], w_one), (timed[-2][1], bgin.weights)):
        p5 = fused_model.fused_baseline_plan(bfn.args[0].shape, bfn.args[1].shape, [tuple(w.shape) for w in fws],
                                             sms=torch.cuda.get_device_properties(dev).multi_processor_count)
        k2_plans[what_] = (f"groups {p5.groups}, ctas {p5.ctas}, stage depths {p5.kd}, smem {p5.smem}, "
                           f"grid {p5.grid}")
    # zero-tile jumping at C1's shape: batch 0's real adjacency with its
    # map, beside the same call without it (K2; K3 over the adjacency as
    # a digit plane, with the digit builder's map)
    a0, _, tm0 = zeng.put_batch(b0)
    pn0 = a0.padded_rows
    da0 = DigitTensor(digits=packed_levels(a0).to(torch.int8)[None], shape=a0.shape, bits=1)
    tmd0 = digitmm.build_tile_map_digits(da0)
    hs16, hs40 = (on_card(operands(SEED, pn0, pn0, n, 1, 2, 2, 0)[1], 2) for n in (16, 40))
    shp = f"A(batch 0)[{pn0}x{pn0}]"
    k2_plans.update({f"packmm_to_digits {shp} with its map x H[{pn0}x16]": plan_of(a0, hs16, 2, tile_map=tm0),
                     f"packmm_to_digits {shp} x H[{pn0}x16], no map": plan_of(a0, hs16, 2),
                     f"packmm_to_f32 {shp} with its map x H[{pn0}x40]": plan_of(a0, hs40, None, "f32",
                                                                                tile_map=tm0),
                     f"packmm_to_f32 {shp} x H[{pn0}x40], no map": plan_of(a0, hs40, None, "f32")})
    timed += [
        ("packmm_skip", f"packmm_to_digits {shp} with its map x H[{pn0}x16]",
         lambda: packmm.packmm_to_digits(a0, hs16, 2, tm0), lambda: packmm.packmm_plain(a0, hs16, 2, tile_map=tm0)),
        ("packmm_skip dense", f"packmm_to_digits {shp} x H[{pn0}x16], no map",
         lambda: packmm.packmm_to_digits(a0, hs16, 2), None),
        ("packmm_skip f32", f"packmm_to_f32 {shp} with its map x H[{pn0}x40]",
         lambda: packmm.packmm_to_f32(a0, hs40, tm0), lambda: packmm.packmm_plain(a0, hs40, tile_map=tm0)),
        ("packmm_skip f32 dense", f"packmm_to_f32 {shp} x H[{pn0}x40], no map",
         lambda: packmm.packmm_to_f32(a0, hs40), None),
        ("digitmm_skip", f"digitmm_to_digits {shp} digit plane with its map x H[{pn0}x16]",
         lambda: digitmm.digitmm_to_digits(da0, hs16, 2, tmd0),
         lambda: digitmm.digitmm_plain(da0, hs16, 2, tile_map=tmd0)),
        ("digitmm_skip dense", f"digitmm_to_digits {shp} digit plane x H[{pn0}x16], no map",
         lambda: digitmm.digitmm_to_digits(da0, hs16, 2), None),
    ]
    # the device work of one resident step epoch in each format (E1, E1z,
    # E4), and of one replay of each captured epoch (E5, E5z, E6, B2)
    epoch_tag = {}
    for what, stepper in (("digits (E1)", eng), ("digits with zero-tile jumping (E1z)", zeng),
                          ("bits (E4)", beng4)):
        staged_b = [stepper.put_batch(b) for b in batcher.batches]
        epoch_tag[len(timed)] = what[what.index("(") + 1:-1]
        timed.append(("step epoch", f"one resident step epoch, {what}, all its kernels",
                      lambda st=stepper, sb=staged_b: [st._step(*t) for t in sb], None))
    for what, epoch in captured.items():
        epoch_tag[len(timed)] = what[what.index("(") + 1:-1]
        timed.append(("captured epoch", f"one captured epoch's replay, {what}, all its kernels", epoch, None))
    # the kernel sweep's K4 and K2 packed-out rows at Fig. 8a's largest shape
    k4c = next(c for c in sweep["8a"] if (c.bits, c.M, c.N) == (8, 4096, 64))
    k2c = next(c for c in sweep["8a"] if (c.bits, c.M, c.N) == (1, 4096, 64))
    timed.append(("packmm_signed", "packmm_to_packed 8-bit A[4096x4096] x PreparedRHS[4096x64] "
                  "to the signed plane, out_cols=64", k4c.run, k4c.plain))
    timed.append(("packmm packed", "packmm_to_packed 1-bit A[4096x4096] x B[4096x64] to 1-bit words",
                  k2c.run, k2c.plain))
    k2_plans["packmm_to_packed 1-bit A[4096x4096] x B[4096x64] to 1-bit words"] = plan_of(k2c.a, k2c.b, 1, "packed")
    k2_plans["packmm_to_packed 8-bit A[4096x4096] x PreparedRHS[4096x64] to the signed plane, out_cols=64"] = \
        plan_of(k4c.a, k4c.b, 8, "packed", out_cols=64)
    # K2's 8-bit plane at the same shape (K4's kernel, colsum correction):
    # 8-bit A[4096²] x an 8-bit DigitTensor B[4096x64] (two digit planes)
    # to the signed plane and to f32 (out_cols 64), dense and over a blocky
    # A (every third 256 x 256 tile occupied) with its map; each equal to
    # plain first
    k28_rng = np.random.default_rng(SEED)
    b8 = digit_pack(torch.from_numpy(k28_rng.integers(0, 256, (4096, 64))).to(dev), 8)
    a8 = pack_rows(torch.from_numpy(k28_rng.integers(0, 256, (4096, 4096))).to(dev), 8)
    a8m = pack_rows(torch.from_numpy(blocky_levels(SEED, 4096, 4096, 8, 0.3)).to(dev), 8)
    tm8 = packmm.build_tile_map_packed(a8m)
    k28_shape = "8-bit A[4096x4096] x B[4096x64] 8-bit (2 digit planes)"
    k28_rows = {"packmm 8-bit": (f"packmm_to_packed {k28_shape} to the signed plane, out_cols=64", a8, None, 8),
                "packmm 8-bit f32": (f"packmm_to_f32 {k28_shape}, out_cols=64", a8, None, None),
                "packmm 8-bit map": (f"packmm_to_packed blocky {k28_shape} with its map to the signed plane, "
                                     f"out_cols=64", a8m, tm8, 8),
                "packmm 8-bit map f32": (f"packmm_to_f32 blocky {k28_shape} with its map, out_cols=64", a8m, tm8,
                                         None)}
    for kind, (what, a_, tm_, ob) in k28_rows.items():
        form = "packed" if ob else "f32"
        run = functools.partial(packmm._packmm, a_, b8, ob, form, 0, False, 64, tm_)
        plain = functools.partial(packmm.packmm_plain, a_, b8, ob, 0, False, form, 64, tm_)
        compare("packmm", run(), plain(), what)
        timed.append((kind, what, run, plain))
        k2_plans[what] = plan_of(a_, b8, ob, form, out_cols=64, tile_map=tm_)
    # the kernel-study probes at their studies' shapes: P1's concat at C1's
    # aggregation and its packed out at JAX's first run_packedout row, P2
    # at its probe's shapes, P3 at pn 2048 x 50 batches (zero body G 1, two
    # K-dot passes, oc 48)
    prng = np.random.default_rng(SEED)
    p1_qa, p1_qb, p1_b = exp_packmm.operands(2560, 2560, 16, 1, prng, dev)
    p1_w = torch.from_numpy(exp_packmm.pack_rows_np(p1_qa, 1, 256)[None]).to(dev)
    p1o_qa, p1o_qb, p1o_b = exp_packmm.operands(4096, 4096, 16, 1, prng, dev)
    p1o_w = torch.from_numpy(exp_packmm.pack_rows_np(p1o_qa, 1, 4096)[None]).to(dev)
    # K2's yardsticks, timed in the main session beside K2: P1's concat on
    # a 16-column tile at C1 (above) and P1b's 4096^2 N 64 row (JAX's last
    # run_packedout row, on P1b's CTAs that own whole word rows)
    p1w_qa, p1w_qb, p1w_b = exp_packmm.operands(4096, 4096, 64, 1, prng, dev)
    p1w_w = torch.from_numpy(exp_packmm.pack_rows_np(p1w_qa, 1, 256)[None]).to(dev)
    timed += [
        ("yardstick P1 concat", "P1 concat, 1-bit words A[2560x2560] (tm 256) x B[2560x16] (16-column tile)",
         lambda: exp_packmm.packmm_exp(p1_w, p1_b, 1, 256), None),
        ("yardstick P1b", "P1b packed out, 1-bit A[4096x4096] (group 256) x B[4096x64]",
         lambda: exp_packmm.packmm_exp_packedout(p1w_w, p1w_b, 1, 4096, 256), None),
    ]
    p2_w = torch.from_numpy(table32.view(np.int32)).to(dev)
    p2_b = torch.from_numpy(table8).to(dev)
    # P3: random operands; the zero body takes turns over enough copies of
    # X that each call reads its X from HBM, not the L2
    p3_gen = torch.Generator(device=dev).manual_seed(SEED)
    p3_xs = [grid_overhead_study.random_x(50, 2048, p3_gen, dev)
             for _ in range(grid_overhead_study.l2_copies(50 * 2048 * 128))]
    p3_x = p3_xs[0]
    p3_s = torch.randint(-128, 128, (2048, 2048), dtype=torch.int8, device=dev, generator=p3_gen)
    p3_turn = grid_overhead_study.in_turns(lambda x: grid_overhead_study.zero_body(x, 48, 1), p3_xs)
    timed += [
        ("exp_packmm", "packmm_exp concat, 1-bit words A[2560x2560] (tm 256) x B[2560x16]",
         lambda: exp_packmm.packmm_exp(p1_w, p1_b, 1, 256), lambda: exp_packmm.packmm_exp_plain(p1_w, p1_b, 1, 256)),
        ("exp_packmm_packedout", "packmm_exp_packedout 1-bit A[4096x4096] (tm 4096, group 0) x B[4096x16]",
         lambda: exp_packmm.packmm_exp_packedout(p1o_w, p1o_b, 1, 4096),
         lambda: exp_packmm.packmm_exp_packedout_plain(p1o_w, p1o_b, 1, 4096)),
        ("bitcast32to8", "bitcast32to8 int32 [8x128]", lambda: exp_bitcast_probe.bitcast32to8(p2_w),
         lambda: exp_bitcast_probe.bitcast32to8_plain(p2_w)),
        ("bitcast8to32", "bitcast8to32 int8 [32x128]", lambda: exp_bitcast_probe.bitcast8to32(p2_b),
         lambda: exp_bitcast_probe.bitcast8to32_plain(p2_b)),
        ("fragment_probe", "fragment_registers int8 tiles [64x64] x 2",
         lambda: exp_bitcast_probe.fragment_registers(tiles[0], tiles[1]),
         lambda: exp_bitcast_probe.fragment_registers_plain(tiles[0], tiles[1])),
        ("zero_body", f"zero_body X[50x2048x128] (in turns over {len(p3_xs)} copies), G 1, oc 48", p3_turn,
         lambda: grid_overhead_study.zero_body_plain(p3_x, 48, 1)),
        ("kdot", "kdot X[50x2048x128] x S[2048x2048], K 2, oc 48", lambda: grid_overhead_study.kdot(p3_x, p3_s, 48, 2),
         lambda: grid_overhead_study.kdot_plain(p3_x, p3_s, 48, 2)),
    ]
    # the library yardstick of packmm and digitmm: cuBLAS int8 on the
    # unpacked levels at the same shapes (the port never calls it)
    lib_ops = {"packmm": (unpack_rows(a).to(torch.int8), digit_unpack(h16).to(torch.int8)),
               "digitmm": (digit_unpack(x).to(torch.int8), digit_unpack(w1).to(torch.int8)),
               **{kind: (unpack_bits(l).to(torch.int8), unpack_bits(r).to(torch.int8))
                  for kind, _, l, r, _ in k6_rows},
               # K4: the signed plane's N real columns (the ones lane and
               # the padding are the TPU layout's, not the product's)
               "packmm_signed": (k4c.a.words[0], k4c.b.plane[:, :k4c.N].contiguous()),
               "packmm packed": (unpack_rows(k2c.a).to(torch.int8), digit_unpack(k2c.b).to(torch.int8)),
               # K2's 8-bit plane: the signed A plane and B's levels - 128
               # (int8 operands of the same shapes; dense, also for the map rows)
               **{kind: (a8.words[0], (digit_unpack(b8) - 128).to(torch.int8)) for kind in k28_rows},
               # the K skip's shapes: batch 0's adjacency, dense in int8
               "packmm_skip": (unpack_rows(a0).to(torch.int8), digit_unpack(hs16).to(torch.int8)),
               "packmm_skip f32": (unpack_rows(a0).to(torch.int8), digit_unpack(hs40).to(torch.int8))}
    lib_ops["digitmm_skip"] = lib_ops["packmm_skip"]
    # the probes without an int8 product: one PyTorch expression each for
    # the same function (bytes to rows by a strided copy, the inverse),
    # checked against plain first. P3a's zero body has none: torch.zeros
    # reads none of the X that the probe reads by design.
    lib_calls = {
        "bitcast32to8": lambda: gemm_times.strided_32to8(p2_w),
        "bitcast8to32": lambda: gemm_times.strided_8to32(p2_b),
    }
    for kind, fn in lib_calls.items():
        plain = next(t[3] for t in timed if t[0] == kind)
        if not torch.equal(fn(), plain()):
            raise AssertionError(f"{kind}: the library expression != plain")
    # P3b: one torch._int_mm a pass, S times the 50 batches' rolled columns
    # side by side, only the round_up(oc, 8) = 48 that the function keeps
    # (the kernel computes round_up(oc, 16), the bound counts oc), laid out
    # column-major (the layout at which cuBLAS runs int8 fastest on the
    # card), checked against plain first
    p3_lib_x = [torch.roll(p3_x, k, dims=2)[..., :48].permute(0, 2, 1).reshape(-1, 2048).contiguous().t()
                for k in range(2)]
    lib_calls["kdot"] = lambda: [torch._int_mm(p3_s, xk) for xk in p3_lib_x]
    kdot_lib = sum(lib_calls["kdot"]()).view(2048, 50, 48).permute(1, 0, 2).float()
    if not torch.equal(kdot_lib, grid_overhead_study.kdot_plain(p3_x, p3_s, 48, 2)):
        raise AssertionError("kdot: the library's passes != plain")
    # P1: the same product of the unpacked levels
    for kind, qa_, qb_ in (("exp_packmm", p1_qa, p1_qb), ("exp_packmm_packedout", p1o_qa, p1o_qb)):
        lib_ops[kind] = tuple(torch.from_numpy(q.astype(np.int8)).to(dev) for q in (qa_, qb_))
    # device time per call from one profiler session, in turns:
    # plain, kernel, kernel, plain
    fns = {}
    for i, (_, what, kern, plain) in enumerate(timed):
        for side, rep in (("plain", 0), ("kernel", 0), ("kernel", 1), ("plain", 1)):
            if side == "kernel" or plain is not None:
                fns[(i, side, rep)] = kern if side == "kernel" else plain
    for kind, (la, lb) in lib_ops.items():
        for rep in (0, 1):
            fns[(kind, "library", rep)] = lambda la=la, lb=lb: torch._int_mm(la, lb)
    for kind, fn in lib_calls.items():
        for rep in (0, 1):
            fns[(kind, "library", rep)] = fn
    # P2a's floor, in the probes' session: the device time of the smallest
    # kernel PyTorch launches (torch.zeros(1)'s fill)
    for rep in (0, 1):
        fns[("launch floor", "floor", rep)] = lambda: torch.zeros(1, device=dev)
    # P2 at 16 MB and 128 MB (gemm_times.P2_SIZES past the probe's shape,
    # which the rows above time; each call takes the next of enough copies
    # that its input is out of the L2), each probe beside its strided copy
    # on the same inputs, in the probes' session; each copy checked
    # against plain
    p2_sizes = {}
    for label, bs, ws in gemm_times.p2_operands(SEED, dev)[1:]:
        for kind, xs, kern, lib, plain in (
                ("bitcast8to32", bs, exp_bitcast_probe.bitcast8to32, gemm_times.strided_8to32,
                 exp_bitcast_probe.bitcast8to32_plain),
                ("bitcast32to8", ws, exp_bitcast_probe.bitcast32to8, gemm_times.strided_32to8,
                 exp_bitcast_probe.bitcast32to8_plain)):
            if not torch.equal(lib(xs[0]), plain(xs[0])):
                raise AssertionError(f"{kind} at {label}: the strided copy != plain")
            p2_sizes[f"P2 {kind} {label}"] = (kind, label, xs)
            for side, f in (("kernel", kern), ("library", lib)):
                for rep in (0, 1):
                    fns[(f"P2 {kind} {label}", side, rep)] = grid_overhead_study.in_turns(f, xs)
    # every kernel-sweep row, in the same session
    for fig, cases in sweep.items():
        for i, c in enumerate(cases):
            fns[("sweep", fig, i)] = c.run
    # plain versions and step epochs run thousands of small ops per call,
    # and a session that holds too many records can lose some: one call each
    many = {i for i, t in enumerate(timed) if t[0] in ("step epoch", "captured epoch")}
    # the probes, and the captured epochs, in sessions of their own, so
    # that the main session holds no more records than it did without them
    # (a session that holds too many loses its last markers)
    probe_kinds = set(probe_launches)
    probe_idx = {i for i, t in enumerate(timed) if t[0] in probe_kinds}
    captured_idx = {i for i, t in enumerate(timed) if t[0] == "captured epoch"}
    # the smaller buckets' launches and their plain epochs, too
    other_buckets = {kind for parts in bucket_parts.values() for kind, _, _ in parts if kind not in bucket_parts}
    bucket_idx = {i for i, t in enumerate(timed) if t[0] in other_buckets}

    def session(k):
        return (1 if k[0] in probe_idx or k[0] in probe_kinds or k[0] in p2_sizes or k[0] == "launch floor"
                else 2 if k[0] in captured_idx
                else 3 if k[0] in bucket_idx else 0)

    dt = {}
    for s_id in (0, 1, 2, 3):
        sess = {k: f for k, f in fns.items() if session(k) == s_id}
        dt.update(device_times_ms(sess, iters={k: 1 if k[1] == "plain" or k[0] in many else
                                               10 if k[0] == "sweep" else 5 for k in sess}, warmup=1))
    times, kernel_ms, epoch_dev_ms = {}, {}, {}
    for i, (kind, what, _, plain) in enumerate(timed):
        k_ms = min(dt[(i, "kernel", 0)], dt[(i, "kernel", 1)])
        kernel_ms.setdefault(kind, k_ms)
        if what in k2_plans:
            what = f"{what} (plan: {k2_plans[what]})"
        if i in epoch_tag:
            epoch_dev_ms[epoch_tag[i]] = k_ms
        if plain is None:
            print(f"phase 3: {what}: kernel {k_ms * 1e3:.1f} us device time per call [{card}]")
            continue
        p_ms = min(dt[(i, "plain", 0)], dt[(i, "plain", 1)])
        times.setdefault(kind, (k_ms, p_ms))
        print(f"phase 3: {what}: kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us "
              f"device time per call [{card}]")
    # B3's epoch is one fused_baseline launch a bucket
    epoch_dev_ms["B3"] = sum(kernel_ms[kind] for kind, _, _ in bucket_parts["fused_baseline"])
    print("phase 3: epochs of one call, host ms/epoch (3 runs) and device ms/epoch: "
          + "; ".join(f"{k} " + " / ".join(f"{v:.3f}" for v in host_ms[k]) + f" (device {epoch_dev_ms[k]:.3f})"
                      for k in host_ms) + f" [{card}]")
    lib_ms = {kind: min(dt[(kind, "library", 0)], dt[(kind, "library", 1)]) for kind in (*lib_ops, *lib_calls)}
    print(f"phase 3: torch._int_mm on the unpacked int8 operands (library yardstick): "
          + ", ".join(f"{k} shape {lib_ms[k] * 1e3:.1f} us" for k in lib_ops) + f" [{card}]")
    print(f"phase 3: one PyTorch expression for the same function (library yardstick): "
          + ", ".join(f"{k} {lib_ms[k] * 1e3:.1f} us" for k in lib_calls) + f" [{card}]")
    # each row beside its bound: A's bytes, of B its N real columns (and of
    # a PreparedRHS's corr its N entries), the output; 2 M N K operations
    def sweep_bound(c):
        size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
        out = c.run()
        if c.int8:
            moved = size(c.a, c.b, out)
        elif isinstance(c.b, packmm.PreparedRHS):
            moved = size(c.a.words, c.b.plane[:, :c.N], c.b.corr[0, :c.N], out.words)
        else:
            moved = size(c.a.words, c.b.digits[:, :, :c.N], out.words)
        b_ms, by = bound(moved, 2 * c.M * c.N * c.K, "int8")
        return f"bound {b_ms * 1e3:.2f} us ({by})"

    for fig, cases in sweep.items():
        for i, c in enumerate(cases):
            r = c.row(dt[("sweep", fig, i)])
            k2 = "" if c.int8 else f" (plan: {plan_of(c.a, c.b, c.bits, 'packed', out_cols=c.out_cols)})"
            print(f"phase 3: sweep {fig} bits={r['bits']} M=K={r['M']} N={r['N']}: {r['us']} us, "
                  f"{r['tflops']} TFLOP/s, {sweep_bound(c)} [{card}]; sm_86 {SM86[(fig, c.bits, c.M, c.N)]} "
                  f"TFLOP/s{k2}")

    # K2 against its yardsticks, all from the one profiler session above
    k2_16_ms = next(dt[("sweep", "8a", i)] for i, c in enumerate(sweep["8a"]) if (c.bits, c.M, c.N) == (1, 4096, 16))
    k2_reads = [
        ("packed words 1-bit 4096^2 x 64 below torch._int_mm", kernel_ms["packmm packed"],
         lib_ms["packmm packed"], kernel_ms["packmm packed"] < lib_ms["packmm packed"]),
        ("packed words 1-bit 4096^2 x 64 at or below P1b's 4096^2 N 64 row", kernel_ms["packmm packed"],
         kernel_ms["yardstick P1b"], kernel_ms["packmm packed"] <= kernel_ms["yardstick P1b"]),
        ("packed words 1-bit 4096^2 x 16 (the sweep's row) at or below P1b's first row (word-row CTAs)",
         k2_16_ms, times["exp_packmm_packedout"][0], k2_16_ms <= times["exp_packmm_packedout"][0]),
        ("C1 to digits at or below P1's concat 16-column row", kernel_ms["packmm"],
         kernel_ms["yardstick P1 concat"], kernel_ms["packmm"] <= kernel_ms["yardstick P1 concat"]),
        ("C1 with batch 0's map below the dense C1 row", kernel_ms["packmm_skip"], kernel_ms["packmm"],
         kernel_ms["packmm_skip"] < kernel_ms["packmm"]),
        ("C1 with batch 0's map below batch 0 without it", kernel_ms["packmm_skip"],
         kernel_ms["packmm_skip dense"], kernel_ms["packmm_skip"] < kernel_ms["packmm_skip dense"]),
    ]
    for what, k_ms, y_ms, met in k2_reads:
        print(f"phase 3: K2 {what}: {k_ms * 1e3:.2f} against {y_ms * 1e3:.2f} us, "
              f"{'met' if met else 'not met'} [{card}]")
    # K6 against K2 and the library, from the same session
    k6_reads = [("C1 aggregation to bits at or below K2's C1 aggregation to digits", kernel_ms["bitmm"],
                 kernel_ms["packmm"])]
    k6_reads += [(f"{kind} below torch._int_mm on its unpacked operands", kernel_ms[kind], lib_ms[kind])
                 for kind, *_ in k6_rows]
    print(f"phase 3: K5's first layer {kernel_ms['fused_baseline 1 layer'] * 1e3:.1f} us (its aggregation, "
          f"update and X's conversion) against cuBLAS's bf16 aggregation alone (torch.bmm, a record) "
          f"{kernel_ms['fused_baseline bmm'] * 1e3:.1f} us [{card}]")
    for what, k_ms, y_ms in k6_reads:
        print(f"phase 3: K6 {what}: {k_ms * 1e3:.2f} against {y_ms * 1e3:.2f} us, "
              f"{'met' if k_ms <= y_ms else 'not met'} [{card}]")

    # bounds at the timed shapes: inputs read once, outputs written once;
    # of B only its 16 real columns (the padding is layout, not work of the
    # function), of a digit-plane output every column it stores
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    bounds = {
        "packmm": bound(nbytes(a.words, h16.digits[:, :, :16], packmm.packmm_to_digits(a, h16, 2).digits),
                        2 * 2560 * 2560 * 16, "int8"),
        "digitmm": bound(nbytes(x.digits, w1.digits[:, :, :16], digitmm.digitmm_to_digits(x, w1, 2).digits),
                         2 * 2560 * 128 * 16, "int8"),
    }
    # K6: of A and B only their real columns (the words of A's K columns,
    # of B's real N columns and the word rows that hold its K rows), the
    # output whole (the kernel writes its padded words); 2 M N K int8
    # operations per pair of base-16 digits on the logical shapes. The work
    # of the planned grid (its computed columns) is printed beside.
    def bit_bound(lhs, rhs, out_bits, what):
        out = bitgemm.bitmm_to_bits(lhs, rhs, out_bits) if out_bits else bitgemm.bitmm_to_int(lhs, rhs)
        out_bytes = nbytes(out.planes) if out_bits else lhs.padded_rows * rhs.padded_cols * 4
        K, N = lhs.shape[1], rhs.shape[1]
        pairs = num_digits(lhs.bits) * num_digits(rhs.bits)
        ops = 2 * lhs.shape[0] * N * K * pairs
        p6 = bitgemm.bitmm_plan(lhs.padded_rows, lhs.padded_cols, rhs.padded_cols, N, "bits" if out_bits else "f32")
        computed = 2 * lhs.padded_rows * p6.grid[0] * p6.bnt * lhs.padded_cols * pairs
        print(f"phase 3: {what}: {ops / 1e9:.3f} G int8 operations needed, {computed / 1e9:.3f} G "
              f"on the columns and padded K the planned grid computes")
        in_bytes = nbytes(lhs.planes[:, :, :K], rhs.planes[:, :-(-K // 32), :N])
        return bound(in_bytes + out_bytes, ops, "int8")

    # K4 and K2 packed out: 2 M N K int8 operations on the logical shapes;
    # of B only the N real columns (and of K4's corr its N entries), since
    # the padding and the ones lane are layout, not work of the function
    k4_out, k2_out = k4c.run(), k2c.run()
    bounds["packmm_signed"] = bound(nbytes(k4c.a.words, k4c.b.plane[:, :k4c.N], k4c.b.corr[0, :k4c.N],
                                           k4_out.words), 2 * k4c.M * k4c.N * k4c.K, "int8")
    bounds["packmm packed"] = bound(nbytes(k2c.a.words, k2c.b.digits[:, :, :k2c.N], k2_out.words),
                                    2 * k2c.M * k2c.N * k2c.K, "int8")
    for kind, what, l, r, ob in k6_rows:
        bounds[kind] = bit_bound(l, r, ob, what)
    # K1: the logical work (2 pn^2 N per aggregation over the blocks the
    # schedule lists, 2 pn K N per update, per digit pair on the logical
    # shapes) and the bytes of its operands, logits and schedule
    def k1_bound(a_st, x_st, ws_k1, out, sched):
        pn_k1, B_k1 = a_st.shape[2], a_st.shape[0]
        share = 1.0
        if sched is not None:
            cb = pn_k1 // (sched.shape[2] - 1)
            share = float(sched[:, :, 0].sum().item()) * (pn_k1 // sched.shape[1]) * cb / (B_k1 * pn_k1 ** 2)
        k1_w = [w.shape for w in ws_k1]
        ops = B_k1 * (2 * pn_k1 ** 2 * share * sum(s[1] for s in k1_w)
                      + 2 * pn_k1 * sum(s[0] * s[1] for s in k1_w))
        return bound(nbytes(a_st, x_st, *(w.digits for w in ws_k1), out)
                     + (0 if sched is None else nbytes(sched)), ops, "int8")

    a_st, x_st, ws_k1 = args[0], args[1], args[2]
    bounds["fused_model"] = k1_bound(a_st, x_st, ws_k1, mega_fn(), kw["blk_sched"])
    # K1's levels form: the same logical work, X one byte a value
    bounds["fused_model_levels"] = k1_bound(a8s, xl8, ws8, fn8(), None)
    c1_pn, c18_pn = f"pn={eng.mega_buckets[big]['pn']}", f"pn={pn8}"
    k1_rows = {"fused_model": (f"C1 {c1_pn}, compact", bounds["fused_model"], "fused_model"),
               "fused_model dense": (f"C1 {c1_pn}, dense", k1_bound(a_st, x_st, ws_k1, mega_fn(), None),
                                     "fused_model"),
               "fused_model_levels": (f"C1-8 {c18_pn}, levels (signed), dense", bounds["fused_model_levels"],
                                      "fused_model_levels"),
               "fused_model_levels compact": (f"C1-8 {c18_pn}, levels (signed), C1's schedule",
                                              k1_bound(a8s, xl8, ws8, fn8(), sched8), "fused_model_levels"),
               "fused_model_levels low": (f"C1 {c1_pn} as 2-bit levels (signed), compact", bounds["fused_model"],
                                          "fused_model")}
    for k, (row, (b_ms, by), plain_of) in k1_rows.items():
        print(f"phase 3: K1 {row}: kernel {kernel_ms[k] * 1e3:.1f} us, plain {times[plain_of][1] * 1e3:.1f} us, "
              f"bound {b_ms * 1e3:.2f} us ({by}), library none; plan {k1_plan_str[k]} [{card}]")
    print(f"phase 3: K1 at C1 8-bit, {c18_pn}: levels form {kernel_ms['fused_model_levels'] * 1e3:.1f} us "
          f"(compacted schedule {kernel_ms['fused_model_levels compact'] * 1e3:.1f}), the 2-digit route "
          f"{kernel_ms['fused_model 2-digit'] * 1e3:.1f} us a launch; 2-bit, {c1_pn}: "
          f"{kernel_ms['fused_model'] * 1e3:.1f} compact, {kernel_ms['fused_model dense'] * 1e3:.1f} dense [{card}]")

    def k5_bound(fn_):
        ba, bx, bws = fn_.args
        k5_ops = ba.shape[0] * sum(2 * ba.shape[1] ** 2 * w.shape[0] + 2 * ba.shape[1] * w.shape[0] * w.shape[1]
                                   for w in bws)
        return bound(nbytes(ba, bx, *bws, fn_()), k5_ops, "bf16")

    # the epoch of each mega path: its launches' times and bounds summed
    # over the buckets (the launches run one after another), bound by what
    # bounds the launch with the largest bound
    bound_of = {"fused_model": lambda f: k1_bound(*f.args[:3], f(), f.keywords.get("blk_sched")),
                "fused_model_levels": lambda f: k1_bound(*f.args[:3], f(), f.keywords.get("blk_sched")),
                "fused_baseline": k5_bound}
    for kernel, parts in bucket_parts.items():
        rows = [(kind, pn, *bound_of[kernel](fn_)) for kind, pn, fn_ in parts]
        k_sum, p_sum = (sum(times[kind][s] for kind, *_ in rows) for s in (0, 1))
        b_sum, by = sum(r[2] for r in rows), max(rows, key=lambda r: r[2])[3]
        print(f"phase 3: {kernel} epoch at C1, {len(rows)} launches (one a bucket): "
              + "; ".join(f"pn={pn} kernel {times[kind][0] * 1e3:.1f} us, plain {times[kind][1] * 1e3:.1f}, "
                          f"bound {b_ms * 1e3:.2f} ({by_})" for kind, pn, b_ms, by_ in rows)
              + f"; the epoch: kernel {k_sum * 1e3:.1f} us, plain {p_sum * 1e3:.1f}, bound {b_sum * 1e3:.2f}"
              f" ({by}) [{card}]")
        times[kernel], bounds[kernel] = (k_sum, p_sum), (b_sum, by)

    # the K skip: only the listed tiles' bytes of A (and of B the n real
    # columns of the K tiles some row tile lists) and 2 * tile_m * tile_k * n
    # operations per listed tile, n the logical columns
    def skip_bound(tm, a_tile_bytes, b, out, n, pairs=1):
        kcnt = tm.kcnt.clamp(0, tm.kidx.shape[1])
        visit = torch.arange(tm.kidx.shape[1], device=dev)[None, :] < kcnt[:, None]
        listed, k_tiles = int(kcnt.sum()), int(tm.kidx[visit].unique().numel())
        b_bytes = k_tiles * tm.tile_k * b.digits.shape[0] * n
        ops = 2 * tm.tile_m * tm.tile_k * n * listed * pairs
        return bound(listed * a_tile_bytes + b_bytes + nbytes(out), ops, "int8"), listed

    (bounds["packmm_skip"], listed0) = skip_bound(tm0, 256 * 256 // 8, hs16,
                                                  packmm.packmm_to_digits(a0, hs16, 2, tm0).digits, 16)
    bounds["packmm_skip f32"] = skip_bound(tm0, 256 * 256 // 8, hs40, packmm.packmm_to_f32(a0, hs40, tm0), 40)[0]
    bounds["digitmm_skip"] = skip_bound(tmd0, 256 * 256, hs16,
                                        digitmm.digitmm_to_digits(da0, hs16, 2, tmd0).digits, 16)[0]
    # K2's 8-bit plane: A's bytes (or its listed tiles'), B's two digit
    # planes' 64 real columns, the output; 2 M N K int8 operations per
    # digit pair (one of A's plane, two of B's)
    for kind, (what, a_, tm_, ob) in k28_rows.items():
        out_ = packmm._packmm(a_, b8, ob, "packed" if ob else "f32", 0, False, 64, tm_)
        out_ = out_.words if ob else out_
        if tm_ is None:
            bounds[kind] = bound(nbytes(a_.words, b8.digits[:, :, :64], out_), 2 * 4096 * 64 * 4096 * 2, "int8")
        else:
            bounds[kind], listed8 = skip_bound(tm_, tm_.tile_m * tm_.tile_k, b8, out_, 64, pairs=2)
    print(f"phase 3: K2's 8-bit plane over the blocky A: {listed8} of {tm8.kidx.numel()} tiles listed; "
          + "; ".join(f"{k} {kernel_ms[k] * 1e3:.1f} us" for k in k28_rows) + f" [{card}]")
    print(f"phase 3: K skip at C1, batch 0: {listed0} of {tm0.kidx.numel()} tiles listed; "
          + "; ".join(f"{k} {kernel_ms[k] * 1e3:.1f} us with its map, {kernel_ms[k + ' dense'] * 1e3:.1f} "
                      f"without" for k in ("packmm_skip", "packmm_skip f32", "digitmm_skip")) + f" [{card}]")
    # the probes: their inputs and outputs; P1 2 M N K on the logical
    # shapes, kdot 2 B K pn^2 oc (the stored columns need no more)
    p1_out, p1o_out = exp_packmm.packmm_exp(p1_w, p1_b, 1, 256), exp_packmm.packmm_exp_packedout(p1o_w, p1o_b, 1, 4096)
    bounds["exp_packmm"] = bound(nbytes(p1_w, p1_b, p1_out), 2 * 2560 * 16 * 2560, "int8")
    bounds["exp_packmm_packedout"] = bound(nbytes(p1o_w, p1o_b, p1o_out), 2 * 4096 * 16 * 4096, "int8")
    bounds["bitcast32to8"] = bound(2 * nbytes(p2_w), 0, "int8")
    bounds["bitcast8to32"] = bound(2 * nbytes(p2_b), 0, "int8")
    bounds["fragment_probe"] = bound(nbytes(tiles) + 32 * 6 * 4, 0, "int8")
    bounds["zero_body"] = bound(nbytes(p3_x) + 50 * 2048 * 48 * 4, 0, "int8")
    bounds["kdot"] = bound(nbytes(p3_x, p3_s) + 50 * 2048 * 48 * 4, 2 * 50 * 2 * 2048 ** 2 * 48, "int8")
    for k, (b_ms, by) in bounds.items():
        lib = f", library {lib_ms[k] * 1e3:.1f} us" if k in lib_ms else ""
        print(f"phase 3: {k} bound {b_ms * 1e3:.2f} us ({by}); kernel {times[k][0] * 1e3:.1f} us, "
              f"plain {times[k][1] * 1e3:.1f} us{lib} [{card}]")
    floor_ms = min(dt[("launch floor", "floor", 0)], dt[("launch floor", "floor", 1)])
    print(f"phase 3: bitcast32to8 kernel {times['bitcast32to8'][0] * 1e3:.2f} us, bitcast8to32 kernel "
          f"{times['bitcast8to32'][0] * 1e3:.2f} us against the launch floor {floor_ms * 1e3:.2f} us "
          f"(torch.zeros(1)'s fill, the same profiler session) [{card}]")
    for key, (kind, label, xs) in p2_sizes.items():
        k_ms, l_ms = (min(dt[(key, side, 0)], dt[(key, side, 1)]) for side in ("kernel", "library"))
        b_ms, by = bound(2 * nbytes(xs[0]), 0, "int8")
        print(f"phase 3: {kind} {str(xs[0].dtype).split('.')[-1]} [{xs[0].shape[0]}x{xs[0].shape[1]}] ({label}, "
              f"in turns over {len(xs)} copies): kernel {k_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us ({by}; "
              f"the input alone {b_ms / 2 * 1e3:.3f}), strided copy {l_ms * 1e3:.2f} us, launch floor "
              f"{floor_ms * 1e3:.2f} us [{card}]")

    sources = {"packmm": ("packmm_k2.cuh", "qgtc_ppopp22_tpu/ops/packmm.py:664", launches),
               "digitmm": ("digitmm_k3.cuh", "qgtc_ppopp22_tpu/ops/digitmm.py:193", launches),
               "fused_model": ("fused_model_k1.cuh", "qgtc_ppopp22_tpu/ops/fused_model.py:329",
                               mega_launches),
               # levels-form X: the 8-bit mega path's signed-chain launches
               "fused_model_levels": ("fused_model_k1.cuh", "qgtc_ppopp22_tpu/ops/fused_model.py:329",
                                      levels_launches),
               "fused_baseline": ("fused_baseline_k5.cuh", "qgtc_ppopp22_tpu/ops/fused_model.py:1299",
                                  base_launches),
               "bitmm": ("bitmm_k6.cuh", "qgtc_ppopp22_tpu/ops/bitgemm.py:266", bits_launches),
               "packmm_signed": ("packmm_k4.cuh", "qgtc_ppopp22_tpu/ops/packmm.py:473",
                                 sweep_launches),
               # the TileMap K skip: the zero-tile path's mapped launches
               "packmm_skip": ("packmm_k2.cuh", "qgtc_ppopp22_tpu/ops/packmm.py:664",
                               {"packmm_skip": zero_launches["packmm with a map"]}),
               "digitmm_skip": ("digitmm_k3.cuh", "qgtc_ppopp22_tpu/ops/digitmm.py:193", digit_a_launches),
               # the kernel-study probes: the studies' launches
               "exp_packmm": ("exp_packmm.cu", "benchmarks/exp_packmm.py:146", probe_launches),
               "exp_packmm_packedout": ("exp_packmm_packed.cu", "benchmarks/exp_packmm.py:60", probe_launches),
               "bitcast32to8": ("exp_bitcast_probe.cu", "benchmarks/exp_bitcast_probe.py:20", probe_launches),
               "bitcast8to32": ("exp_bitcast_probe.cu", "benchmarks/exp_bitcast_probe.py:46", probe_launches),
               "fragment_probe": ("exp_bitcast_probe.cu", "benchmarks/exp_bitcast_probe.py:20", probe_launches),
               "zero_body": ("grid_overhead.cu", "benchmarks/grid_overhead_study.py:82", probe_launches),
               "kdot": ("grid_overhead.cu", "benchmarks/grid_overhead_study.py:108", probe_launches)}
    kernels = [
        {"name": k, "route": "cuda", "source": f"qgtc_ppopp22_tpu_torch/csrc/{src}",
         "replaces": rep_, "launches": counts[k], "max_abs_err": err[k], "ms": times[k][0],
         "plain_ms": times[k][1], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": lib_ms.get(k)}
        for k, (src, rep_, counts) in sources.items()
    ]
    studies = studies_phase(dev, ds, batcher, card)
    print("studies: " + json.dumps({
        "seconds": studies["seconds"], "rates": studies["rates"],
        "run_all_ms": {f"{r['engine']} {r['mode']} {r['bits']}": r["epoch_ms"] for r in studies["run_all"]},
        "roofline": {r["bits"]: {k: r[k] for k in ("floor_ms", "floor_ms_card", "measured_ms", "fits_l2")}
                     for r in studies["roofline"]},
        "ring_overlap_share": {r["what"]: r.get("overlap_share") for r in studies["ring_overlap"] if r["part"] == "a"},
        "ring_ms_per_step": {r["what"]: r["host_ms_per_step"] for r in studies["ring_overlap"] if r["part"] == "c"}}))
    print("mesh: " + json.dumps({"seconds": mesh["seconds"], "timing_seconds": mesh_times["seconds"],
                                  "host_ms": mesh_times["host_ms"], "k2_i32_us": mesh_times["k2_i32_us"]}))
    print("qat: " + json.dumps({k: qat[k] for k in ("seconds", "train_seconds", "epochs", "accuracy")}))
    print(f"chip_smoke: {time.perf_counter() - start:.0f} s")
    print(card)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
