#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tensorfft_tpu_torch/csrc`` (nvcc, at
first use, one process per source), then:

  1. prints nvcc's ``-Xptxas -v`` summary per kernel (registers, spills)
     and fails unless every line of ``csrc/ptxas_reference.txt`` (each
     kernel outside the tensor-core engine, as built before it: pack and
     interleave) is in it unchanged, and
     prints the untangle pair's lines again on their own;
  2. drives the six main paths, each with every launch counter reset
     just before and read just after, and fails unless each kernel of the
     path was launched:
       C2C: ``fft_split`` with the default bf16 plans over the flagship
            configurations (N=4096 x 256, N=4096 x 4096, N=16384 x 4096
            through kernel A; N=2^20 x 16 through kernels B and C);
       R2C: ``rfft_split`` then ``irfft_split`` with the default bf16 plans
            at real N=32768 x 4096 (fused route) and real N=2^20 x 16
            (four-step route), which launch the nine 1D kernels;
       N-D: config 3 at full width, ``fft_convolve_2d`` of a 4096 x 4096
            float32 image (K4 three times and the spectral product's
            kernel, ``spectral_product``) and ``fftn_split`` + ``ifftn_split`` over the last
            two axes of 4096 x 4096 bf16 planes (the K4 column and row
            kernels), and ``fftn_split`` of a 512^3 bf16 volume (K4 on the
            trailing axes, then kernel A along axis 0, its tiles landed
            straight from K4's output: ``fused_fft_cols``);
       tuned: the tuned-plan path (run after step 4's gates), the public
            entry points with ``tuning="auto"`` reading a tuner cache
            written to a temporary directory (``TENSORFFT_TUNER_CACHE``):
            ``fft_split`` + ``ifft_split`` at N=16384 x 4096 (kernel A,
            planar, folded at K = 128), N=4096 x 4096 (kernel A,
            planar_vpu) and N=2^23 x 2 (kernels B and C, planar, the JAX
            package's tuned structure for that length), ``fftn_split`` +
            ``ifftn_split`` at 4096 x 4096 (both K4 passes, planar_vpu),
            and ``fused_layout="batch_major"`` at N=512 x 262,144 (K3,
            stacked, bf16ax2 first stage) and N=4096 x 256 (K3,
            planar_vpu); each call must launch the kernel and engine it
            names and no other, each kernel is held against its plain
            version under the same engine (on a row slice at the two
            largest shapes) and K3 against kernel A bit for bit, and each
            tuned plan passes the gate and the round trip;
       tpu_tuned: the JAX package's TPU-tuned plans (TPU_ENTRIES, copied
            from its tuner cache) and the pretwiddle and gridslice engines
            through ``fft_split``/``ifft_split``, ``fftn_split``/
            ``ifftn_split`` and ``rfft_split``/``irfft_split`` (TPU_CALLS):
            kernel A grouped (p = 1 at N=16384 x 4096, with and without
            mult3; p = 4 at N=512), at N=4096 under ``tuning="auto"`` with
            both K4 passes and K3 grouped, kernels B and C grouped with a
            bf16 state (2^20 x 16), under mult3 with a bf16 state (32768 x
            512) and C's radix-128 mult3 stage (2^24), pretwiddle and the
            gridslice engines (K1a, K2cg, K2rg, K6g), K5 and K6 grouped with
            a bf16 state and under planar, and the float32 policy with
            grouped mult3 and with a bf16 state; each call must launch
            exactly the variants listed, each variant is held against its
            plain version (two bf16 ulps on at most 2 % under a bf16 state),
            pretwiddle and gridslice must equal the stacked engine bit for
            bit, and each plan passes the gate and the round trip;
       bign: the plans the JAX package runs past one CTA (BIGN_CALLS),
            each on a thread-block cluster, through ``fft_split``/
            ``ifft_split`` (and K3, ``rfft_split``/``irfft_split``): kernel
            A on 2 CTAs at N=32768 x 2048 (bf16, and float32 with a bf16
            state), on 4 at N=65536 x 1024 (bf16 state) and 65536 x 64
            (float32, mult3), and on 2 for bf16x6 with mult3 at N=16384 x
            256; kernel C on 2 CTAs, then kernel B on the column-cluster
            rule's tile (4 adjacent columns on 8 CTAs), for the 32768-point
            pass of N=2^27 x 1 at splits (4096, 32768) and (32768, 4096);
            K5 and K6's column pass on that tile at real N=2^21 x 4, split
            (32768, 32); K3 at N=32768 x 2048; the fused R2C route at real
            N=65536 x 1024; each call must launch exactly the cluster
            variants listed, each variant is held against its plain version
            (at 2^27 on the first 2^22 outputs), each plan passes the gate
            and the round trip; at N=16384, forced onto a cluster through
            the private launchers, kernel A on 2 and 4 CTAs, K3 and kernel C
            on 2, and kernel B, K4's column pass and K5 on every (lanes,
            cluster) that holds them must equal their one-CTA kernels bit
            for bit (and kernel A its plain-torch version at the fused
            bound); a plan past 8 CTAs must be refused;
  3. holds each kernel's output against its plain-torch version on the same
     card and inputs, first on the inputs the main paths gave it (K4 on
     the 4096 x 4096 planes in bf16 and float32 and on the 512^3 volume,
     kernel A on the volume's axis-0 rows), then the R2C kernels again
     under the float32 policy at a cut size
     (``testing.metrics.agreement``: one bf16 ulp of the
     output scale, on at most 0.1% of elements for kernel A and 1% for the
     four-step passes; fp32 within 1e-5 relative; pack, interleave and the
     untangle pair bit-identical, the pair also on the short rows of
     ``rfftn_split``'s last axis at a real 4096 x 4096);
  4. drives two more counted paths:
       conformance: the ported harness (``testing.conformance.
            run_unit_sweep`` with ``device="cuda"``) over REFERENCE_SWEEP,
            N = 256 ... 2^20 at 10 seeds, then its tail 2^21 ... 2^28 at 10
            seeds, under bf16 and float32: the reference gate (avg <= 1e-3,
            sigma <= 1e-2, max <= 0.5) at every (N, seed), with the signal,
            the complex128 oracle and the deviation made on the card (held
            once against their numpy versions at 2^20), one line per length
            and policy with its worst avg, sigma and max; each run launches
            kernel A (N <= 16384) or kernels B and C once, and nothing else;
            every run's max within CONFORMANCE_MAX_BF16_ULPS bf16 ulps (or
            CONFORMANCE_MAX_F32_REL) of the spectrum's scale, a bound an
            all-zero output fails where the gate does not; then one seed per
            length and policy again, each kernel held against its plain
            version on that input (its output's deviation equal to the
            sweep's; the differing fraction over the spectrum's elements
            at or above SPARSE_SIGNAL of its scale), and the C2C round trip
            at C2C_ROUNDTRIP's lengths;
       any: ``fft_split_any`` then ``ifft_split_any`` (Bluestein) at
            N=1000 x 4096 (M=2048, kernel A), 10,000 x 256 (M=32768, B and
            C), 1,000,000 x 4 (M=2^21, B and C) in float32 and 1000 x 4096
            in bf16, each call launching exactly two of each of its
            kernels; against ``np.fft.fft(x)/N`` (2e-4 of the largest |X|
            in float32, the reference gate in bf16), the round trip, the
            M-point kernels against their plain versions on the padded
            rows (forward on the chirped input, inverse on its product
            with the kernel spectrum), and
            each timed against ``torch.fft.fft``; at 4096 x 4096 it
            delegates to ``fft_split`` (kernel A once, the same bits);
     then runs the reference accuracy gate against the numpy fp64 oracle
     for the R2C path against ``np.fft.rfft(x)/N`` at real N = 512 ... 2^21
     (bf16) and N = 8192, 32768, 2^21 (float32), for the 2D path against
     ``np.fft.fft2(x)/(H*W)`` at 4096 x 4096, 8 x 16384 and 16384 x 8 (both
     policies), for the 3-D path against ``np.fft.fftn(x)/x.size`` at
     256^3 (bf16) and for ``rfftn_split`` at a real 4096 x 4096; checks that
     each inverse returns its input, and ``fft_convolve_real`` and
     ``fft_convolve_2d`` against fp64 circular convolutions;
  5. times each kernel, its plain version and, where one exists, the one
     PyTorch call that computes the same function, with CUDA events, beside
     the least time the card could take (compulsory bytes at the HBM rate or
     operations at the peak rate of their type, whichever is larger), and
     the N-D entry points against their ``torch.fft`` counterparts; a
     four-step pass's one call is the whole transform's ``torch.fft.fft``
     (``rfft``/``irfft`` on the R2C route) at its shape; kernel B's twin
     at 2^27 on each (lanes, cluster) candidate of the column-cluster rule,
     in turns, and the whole 2^27 transform at that split; the untangle pair
     also on those short rows (M = 2048 x B = 4096).

Every kernel's one-CTA calls run on the tensor-core engine
(``csrc/fft_mma.cuh``): kernel A, K3 and K4's row pass, and since the
four-step passes moved there kernels B and C, K4's column pass, K5 and K6
(``csrc/four_step_tc.cuh``).  Their launch counters name it (``mma``:
``fused_fft[mma]``, ``four_step_col[mma]``, ``fft2_col[grouped,mma]``,
``four_step_row_interleave[planar,mma]``, ...), and each call of a path
must launch exactly those variants.  Kernel A's bf16 calls on the knob-free
stacked engine with a power of two N from 128 to 16384 and more rows than
SMs run its pipelined persistent kernel (``csrc/fused_fft_pipe.cu``), the
same bits, on tiles of T consecutive rows a step: T = 1 at N = 16384
(``fused_fft[pipelined,mma]``), T > 1 below
(``fused_fft[pipelined,tile<T>,mma]``, ``fused_cuda.pipeline_tile``: the c2c
path's 4096 x 4096 and 4096 x 256, the any path's 2048-point rows); an N-D
pass whose planes allow it lands the tiles straight from the strided planes
(``fused_fft_cols[pipelined,tile<T>,cols,mma]``, ``fused_cuda.column_tile``:
the 512^3 grid's axis 0); the Poisson path solves the 512^3 volume and
must launch K7, kernel A on the 256-point half-length rows (its radix-256
stage's A fragments gathered from the stage's roots in shared memory,
``fused_fft[pipelined,tile32,roots,mma]``), K9, the landed
and the relayout's axis passes, the spectral scale, K10 and K8; step 5 times kernel A at N=16384 x 4096 on both
paths, in turns, and the pipelined kernel's tiles at TILE_SHAPES against one
CTA a row, a row a step and (at the grid's rows) K3, the relayout with the
rule's tiles and the strided landing at T = 16 and 32, then the scale and
kernel A on the solve's half spectrum and half-length rows (and, for the
record, radices (16, 16) there), and the spectral product on the
convolution's 4096 x 4096 float32 spectra beside its plain version (the
six torch launches it replaces) and its bound.  Past one CTA, the cluster twins (``fused_fft[cluster2]``, K3,
kernel C, K4's row pass, K6; kernel B, K4's column pass and K5 with 4
adjacent columns per cluster, ``four_step_col[cluster8]``) run the same
engine on a thread-block cluster,
each CTA owning a block of every stage's columns
(``csrc/fft_mma_cluster.cuh``), so each equals its one-CTA kernel bit for
bit.

The second-to-last lines are a JSON object of per-kernel results and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero, and nothing is printed as a result
when no CUDA device is present.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
# (label, N, batch): the C2C main path's flagship configurations.
FLAGSHIP = [
    ("entry", 4096, 256),
    ("bench-secondary", 4096, 4096),
    ("bench-headline", 16384, 4096),
    ("four-step", 1 << 20, 16),
]
# (label, real N, batch): the R2C main path's configurations.  M = N/2 =
# 16384 is kernel A's headline length; N = 2^20 x 16 is the JAX package's
# config 4 (BASELINE.md:30), on the four-step route.
R2C_FLAGSHIP = [
    ("r2c-fused", 32768, 4096),
    ("r2c-config4", 1 << 20, 16),
]
# The untangle pair on short rows: the last axis of rfftn_split at a real
# 4096 x 4096 (M = 2048, B = 4096), timed and held beside the main path's.
R2C_SHORT = ("r2c-short-rows", 4096, 4096)
R2C_SHAPE = {label: f"real N={n} x B={b} bf16"
             for label, n, b in R2C_FLAGSHIP + [R2C_SHORT]}
# The float32 variants of the R2C kernels against their plain versions: the
# main path's lengths, with the batch cut.
R2C_FP32 = [("r2c-fused", 32768, 256), ("r2c-config4", 1 << 20, 2)]
# The N-D path: the JAX package's config 3 (BASELINE.md:29, a 4096 x 4096
# 2D FFT and fft_convolve_2d) and config 5's 512^3 grid on one card.
ND_IMAGE = (4096, 4096)
ND_VOLUME = (512, 512, 512)
ND_GATE_2D = [(4096, 4096), (8, 16384), (16384, 8)]
ND_GATE_3D = (256, 256, 256)
# Kernel A's pipelined kernel on tiles of 16384 and of 8192 elements and the
# rule's tile, timed in turns with one CTA a row, a row a step (and, at the
# 512^3 grid's axis-0 rows, K3, the relayout's copy with the rule's tiles and
# the tiles landed straight from the grid), every output equal to one CTA a
# row's: (N, rows).
TILE_SHAPES = [(512, 262144), (512, 4096), (1024, 4096), (2048, 4096),
               (4096, 4096), (8192, 4096), (256, 4096), (128, 4096),
               (4096, 256)]
# The conformance path: testing.conformance.REFERENCE_SWEEP (N = 256 ... 2^20,
# 10 seeds), then its tail up to this length, under both policies; each
# (N, seed) launches kernel A (N <= 16384) or kernels B and C once.
CONFORMANCE_TAIL = 1 << 28
CONFORMANCE_KERNELS = ("fused_fft[mma]", "four_step_col[mma]", "four_step_row[mma]")
# The card's datagen and oracle against numpy's at 2^20, relative to scale.
CARD_HOLD_REL = 1e-12
# Past N ~ 2^16 the reference gate alone passes an all-zero output (its 76
# nonzero bins of at most 0.5 in 2N move avg and sigma below their limits),
# so every run's largest deviation is also held to the spectrum's scale S,
# max |w_h| / 2 over the 2 x 19 harmonics: under bf16 within this many bf16
# ulps of S, under float32 within this fraction of S.  An all-zero output
# sits at S itself (128 bf16 ulps of it or more).
CONFORMANCE_MAX_BF16_ULPS = 4.0
CONFORMANCE_MAX_F32_REL = 2e-4
# The conformance path holds each kernel against its plain version on one
# seed's sine superposition, a sparse spectrum: 2N - 76 of its bins are
# rounding noise far below the scale, whose last bits follow the summation
# order, so far more of them differ than the fraction bounds allow (each
# hold's log line gives the fraction over all elements too).  The differing
# fraction is counted over the elements at or above this share of the
# scale; every element stays within the ulp bound.
SPARSE_SIGNAL = 2.0 ** -8
# The C2C round trip, fft_split then ifft_split on one seed, at the lengths
# of the earlier C2C gate.
C2C_ROUNDTRIP = {"bfloat16": [256, 1024, 4096, 16384, 1 << 17, 1 << 20],
                 "float32": [4096, 16384, 1 << 20]}
# The any path: (label, N, batch, policy, the M-point transform's kernels,
# each launched exactly twice per fft_split_any / ifft_split_any call).
ANY_CALLS = [
    ("N=1000 x 4096 float32", 1000, 4096, "float32", ("fused_fft[mma]",)),
    ("N=10000 x 256 float32", 10_000, 256, "float32",
     ("four_step_col[mma]", "four_step_row[mma]")),
    ("N=1000000 x 4 float32", 1_000_000, 4, "float32",
     ("four_step_col[mma]", "four_step_row[mma]")),
    ("N=1000 x 4096 bfloat16", 1000, 4096, "bfloat16",
     ("fused_fft[pipelined,tile8,mma]",)),
]
ANY_POW2 = (4096, 4096)
# fft_split_any against np.fft.fft / N: the JAX package's float32 bound
# (tests/test_bluestein.py) relative to the largest |X|; bf16 takes the
# reference gate.  Round trips relative to max |x|.
ANY_F32_REL = 2e-4
R2C_GATE_BF16 = [512, 8192, 32768, 1 << 18, 1 << 21]
R2C_GATE_F32 = [8192, 32768, 1 << 21]
# Round trip: max |inverse(forward(x)) - x| relative to max |x|.  bf16
# storage keeps 8 significant bits, so the passes' storage rounding leaves
# ~2^-7; bf16x3 keeps 16 bits per operand, ~1.5e-5 per stage over up to 6
# stages; bf16x6 keeps 24 bits, inside bf16x3's bound.
ROUNDTRIP_TOL = {"bfloat16": 2e-2, "float32": 3e-4, "float32_x6": 3e-4}
ANY_ROUNDTRIP_TOL = {"bfloat16": ROUNDTRIP_TOL["bfloat16"], "float32": 1e-3}
# fft_convolve_real (float32 policy) against the fp64 convolution, relative
# to the output's largest magnitude: three bf16x3 transforms at ~1e-5 each.
CONVOLVE_TOL = 1e-3
# bf16 partial products per stage matmul under each dot algorithm.
PRODUCTS = {"bf16": 1, "bf16ax2": 2, "bf16x3": 3, "bf16x6": 6}
# fp32 operations per output bin of the untangle pair (adds, products and
# the final scale of _untangle_kernel / _retangle_kernel).
UNTANGLE_OPS = 14
# A buffer larger than the 50 MB L2, overwritten before each timed epilogue
# call, so every call reads its inputs from device memory.
FLUSH_BYTES = 256 << 20

# Every kernel of the two paths: its source and the TPU kernel it replaces
# (the pallas_call of the JAX package).
KERNELS = {
    "fused_fft[mma]": ("tensorfft_tpu_torch/csrc/fused_fft.cu",
                  "tensorfft_tpu/ops/fused_pallas.py:971"),
    "fused_fft[pipelined,mma]": ("tensorfft_tpu_torch/csrc/fused_fft_pipe.cu",
                             "tensorfft_tpu/ops/fused_pallas.py:971"),
    "fused_fft[pipelined,tile4,mma]": ("tensorfft_tpu_torch/csrc/fused_fft_pipe.cu",
                                   "tensorfft_tpu/ops/fused_pallas.py:971"),
    "fused_fft[pipelined,tile16,mma]": ("tensorfft_tpu_torch/csrc/fused_fft_pipe.cu",
                                    "tensorfft_tpu/ops/fused_pallas.py:971"),
    "fused_fft_cols[pipelined,tile16,cols,mma]": (
        "tensorfft_tpu_torch/csrc/fused_fft_pipe.cu",
        "tensorfft_tpu/ops/fused_pallas.py:971"),
    "four_step_col[mma]": ("tensorfft_tpu_torch/csrc/four_step_fft.cu",
                      "tensorfft_tpu/ops/four_step_pallas.py:465"),
    "four_step_row[mma]": ("tensorfft_tpu_torch/csrc/four_step_row.cu",
                      "tensorfft_tpu/ops/four_step_pallas.py:551"),
    "pack_split": ("tensorfft_tpu_torch/csrc/rfft_epilogue.cu",
                   "tensorfft_tpu/ops/rfft_pallas.py:236"),
    "interleave_split": ("tensorfft_tpu_torch/csrc/rfft_epilogue.cu",
                         "tensorfft_tpu/ops/rfft_pallas.py:288"),
    "untangle_fwd": ("tensorfft_tpu_torch/csrc/rfft_epilogue.cu",
                     "tensorfft_tpu/ops/rfft_pallas.py:421"),
    "retangle_inv": ("tensorfft_tpu_torch/csrc/rfft_epilogue.cu",
                     "tensorfft_tpu/ops/rfft_pallas.py:513"),
    "four_step_col_packed[mma]": ("tensorfft_tpu_torch/csrc/four_step_real.cu",
                             "tensorfft_tpu/ops/four_step_pallas.py:943"),
    "four_step_row_interleave[mma]": ("tensorfft_tpu_torch/csrc/four_step_real_row.cu",
                                 "tensorfft_tpu/ops/four_step_pallas.py:1229"),
    "fft2_col[mma]": ("tensorfft_tpu_torch/csrc/fft2.cu",
                 "tensorfft_tpu/ops/four_step_pallas.py:646"),
    "fft2_row[mma]": ("tensorfft_tpu_torch/csrc/fft2_row.cu",
                 "tensorfft_tpu/ops/four_step_pallas.py:677"),
    # The tuned-plan path: the planar engines (K1b, stage_loop_planar) in
    # kernels A, B, C and K4, and K3.
    "fused_fft[planar,mma]": ("tensorfft_tpu_torch/csrc/fused_fft.cu",
                          "tensorfft_tpu/ops/fused_pallas.py:971"),
    "fused_fft[planar_vpu,mma]": ("tensorfft_tpu_torch/csrc/fused_fft.cu",
                              "tensorfft_tpu/ops/fused_pallas.py:971"),
    "four_step_col[planar,mma]": ("tensorfft_tpu_torch/csrc/four_step_fft.cu",
                              "tensorfft_tpu/ops/four_step_pallas.py:465"),
    "four_step_row[planar,mma]": ("tensorfft_tpu_torch/csrc/four_step_row.cu",
                              "tensorfft_tpu/ops/four_step_pallas.py:551"),
    "fft2_col[planar_vpu,mma]": ("tensorfft_tpu_torch/csrc/fft2.cu",
                             "tensorfft_tpu/ops/four_step_pallas.py:646"),
    "fft2_row[planar_vpu,mma]": ("tensorfft_tpu_torch/csrc/fft2_row.cu",
                             "tensorfft_tpu/ops/four_step_pallas.py:677"),
    "fused_fft_batch_major[mma]": ("tensorfft_tpu_torch/csrc/fused_batch_major.cu",
                              "tensorfft_tpu/ops/four_step_pallas.py:768"),
    "fused_fft_batch_major[planar_vpu,mma]": (
        "tensorfft_tpu_torch/csrc/fused_batch_major.cu",
        "tensorfft_tpu/ops/four_step_pallas.py:768"),
    # The Poisson solve's spectral scale: no pallas_call (the JAX package
    # multiplies by full 3-D tables of 1/lambda in XLA).
    "poisson_scale": ("tensorfft_tpu_torch/csrc/spectral.cu",
                      "tensorfft_tpu/models/poisson.py:62 (XLA, no kernel)"),
    # The convolutions' spectral product: no pallas_call (the JAX package's
    # _cmul runs as XLA operations).
    "spectral_product": ("tensorfft_tpu_torch/csrc/spectral.cu",
                         "tensorfft_tpu/models/fft_conv.py:19 _cmul (XLA, no kernel)"),
}
# The tpu_tuned path's variants: the stacked engine under the numeric knobs
# (grouped, mult3, bf16 state), the pretwiddle and gridslice engines, and
# the planar engines under K5 and K6.  A variant is named by its kernel and
# the engine and knobs in effect (fused_cuda.variant).
_FUSED = ("tensorfft_tpu_torch/csrc/fused_fft.cu", "tensorfft_tpu/ops/fused_pallas.py:971")
_PIPE = ("tensorfft_tpu_torch/csrc/fused_fft_pipe.cu", _FUSED[1])
_COL = ("tensorfft_tpu_torch/csrc/four_step_fft.cu", "tensorfft_tpu/ops/four_step_pallas.py:465")
_ROW = ("tensorfft_tpu_torch/csrc/four_step_row.cu", "tensorfft_tpu/ops/four_step_pallas.py:551")
_PACKED = ("tensorfft_tpu_torch/csrc/four_step_real.cu", "tensorfft_tpu/ops/four_step_pallas.py:943")
_INTERLEAVE = ("tensorfft_tpu_torch/csrc/four_step_real_row.cu",
               "tensorfft_tpu/ops/four_step_pallas.py:1229")
TPU_KERNELS = {
    "fused_fft[grouped,mma]": _FUSED,
    "fused_fft[grouped,mult3,mma]": _FUSED,
    "fused_fft[bf16_state,mma]": _FUSED,
    "fused_fft[pretwiddle,pipelined,mma]": _PIPE,
    "fused_fft[gridslice,pipelined,mma]": (_PIPE[0], "tensorfft_tpu/ops/fused_pallas.py:923"),
    "four_step_col[grouped,bf16_state,mma]": _COL,
    "four_step_row[grouped,bf16_state,mma]": _ROW,
    "four_step_col[mult3,bf16_state,mma]": _COL,
    "four_step_row[mult3,bf16_state,mma]": _ROW,
    "four_step_row[mult3,mma]": _ROW,
    "four_step_col[pretwiddle,mma]": _COL,
    "four_step_row[pretwiddle,mma]": _ROW,
    "four_step_col[gridslice16,mma]": (_COL[0], "tensorfft_tpu/ops/four_step_pallas.py:422"),
    "four_step_row[gridslice16,mma]": (_ROW[0], "tensorfft_tpu/ops/four_step_pallas.py:516"),
    "four_step_col[gridslice,mma]": (_COL[0], "tensorfft_tpu/ops/four_step_pallas.py:1147"),
    "fft2_col[grouped,mma]": ("tensorfft_tpu_torch/csrc/fft2.cu",
                          "tensorfft_tpu/ops/four_step_pallas.py:646"),
    "fft2_row[grouped,mma]": ("tensorfft_tpu_torch/csrc/fft2_row.cu",
                          "tensorfft_tpu/ops/four_step_pallas.py:677"),
    "fused_fft_batch_major[grouped,mma]": ("tensorfft_tpu_torch/csrc/fused_batch_major.cu",
                                       "tensorfft_tpu/ops/four_step_pallas.py:768"),
    "four_step_col_packed[grouped,bf16_state,mma]": _PACKED,
    "four_step_row_interleave[grouped,bf16_state,mma]": _INTERLEAVE,
    "four_step_col_packed[planar,mma]": _PACKED,
    "four_step_row_interleave[planar,mma]": _INTERLEAVE,
}
KERNELS.update(TPU_KERNELS)
# The tuner cache of the tuned-plan path, bf16, platform "cuda".  The
# n=2^23 entry is the JAX package's TPU-tuned structure for that length
# (tensorfft_tpu/tuning/tuner_cache.json) and the n=4096 entry its TPU
# structure with the planar_vpu engine; n=16384 takes the default radices
# under planar.  They are test structures, not CUDA tuning results.
TUNED_ENTRIES = {
    16384: {"strategy": "fused", "radices": [128, 128], "engine": "planar"},
    4096: {"strategy": "fused", "radices": [32, 128], "grouped": True,
           "kloop_width": 256, "lane_tile": 128, "engine": "planar_vpu"},
    1 << 23: {"strategy": "four_step", "four_step_split": [2048, 4096],
              "col_radices": [64, 32], "row_radices": [64, 64],
              "engine": "planar", "grouped": True, "lane_tile": 128},
}
# (label, N, batch, fused_layout, launches each fft_split + ifft_split pair
# must make, and nothing else).  512 x 262,144 is the 512^3 volume's
# axis-0 row count; 4096 x 256 the __graft_entry__ shape.
TUNED_CALLS = [
    ("planar N=16384", 16384, 4096, "auto", {"fused_fft[planar,mma]": 2}),
    ("planar_vpu N=4096", 4096, 4096, "auto", {"fused_fft[planar_vpu,mma]": 2}),
    ("planar N=2^23", 1 << 23, 2, "auto",
     {"four_step_col[planar,mma]": 2, "four_step_row[planar,mma]": 2}),
    ("batch_major N=512", 512, 262144, "batch_major",
     {"fused_fft_batch_major[mma]": 2}),
    ("batch_major N=4096", 4096, 256, "batch_major",
     {"fused_fft_batch_major[planar_vpu,mma]": 2}),
]
# Rows of the main path's output held against the plain versions at the
# two largest tuned shapes.
TUNED_HOLD_ROWS = {"planar N=16384": 256, "batch_major N=512": 8192}

# The tpu_tuned path: entries of the JAX package's TPU tuner cache
# (tensorfft_tpu/tuning/tuner_cache.json), copied literally under the key
# named in each comment.  They are TPU structures used as test plans, not
# CUDA tuning results; 19 of the 30 set grouped, bf16 state or mult3.
TPU_ENTRIES = {
    # n=16384,precision=bfloat16,platform=tpu (the bench headline)
    16384: {"batch": 4096, "gflops": 3896.7, "grouped": True, "lane_tile": 128,
            "radices": [64, 256], "strategy": "fused", "time_us": 1205.54},
    # n=4096,precision=bfloat16,platform=tpu
    4096: {"batch": 4096, "gflops": 3775.3, "grouped": True, "kloop_width": 256,
           "lane_tile": 128, "radices": [32, 128], "strategy": "fused",
           "time_us": 266.63},
    # n=512,precision=bfloat16,platform=tpu
    512: {"gflops": 7469.8, "grouped": True, "lane_tile": 128, "radices": [32, 16],
          "strategy": "fused", "time_us": 25.27},
    # n=1048576,precision=bfloat16,platform=tpu
    1 << 20: {"batch": 16, "col_radices": [32, 16], "four_step_split": [512, 2048],
              "gflops": 2325.6, "grouped": True, "k1_tile": 512, "lane_tile": 256,
              "row_radices": [64, 32], "state_dtype": "bfloat16",
              "strategy": "four_step", "time_us": 721.41},
    # n=32768,precision=bfloat16,platform=tpu
    32768: {"batch": 512, "complex_mult": "mult3", "four_step_split": [128, 256],
            "gflops": 2230.1, "lane_tile": 128, "state_dtype": "bfloat16",
            "strategy": "four_step", "time_us": 564.24},
    # n=16777216,precision=bfloat16,platform=tpu
    1 << 24: {"batch": 1, "col_radices": [64, 32], "complex_mult": "mult3",
              "four_step_split": [2048, 8192], "gflops": 1600.1, "lane_tile": 128,
              "row_radices": [128, 64], "strategy": "four_step", "time_us": 1258.21},
    # n=8388608,precision=bfloat16,platform=tpu
    1 << 23: {"batch": 2, "col_radices": [64, 32], "engine": "planar",
              "four_step_split": [2048, 4096], "gflops": 2037.9, "grouped": True,
              "lane_tile": 128, "row_radices": [64, 64], "strategy": "four_step",
              "time_us": 946.73},
}
_R2C = ("untangle_fwd", "retangle_inv")
# (label, route, N, batch, precision, tuning, the launches of the forward and
# inverse call, and nothing else).  route: "c2c" (fft_split + ifft_split),
# "batch_major" (the same with fused_layout="batch_major"), "fftn"
# (fftn_split + ifftn_split over an N x N image) or "r2c" (rfft_split +
# irfft_split of real N, the plan for N/2).  tuning "auto" reads a cuda
# tuner cache holding TPU_ENTRIES[4096].
TPU_CALLS = [
    ("K1 grouped N=16384", "c2c", 16384, 4096, "bfloat16", TPU_ENTRIES[16384],
     {"fused_fft[grouped,mma]": 2}),
    ("K1 grouped mult3 N=16384", "c2c", 16384, 4096, "bfloat16",
     dict(TPU_ENTRIES[16384], complex_mult="mult3"), {"fused_fft[grouped,mult3,mma]": 2}),
    ("K1 grouped N=4096 auto", "c2c", 4096, 4096, "bfloat16", "auto",
     {"fused_fft[grouped,mma]": 2}),
    ("K4 grouped 4096x4096 auto", "fftn", 4096, 1, "bfloat16", "auto",
     {"fft2_col[grouped,mma]": 2, "fft2_row[grouped,mma]": 2}),
    ("K3 grouped N=4096 auto", "batch_major", 4096, 256, "bfloat16", "auto",
     {"fused_fft_batch_major[grouped,mma]": 2}),
    ("K1 grouped p=4 N=512", "c2c", 512, 4096, "bfloat16", TPU_ENTRIES[512],
     {"fused_fft[grouped,mma]": 2}),
    ("K2 grouped bf16 state N=2^20", "c2c", 1 << 20, 16, "bfloat16",
     TPU_ENTRIES[1 << 20], {"four_step_col[grouped,bf16_state,mma]": 2,
                            "four_step_row[grouped,bf16_state,mma]": 2}),
    ("K2 mult3 bf16 state N=32768", "c2c", 32768, 512, "bfloat16",
     TPU_ENTRIES[32768], {"four_step_col[mult3,bf16_state,mma]": 2,
                          "four_step_row[mult3,bf16_state,mma]": 2}),
    ("K2 mult3 N=2^24", "c2c", 1 << 24, 1, "bfloat16", TPU_ENTRIES[1 << 24],
     {"four_step_col[mma]": 2, "four_step_row[mult3,mma]": 2}),
    ("pretwiddle N=16384", "c2c", 16384, 4096, "bfloat16",
     dict(TPU_ENTRIES[16384], engine="pretwiddle"),
     {"fused_fft[pretwiddle,pipelined,mma]": 2}),
    ("pretwiddle N=2^20", "c2c", 1 << 20, 16, "bfloat16",
     dict(TPU_ENTRIES[1 << 20], engine="pretwiddle", state_dtype="float32"),
     {"four_step_col[pretwiddle,mma]": 2, "four_step_row[pretwiddle,mma]": 2}),
    ("K1a gridslice N=16384", "c2c", 16384, 4096, "bfloat16",
     {"strategy": "fused", "radices": [128, 128], "engine": "gridslice"},
     {"fused_fft[gridslice,pipelined,mma]": 2}),
    ("K2cg K2rg gridslice16 N=2^20", "c2c", 1 << 20, 16, "bfloat16",
     {"strategy": "four_step", "four_step_split": [1024, 1024], "engine": "gridslice16"},
     {"four_step_col[gridslice16,mma]": 2, "four_step_row[gridslice16,mma]": 2}),
    ("K5 K6 grouped bf16 state real N=2^21", "r2c", 1 << 21, 16, "bfloat16",
     TPU_ENTRIES[1 << 20],
     {"four_step_col_packed[grouped,bf16_state,mma]": 1,
      "four_step_row[grouped,bf16_state,mma]": 1, "four_step_col[grouped,bf16_state,mma]": 1,
      "four_step_row_interleave[grouped,bf16_state,mma]": 1, **dict.fromkeys(_R2C, 1)}),
    ("K6g gridslice real N=2^21", "r2c", 1 << 21, 16, "bfloat16",
     {"strategy": "four_step", "four_step_split": [1024, 1024], "engine": "gridslice"},
     {"four_step_col_packed[mma]": 1, "four_step_row[mma]": 1, "four_step_col[gridslice,mma]": 1,
      "four_step_row_interleave[mma]": 1, **dict.fromkeys(_R2C, 1)}),
    ("K5 K6 planar real N=2^24", "r2c", 1 << 24, 2, "bfloat16", TPU_ENTRIES[1 << 23],
     {"four_step_col_packed[planar,mma]": 1, "four_step_row[planar,mma]": 1,
      "four_step_col[planar,mma]": 1, "four_step_row_interleave[planar,mma]": 1,
      **dict.fromkeys(_R2C, 1)}),
    ("K1 grouped mult3 float32 N=16384", "c2c", 16384, 256, "float32",
     {"strategy": "fused", "radices": [64, 256], "grouped": True,
      "complex_mult": "mult3"}, {"fused_fft[grouped,mult3,mma]": 2}),
    ("K1 bf16 state float32 N=4096", "c2c", 4096, 256, "float32",
     {"state_dtype": "bfloat16"}, {"fused_fft[bf16_state,mma]": 2}),
]
# Kernel B's cluster twin on the column-cluster rule's tile
# (fused_cuda.column_cluster: 4 adjacent columns on 8 CTAs for a 32768-point
# pass), as kernel B and as K5, and the rule's candidates at 2^27, (lanes,
# cluster), timed in turns.
K2C_TWIN = "four_step_col[cluster8]"
K5_TWIN = "four_step_col_packed[cluster8]"
K2C_CANDIDATES = ((1, 2), (2, 4), (4, 8))
# The bign path: the plans the JAX package runs past one CTA, each on a
# thread-block cluster (fused_cuda.fit_cta), in TPU_CALLS' format.  The
# single-pass plans at N = 32768 and 65536 are the JAX tuner's fused_bign
# challengers (tensorfft_tpu/tuning/tuner.py:279-303; 32768 in float32 with
# a bf16 state is tests/test_fused_pallas.py:134's plan, 65536 (128, 4, 128)
# under mult3 its :337 structure); the four-step splits put a 32768-point
# pass in kernel C, then in kernel B (tests/test_plan.py:101); bf16x6 with
# mult3 is the bench headline's structure; K3 and the fused R2C route take
# the cluster too.
_FUSED_32K = {"strategy": "fused", "radices": [256, 128], "max_fused_length": 32768}
BIGN_CALLS = [
    ("K1 cluster N=32768", "c2c", 32768, 2048, "bfloat16", _FUSED_32K,
     {"fused_fft[cluster2]": 2}),
    ("K1 cluster bf16 state float32 N=32768", "c2c", 32768, 2048, "float32",
     {"strategy": "fused", "radices": [32, 32, 32], "max_fused_length": 32768,
      "state_dtype": "bfloat16"}, {"fused_fft[bf16_state,cluster2]": 2}),
    ("K1 cluster bf16 state N=65536", "c2c", 65536, 1024, "bfloat16",
     {"strategy": "fused", "radices": [256, 256], "max_fused_length": 65536,
      "state_dtype": "bfloat16"}, {"fused_fft[bf16_state,cluster4]": 2}),
    ("K1 cluster mult3 float32 N=65536", "c2c", 65536, 64, "float32",
     {"strategy": "fused", "radices": [128, 4, 128], "max_fused_length": 65536,
      "complex_mult": "mult3"}, {"fused_fft[mult3,cluster4]": 2}),
    ("K2r cluster N=2^27 (4096, 32768)", "c2c", 1 << 27, 1, "bfloat16",
     {"strategy": "four_step", "four_step_split": [4096, 32768]},
     {"four_step_col[mma]": 2, "four_step_row[cluster2]": 2}),
    ("K2c cluster N=2^27 (32768, 4096)", "c2c", 1 << 27, 1, "bfloat16",
     {"strategy": "four_step", "four_step_split": [32768, 4096]},
     {K2C_TWIN: 2, "four_step_row[mma]": 2}),
    ("K5 K6 cluster real N=2^21 (32768, 32)", "r2c", 1 << 21, 4, "bfloat16",
     {"strategy": "four_step", "four_step_split": [32768, 32]},
     {K5_TWIN: 1, "four_step_row[mma]": 1, K2C_TWIN: 1,
      "four_step_row_interleave[mma]": 1, **dict.fromkeys(_R2C, 1)}),
    ("K1 bf16x6 mult3 N=16384", "c2c", 16384, 256, "float32_x6",
     dict(TPU_ENTRIES[16384], complex_mult="mult3"),
     {"fused_fft[grouped,mult3,cluster2]": 2}),
    ("K3 cluster N=32768", "batch_major", 32768, 2048, "bfloat16", _FUSED_32K,
     {"fused_fft_batch_major[cluster2]": 2}),
    ("R2C cluster real N=65536", "r2c", 65536, 1024, "bfloat16",
     {"max_fused_length": 32768},
     {"pack_split": 1, "fused_fft[cluster2]": 2, "untangle_fwd": 1,
      "retangle_inv": 1, "interleave_split": 1}),
]
# The twins of kernel A and of the row passes are compiled from
# csrc/cluster_tc.cuh; kernel B's (K5's too) from csrc/cluster_col_tc.cuh.
_CLUSTER_TC = "tensorfft_tpu_torch/csrc/cluster_tc.cuh"
_CLUSTER_COL_TC = "tensorfft_tpu_torch/csrc/cluster_col_tc.cuh"
BIGN_KERNELS = {
    "fused_fft[cluster2]": (_CLUSTER_TC, _FUSED[1]),
    "fused_fft[bf16_state,cluster2]": (_CLUSTER_TC, _FUSED[1]),
    "fused_fft[bf16_state,cluster4]": (_CLUSTER_TC, _FUSED[1]),
    "fused_fft[mult3,cluster4]": (_CLUSTER_TC, _FUSED[1]),
    "fused_fft[grouped,mult3,cluster2]": (_CLUSTER_TC, _FUSED[1]),
    "four_step_row[cluster2]": (_CLUSTER_TC, _ROW[1]),
    K2C_TWIN: (_CLUSTER_COL_TC, _COL[1]),
    K5_TWIN: (_CLUSTER_COL_TC, "tensorfft_tpu/ops/four_step_pallas.py:943"),
    "fused_fft_batch_major[cluster2]": (_CLUSTER_TC,
                                        "tensorfft_tpu/ops/four_step_pallas.py:768"),
}
KERNELS.update(BIGN_KERNELS)
# The K1-cluster plans the JAX tuner weighs against the default four-step
# plan at the same N (split (128, 256) at 32768, (128, 512) at 65536).
BIGN_VS_FOUR_STEP = ("K1 cluster N=32768", "K1 cluster bf16 state N=65536")
# Outputs held against the plain versions where a pass is larger than
# 2^24 elements (the 2^27 four-step passes; every earlier path's pass is
# held whole): the first 2^22 elements of each plane.
BIGN_SLICE_ABOVE = 1 << 24
BIGN_HOLD_ELEMS = 1 << 22

# The kernels of the tensor-core engine: one CTA (..._tc_kernel), kernel A's
# pipelined kernels (their roots instances included) and the cluster twins
# (kernel A's and the row passes' row_cluster_kernel, kernel B's
# col_cluster_tc_kernel).
TC_KERNEL = re.compile(
    r"_tc_kernel<|fused_fft_pipe_kernel<|fused_fft_pipe_(cols_)?(roots_)?kernel\(|"
    r"row_cluster_kernel<")
# The -Xptxas -v lines every kernel but the tensor-core engine's must keep.
PTXAS_REFERENCE = "tensorfft_tpu_torch/csrc/ptxas_reference.txt"

# Calls whose output must equal the stacked engine's bit for bit (fp32
# state): pretwiddle runs with grouping off, gridslice keeps it.
TPU_BITWISE = ("pretwiddle N=16384", "pretwiddle N=2^20", "K1a gridslice N=16384",
               "K2cg K2rg gridslice16 N=2^20", "K6g gridslice real N=2^21")
# Rows held against the plain versions where a call's input is larger.
TPU_HOLD_ROWS = 256
R2C_KERNELS = ("fused_fft[pipelined,mma]", "four_step_col[mma]", "four_step_row[mma]", "pack_split",
               "interleave_split", "untangle_fwd", "retangle_inv",
               "four_step_col_packed[mma]", "four_step_row_interleave[mma]")


def on_tensor_cores(name: str) -> bool:
    """Whether a counted kernel variant runs the tensor-core engine (bf16
    matrices): every one-CTA pass (``mma``) and every cluster twin."""
    return "mma" in name or "cluster" in name


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_summary(build_log: str) -> list[str]:
    """One line per compiled kernel: registers, stack, spills, smem."""
    entries, current = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = {"name": m.group(1)}
            entries.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            current.update(stack=m.group(1), spill_st=m.group(2),
                           spill_ld=m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["regs"] = m.group(1)
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            current["smem"] = m.group(1)
    names = [e["name"] for e in entries]
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        pass
    return [f"  {name}: regs={e.get('regs')} stack={e.get('stack')} "
            f"spill_stores={e.get('spill_st')} spill_loads={e.get('spill_ld')} "
            f"static_smem={e.get('smem', '0')}"
            for name, e in zip(names, entries)]


def ptxas_identity(summary: list[str]) -> None:
    """Fail unless every line of PTXAS_REFERENCE (the kernels outside the
    tensor-core engine, as built before it) is in this build's summary, as
    often."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), PTXAS_REFERENCE)
    with open(path) as f:
        ref = collections.Counter(l.strip() for l in f
                                  if l.strip() and not l.startswith("#"))
    missing = ref - collections.Counter(l.strip() for l in summary)
    log(f"[ptxas] {sum(ref.values()) - sum(missing.values())} of {sum(ref.values())} "
        f"reference kernels identical ({PTXAS_REFERENCE}), {sum(missing.values())} "
        f"differ; new: {sum(1 for l in summary if TC_KERNEL.search(l))} "
        f"tensor-core kernels")
    for line in missing:
        log(f"[ptxas] differs from the reference: {line}")
    if missing:
        raise RuntimeError("kernels outside the tensor-core engine compile differently "
                           f"from {PTXAS_REFERENCE}")


def pass_flops(plan, radices, elems: int, first_dot=None) -> int:
    """fp32 FLOPs of one pass's stage products (each a bf16 x bf16 product
    accumulated in fp32) over ``elems`` complex elements: four real
    products per stage, three on a mult3 stage; ``first_dot`` defaults to
    the plan's."""
    from tensorfft_tpu_torch.ops.fused_cuda import pass_stages

    alg = plan.precision.dot_algorithm
    first_dot = plan.first_dot if first_dot is None else first_dot
    first = first_dot if (first_dot != "default" and alg == "bf16") else alg
    stages = pass_stages(tuple(radices), plan.engine, plan.grouped,
                         plan.complex_mult)
    return sum((6 if st.mult3 else 8) * st.radix * elems
               * PRODUCTS[first if i == 0 else alg]
               for i, st in enumerate(stages))


def kernel_work(plan, batch: int):
    """(fp32 FLOPs the scalar-FMA kernels execute, HBM bytes at one read and
    one write of both planes per pass) of one ``fft_split`` under ``plan``."""
    elems = plan.fft_length * batch
    passes = ([plan.radices] if plan.four_step_split is None
              else [plan.col_radices, plan.row_radices])
    flops = sum(pass_flops(plan, radices, elems) for radices in passes)
    item = plan.precision.storage_dtype.itemsize
    return flops, 2 * 2 * item * elems * len(passes)


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA device", file=sys.stderr)
        return 2

    import tensorfft_tpu_torch as tt
    from tensorfft_tpu_torch import bluestein
    from tensorfft_tpu_torch.fft import four_step_call_kwargs, stage_scales
    from tensorfft_tpu_torch.models import poisson, poisson_solve_3d
    from tensorfft_tpu_torch.ops import (_build, four_step_cuda, fused_cuda,
                                         rfft_cuda, spectral_cuda)
    from tensorfft_tpu_torch.rfft import _inverse_pre_scale, _output_scale
    from tensorfft_tpu_torch.testing import (agreement, deviation, fft_oracle,
                                             get_random_weights,
                                             make_test_signal, measure,
                                             sine_superposition,
                                             sine_superposition_torch)
    from tensorfft_tpu_torch.testing.conformance import (
        REFERENCE_SWEEP as CONFORMANCE_SWEEP, run_unit_sweep)
    from tensorfft_tpu_torch.plan import effective_state_dtype
    from tensorfft_tpu_torch.testing.metrics import (
        BF16_MAX_SCALE_ULPS, BF16_STATE_MAX_FRAC, BF16_STATE_MAX_SCALE_ULPS,
        FOUR_STEP_MAX_FRAC, FUSED_MAX_FRAC, bf16_ulp)
    from tensorfft_tpu_torch.tuning import TunerCache
    from tensorfft_tpu_torch.utils.device import H100

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # The plain versions' fp32 products must stay full fp32 on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    build_log = _build.build_log()
    log("[build] per source: " + ", ".join(
        l[len("[nvcc] "):] for l in build_log.splitlines() if l.startswith("[nvcc] ")))
    summary = ptxas_summary(build_log)
    for line in summary:
        log(line)
    ptxas_identity(summary)
    for line in summary:
        if "untangle_pairs_kernel<" in line or "retangle_pairs_kernel<" in line:
            log(f"[ptxas] untangle pair:{line}")

    def inputs(n, b, dtype, seed, planes=2):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((planes, b, n), dtype=np.float32)
        return tuple(torch.from_numpy(p).to(dev, dtype) for p in x)

    def device_inputs(n, b, dtype, seed, planes=2):
        """Seeded normal planes made on the card (the bign path's 2^26- and
        2^27-element inputs, which numpy makes in ~2 s each)."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tuple(torch.randn((b, n), generator=gen, device=dev).to(dtype)
                     for _ in range(planes))

    def sine_signal(n):
        """make_test_signal(n, 42, 42 * 42), one row, built on the card in
        fp64 (sum_h w_h sin(2 pi h j / N), the direct form of its sine
        superposition), and its exact forward spectrum / N: bin h holds
        (w_im[h] - i w_re[h]) / 2 and bin N - h (i w_re[h] - w_im[h]) / 2.
        At N = 2^27 numpy's three FFTs of the spectral form take ~35 s."""
        weights = [get_random_weights(20, 42), get_random_weights(20, 42 * 42)]
        j = torch.arange(n, dtype=torch.float64, device=dev)
        x = []
        for w in weights:
            row = torch.zeros(n, dtype=torch.float64, device=dev)
            for h in range(1, len(w)):
                row += float(w[h]) * torch.sin((2.0 * math.pi * h / n) * j)
            x.append(row[None])
        o_re, o_im = np.zeros((1, n)), np.zeros((1, n))
        for h in range(1, len(weights[0])):
            o_re[0, h], o_im[0, h] = weights[1][h] / 2, -weights[0][h] / 2
            o_re[0, n - h], o_im[0, n - h] = -weights[1][h] / 2, weights[0][h] / 2
        return tuple(x), (o_re, o_im)

    wrappers = {
        "fused_fft": fused_cuda.fused_fft,
        "fused_fft_cols": fused_cuda.fused_fft_columns,
        "four_step_col": four_step_cuda.column_pass,
        "four_step_row": four_step_cuda.row_pass,
        "pack_split": rfft_cuda.pack_split,
        "interleave_split": rfft_cuda.interleave_split,
        "untangle_fwd": rfft_cuda.untangle_fwd,
        "retangle_inv": rfft_cuda.retangle_inv,
        "four_step_col_packed": four_step_cuda.column_pass_packed,
        "four_step_row_interleave": four_step_cuda.row_pass_interleave,
        "fft2_col": four_step_cuda.fft2_column_pass,
        "fft2_row": four_step_cuda.fft2_row_pass,
        "fused_fft_batch_major": four_step_cuda.fused_fft_batch_major,
        "poisson_scale": spectral_cuda.poisson_scale,
        "spectral_product": spectral_cuda.spectral_product,
    }
    launches_by_path = {}

    def launch_counts():
        """Launches per kernel, a wrapper that takes an engine counted per
        variant (``fused_cuda.variant``) as ``name[variant]``."""
        counts = dict.fromkeys(KERNELS, 0)
        for name, w in wrappers.items():
            per_variant = getattr(w, "variant_launches", None)
            if per_variant is None:
                counts[name] = w.launches
                continue
            for v, c in per_variant.items():
                counts[f"{name}[{v}]"] = c
        return counts

    def counted(path, required, drive):
        """Run ``drive`` with every counter set to 0 just before and read
        just after; fail unless each kernel in ``required`` was launched."""
        torch.cuda.synchronize()
        for w in wrappers.values():
            if hasattr(w, "variant_launches"):
                fused_cuda.reset_launches(w)
            else:
                w.launches = 0
        result = drive()
        torch.cuda.synchronize()
        counts = launch_counts()
        launches_by_path[path] = counts
        log(f"[main path {path}] launches "
            f"{ {name: c for name, c in counts.items() if c} }")
        for name in required:
            if counts.get(name, 0) < 1:
                raise RuntimeError(f"kernel {name} was not launched on the {path} path")
        return result

    def finite(label, tensors, shape, dtype):
        for t in tensors:
            if not torch.isfinite(t.float()).all():
                raise RuntimeError(f"{label}: non-finite output")
            if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
                raise RuntimeError(f"{label}: output {tuple(t.shape)} {t.dtype}")

    # -- 2. main paths, counted --------------------------------------------
    log(f"[phase] main paths from {time.perf_counter() - t_start:.1f} s")
    data = {}
    for label, n, b in FLAGSHIP:
        data[label] = (tt.create_plan(n), *inputs(n, b, torch.bfloat16,
                                                  SEED + n + b))
    sms = fused_cuda.multiprocessors(dev)

    def kernel_a(n, b, t=None):
        """Kernel A's counted variant for a knob-free bf16 call of b rows of n
        on aligned planes (b > SMs; n >= 512, or a power of two >= 128) under
        the default plan: the pipelined kernel, a row or a tile (the rule's,
        or ``t`` rows) a step; at n = 256 the plan's one radix-256 stage
        gathers its A fragments from its roots on tiles."""
        t = fused_cuda.pipeline_tile(n, b, sms) if t is None else t
        tile = f",tile{t}{',roots' if n == 256 else ''}" if t > 1 else ""
        return f"fused_fft[pipelined{tile},mma]"

    outputs = counted(
        "c2c", ("fused_fft[pipelined,mma]", "fused_fft[pipelined,tile4,mma]",
                "four_step_col[mma]", "four_step_row[mma]"),
        lambda: {label: tt.fft_split(re_, im_, plan)
                 for label, (plan, re_, im_) in data.items()})
    for label, (o_re, o_im) in outputs.items():
        finite(label, (o_re, o_im), data[label][1].shape, torch.bfloat16)

    r2c = {}
    for label, n, b in R2C_FLAGSHIP:
        r2c[label] = (tt.create_plan(n // 2),
                      inputs(n, b, torch.bfloat16, SEED + n + b, planes=1)[0])

    def drive_r2c():
        out = {}
        for label, (plan, x) in r2c.items():
            spec = tt.rfft_split(x, plan)
            out[label] = (spec, tt.irfft_split(*spec, plan))
        return out

    r2c_out = counted("r2c", R2C_KERNELS, drive_r2c)
    for label, ((s_re, s_im), back) in r2c_out.items():
        plan, x = r2c[label]
        b, n = x.shape
        finite(label, (s_re, s_im), (b, n // 2 + 1), torch.bfloat16)
        finite(label, (back,), (b, n), torch.bfloat16)

    h, w = ND_IMAGE
    img_np, ker_np = np.random.default_rng(SEED + 3).standard_normal(
        (2, h, w), dtype=np.float32)
    image = torch.from_numpy(img_np).to(dev)
    conv_kernel = torch.from_numpy(ker_np).to(dev)
    planes2d = tuple(p.reshape(h, w) for p in inputs(h * w, 1, torch.bfloat16,
                                                     SEED + 4))
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    volume = tuple(torch.randn(ND_VOLUME, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(2))

    def drive_nd():
        conv = tt.fft_convolve_2d(image, conv_kernel)
        spec = tt.fftn_split(*planes2d, axes=(-2, -1))
        back = tt.ifftn_split(*spec, axes=(-2, -1))
        return conv, spec, back, tt.fftn_split(*volume)

    conv2d, spec2d, back2d, vol_spec = counted(
        "nd", ("fft2_col[mma]", "fft2_row[mma]",
               "fused_fft_cols[pipelined,tile16,cols,mma]", "spectral_product"),
        drive_nd)
    finite("fft_convolve_2d", (conv2d,), ND_IMAGE, torch.float32)
    finite("fftn_split 2D", (*spec2d, *back2d), ND_IMAGE, torch.bfloat16)
    finite("fftn_split 3-D", vol_spec, ND_VOLUME, torch.bfloat16)
    del vol_spec

    # The Poisson solve of the volume's real plane: K7 and kernel A on the
    # half-length rows, K9, the half spectrum's two axes (one landed from
    # the strided planes, one through the relayout), the scale, and back
    # through K10 and K8.
    nx, ny, nz = ND_VOLUME
    vol_u = counted(
        "poisson", ("pack_split", kernel_a(nz // 2, nx * ny), "untangle_fwd",
                    "fused_fft_cols[pipelined,tile16,cols,mma]",
                    kernel_a(nx, ny * (nz // 2 + 1)), "poisson_scale", "retangle_inv",
                    "interleave_split"),
        lambda: poisson_solve_3d(volume[0], precision="bfloat16"))
    finite("poisson_solve_3d", (vol_u,), ND_VOLUME, torch.float32)
    del vol_u

    # -- 3. kernels against their plain versions ---------------------------
    log(f"[phase] kernels against plain versions from {time.perf_counter() - t_start:.1f} s")
    errs = {name: 0.0 for name in KERNELS}

    def hold(name, label, got, want, max_frac=FUSED_MAX_FRAC, bf16=True,
             max_ulps=BF16_MAX_SCALE_ULPS, frac_above=0.0):
        """``got`` against ``want`` within ``agreement``'s bounds; with
        ``frac_above`` the differing fraction counts only the elements at
        or above that share of max |want| (the ulp bound still holds every
        element)."""
        g = [x.float().cpu() for x in got]
        w = [x.float().cpu() for x in want]
        a = agreement(g, w, bf16=bf16)
        if frac_above:
            g, w = torch.cat([x.reshape(-1) for x in g]), torch.cat([x.reshape(-1) for x in w])
            big = w.abs() >= frac_above * w.abs().max()
            label = f"{label}: all elements {a}; the {int(big.sum())} >= {frac_above:g} of the scale"
            a = dataclasses.replace(a, frac_differ=float((g[big] != w[big]).double().mean()))
        log(f"[kernel vs plain] {name} {label}: {a}")
        if not a.within(max_frac, max_ulps):
            raise RuntimeError(f"{name} disagrees with its plain version at {label}: {a}")
        errs[name] = max(errs.get(name, 0.0), a.max_abs_err)

    def bitwise(name, label, got, want):
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise RuntimeError(f"{name} is not bit-identical to its plain version at {label}")
        log(f"[kernel vs plain] {name} {label}: bit-identical")

    def named(call):
        """(the one kernel variant ``call`` launched, its output)."""
        before = launch_counts()
        out = call()
        (name,) = [k for k, c in launch_counts().items() if c != before.get(k, 0)]
        return name, out

    def tol(precision, state_dtype, four_step):
        """hold() bounds: a bf16 state two bf16 ulps on at most 2 %; else
        the policy's fused or four-step bound (the latter also for a fused
        transform past N = 16384, testing/metrics.py)."""
        if state_dtype == "bfloat16":
            return dict(max_frac=BF16_STATE_MAX_FRAC, bf16=True,
                        max_ulps=BF16_STATE_MAX_SCALE_ULPS)
        return dict(max_frac=FOUR_STEP_MAX_FRAC if four_step else FUSED_MAX_FRAC,
                    bf16=precision == "bfloat16")

    def roundtrip(back, x, storage):
        x_s = torch.stack([t.to(storage) for t in x]).double()
        return float((torch.stack(list(back)).double() - x_s).abs().max()
                     / x_s.abs().max())

    def pass_kwargs(plan, forward):
        """(four_step_fft kwargs, common, column pass kwargs, row pass
        kwargs) of ``plan``, the state dtype after the narrow-panel rule."""
        kw = four_step_call_kwargs(plan, forward)
        common = dict(n1=kw["n1"], n2=kw["n2"], sign=kw["sign"],
                      algorithm=kw["algorithm"], first_dot=kw["first_dot"],
                      engine=kw["engine"], grouped=kw["grouped"],
                      complex_mult=kw["complex_mult"],
                      state_dtype=effective_state_dtype(
                          kw["state_dtype"], kw["n1"], kw["n2"],
                          kw["lane_tile"], kw["k1_tile"]))
        col = dict(radices1=kw["radices1"], scales1=kw["scales1"],
                   lane_tile=kw["lane_tile"], **common)
        row = dict(radices2=kw["radices2"], scales2=kw["scales2"], **common)
        return kw, common, col, row

    def hold_c2c(label, plan, x, forward=True, sparse=False):
        """``fft_split`` (or ``ifft_split``) of the storage-dtype (B, N)
        planes ``x``, each of its kernels held against its plain version on
        the input it was given: kernel A, or kernel B on ``x`` and kernel C
        on the plain column pass's output, then the whole output against
        the plain pair's.  Past BIGN_SLICE_ABOVE elements the holds read the
        first BIGN_HOLD_ELEMS of each plane.  ``sparse`` (a sine
        superposition's spectrum) counts the differing fraction over the
        elements at or above SPARSE_SIGNAL of the scale only and skips the
        whole-output hold (see SPARSE_SIGNAL).  Returns the whole output."""
        precision = plan.precision.value
        above = SPARSE_SIGNAL if sparse else 0.0
        call = tt.fft_split if forward else tt.ifft_split
        elems = x[0].numel()
        keep = BIGN_HOLD_ELEMS if elems > BIGN_SLICE_ABOVE else elems
        cut = lambda ts: [t.reshape(-1)[:keep] for t in ts]
        where = f"{label}, first {keep} elements" if keep < elems else label
        if plan.resolve_strategy() is tt.Strategy.FUSED:
            name, got = named(lambda: call(*x, plan))
            want = fused_cuda.fused_fft_reference(
                *x, radices=plan.radices,
                scales=stage_scales(plan.radices, plan.scaling, forward),
                sign=-1 if forward else 1, algorithm=plan.precision.dot_algorithm,
                first_dot=plan.first_dot, engine=plan.engine, grouped=plan.grouped,
                complex_mult=plan.complex_mult, state_dtype=plan.state_dtype)
            hold(name, where, cut(got), cut(want), frac_above=above,
                 **tol(precision, plan.state_dtype, x[0].shape[-1] > 16384))
            return got
        got = call(*x, plan)
        _, common, col, row = pass_kwargs(plan, forward)
        t = tol(precision, common["state_dtype"], True)
        name_c, mid = named(lambda: four_step_cuda.column_pass(*x, **col))
        mid_plain = four_step_cuda.column_pass_reference(*x, **col)
        hold(name_c, where, cut(mid), cut(mid_plain), frac_above=above, **t)
        del mid
        name_r, out = named(lambda: four_step_cuda.row_pass(*mid_plain, **row))
        want = four_step_cuda.row_pass_reference(*mid_plain, **row)
        hold(name_r, where, cut(out), cut(want), frac_above=above, **t)
        del out, mid_plain
        if sparse:
            return got
        a = agreement([g.float().cpu() for g in cut(got)],
                      [w.float().cpu() for w in cut(want)], bf16=t["bf16"])
        log(f"[kernel vs plain] four-step end to end {where}: {a}")
        if not a.within(t["max_frac"], t.get("max_ulps", BF16_MAX_SCALE_ULPS)):
            raise RuntimeError(f"four-step disagrees with its plain version at {where}: {a}")
        return got

    for label, (plan, re_, im_) in data.items():
        if plan.resolve_strategy() is tt.Strategy.FUSED:
            want = fused_cuda.fused_fft_reference(
                re_, im_, radices=plan.radices,
                scales=stage_scales(plan.radices, plan.scaling, True),
                algorithm=plan.precision.dot_algorithm,
                first_dot=plan.first_dot)
            hold(kernel_a(plan.fft_length, re_.shape[0]), label, outputs[label], want,
                 FUSED_MAX_FRAC)
            continue
        kw, common, col, row = pass_kwargs(plan, True)
        mid_plain = four_step_cuda.column_pass_reference(re_, im_, **col)
        hold("four_step_col[mma]", label,
             four_step_cuda.column_pass(re_, im_, **col), mid_plain,
             FOUR_STEP_MAX_FRAC)
        hold("four_step_row[mma]", label,
             four_step_cuda.row_pass(*mid_plain, **row),
             four_step_cuda.row_pass_reference(*mid_plain, **row),
             FOUR_STEP_MAX_FRAC)
        want = four_step_cuda.four_step_fft_reference(
            re_, im_, radices1=kw["radices1"], radices2=kw["radices2"],
            scales1=kw["scales1"], scales2=kw["scales2"],
            lane_tile=kw["lane_tile"], **common)
        a = agreement([o.float().cpu() for o in outputs[label]],
                      [w.float().cpu() for w in want], bf16=True)
        log(f"[kernel vs plain] four-step end to end {label}: {a}")
        if not a.within(FOUR_STEP_MAX_FRAC):
            raise RuntimeError(f"four-step disagrees with its plain version: {a}")

    # The R2C kernels, each on the inputs the main path gave it.
    r2c_args = {}
    for label, (plan, x) in r2c.items():
        b, n = x.shape
        m = n // 2
        (s_re, s_im), _ = r2c_out[label]
        fwd_scale = float(_output_scale(plan, True))
        inv = dict(n=n, scale=float(_inverse_pre_scale(plan)),
                   out_dtype=torch.bfloat16)
        z = rfft_cuda.retangle_inv(s_re, s_im, **inv)
        bitwise("retangle_inv", label, z,
                rfft_cuda.retangle_inv_reference(s_re, s_im, **inv))
        if plan.resolve_strategy() is tt.Strategy.FOUR_STEP:
            _, _, col, _ = pass_kwargs(plan, True)
            _, _, _, row = pass_kwargs(plan, False)
            Z = four_step_cuda.four_step_fft_packed_real(
                x, **four_step_call_kwargs(plan, True))
            hold("four_step_col_packed[mma]", label,
                 four_step_cuda.column_pass_packed(x, **col),
                 four_step_cuda.column_pass_packed_reference(x, **col),
                 FOUR_STEP_MAX_FRAC)
            mid = four_step_cuda.column_pass(*z, **pass_kwargs(plan, False)[2])
            hold("four_step_row_interleave[mma]", label,
                 [four_step_cuda.row_pass_interleave(*mid, **row)],
                 [four_step_cuda.row_pass_interleave_reference(*mid, **row)],
                 FOUR_STEP_MAX_FRAC)
            r2c_args[label] = dict(x=x, Z=Z, spec=(s_re, s_im), mid=mid,
                                   col=col, row=row)
        else:
            zp = rfft_cuda.pack_split(x)
            bitwise("pack_split", label, zp, rfft_cuda.pack_split_reference(x))
            Z = tt.fft_split(*zp, plan)
            o = tt.ifft_split(*z, plan)
            bitwise("interleave_split", label, [rfft_cuda.interleave_split(*o)],
                    [rfft_cuda.interleave_split_reference(*o)])
            r2c_args[label] = dict(x=x, Z=Z, spec=(s_re, s_im), planes=o)
        bitwise("untangle_fwd", label,
                rfft_cuda.untangle_fwd(*Z, n=n, scale=fwd_scale),
                rfft_cuda.untangle_fwd_reference(*Z, n=n, scale=fwd_scale))
        r2c_args[label]["fwd_scale"] = fwd_scale
        r2c_args[label]["inv"] = inv
        # fp32 storage in, bf16 out: K10's input need not be the storage dtype.
        f_re, f_im = s_re.float(), s_im.float()
        bitwise("retangle_inv", f"{label} fp32-in",
                rfft_cuda.retangle_inv(f_re, f_im, **inv),
                rfft_cuda.retangle_inv_reference(f_re, f_im, **inv))

    # The same kernels under the float32 policy (fp32 storage, bf16x3).
    for label, n, b in R2C_FP32:
        plan = tt.create_plan(n // 2, precision="float32")
        (x,) = inputs(n, b, torch.float32, SEED + n, planes=1)
        tag = f"{label} float32 B={b}"
        s_re, s_im = tt.rfft_split(x, plan)
        inv = dict(n=n, scale=float(_inverse_pre_scale(plan)),
                   out_dtype=torch.float32)
        z = rfft_cuda.retangle_inv(s_re, s_im, **inv)
        bitwise("retangle_inv", tag, z,
                rfft_cuda.retangle_inv_reference(s_re, s_im, **inv))
        if plan.resolve_strategy() is tt.Strategy.FOUR_STEP:
            _, _, col, _ = pass_kwargs(plan, True)
            _, _, inv_col, row = pass_kwargs(plan, False)
            Z = four_step_cuda.column_pass_packed(x, **col)
            hold("four_step_col_packed[mma]", tag, Z,
                 four_step_cuda.column_pass_packed_reference(x, **col), bf16=False)
            Z = four_step_cuda.row_pass(*Z, **pass_kwargs(plan, True)[3])
            mid = four_step_cuda.column_pass(*z, **inv_col)
            hold("four_step_row_interleave[mma]", tag,
                 [four_step_cuda.row_pass_interleave(*mid, **row)],
                 [four_step_cuda.row_pass_interleave_reference(*mid, **row)],
                 bf16=False)
        else:
            zp = rfft_cuda.pack_split(x)
            bitwise("pack_split", tag, zp, rfft_cuda.pack_split_reference(x))
            Z = tt.fft_split(*zp, plan)
            o = tt.ifft_split(*z, plan)
            bitwise("interleave_split", tag, [rfft_cuda.interleave_split(*o)],
                    [rfft_cuda.interleave_split_reference(*o)])
        fs = float(_output_scale(plan, True))
        bitwise("untangle_fwd", tag, rfft_cuda.untangle_fwd(*Z, n=n, scale=fs),
                rfft_cuda.untangle_fwd_reference(*Z, n=n, scale=fs))

    # The untangle pair on short rows (many rows of a few runs each).
    short_label, short_n, short_b = R2C_SHORT
    short_plan = tt.create_plan(short_n // 2)
    short = dict(n=short_n, b=short_b, fs=float(_output_scale(short_plan, True)),
                 inv=dict(n=short_n, scale=float(_inverse_pre_scale(short_plan)),
                          out_dtype=torch.bfloat16),
                 Z=inputs(short_n // 2, short_b, torch.bfloat16, SEED + 21),
                 spec=inputs(short_n // 2 + 1, short_b, torch.bfloat16, SEED + 22))
    bitwise("untangle_fwd", R2C_SHAPE[short_label],
            rfft_cuda.untangle_fwd(*short["Z"], n=short_n, scale=short["fs"]),
            rfft_cuda.untangle_fwd_reference(*short["Z"], n=short_n, scale=short["fs"]))
    bitwise("retangle_inv", R2C_SHAPE[short_label],
            rfft_cuda.retangle_inv(*short["spec"], **short["inv"]),
            rfft_cuda.retangle_inv_reference(*short["spec"], **short["inv"]))

    def fft2_kwargs(hh, ww, precision):
        """The K4 pass arguments of fftn_split's 2D branch (forward): the
        plain first stage, whatever the plans' first_dot."""
        ph = tt.create_plan(hh, precision=precision)
        pw = tt.create_plan(ww, precision=precision)
        common = dict(sign=-1, algorithm=ph.precision.dot_algorithm)
        return (ph, pw,
                dict(radices1=ph.radices,
                     scales1=stage_scales(ph.radices, ph.scaling, True), **common),
                dict(radices2=pw.radices,
                     scales2=stage_scales(pw.radices, pw.scaling, True), **common))

    def hold_fft2(label, x, col_kw, row_kw, bf16=True, suffix=""):
        """Both K4 passes on ``x``, the row pass on the plain column pass's
        output; returns that output.  ``suffix`` names the engine's kernels
        (``[planar_vpu]``)."""
        mid = four_step_cuda.fft2_column_pass_reference(*x, **col_kw)
        hold(f"fft2_col[{suffix[1:-1] + ',' if suffix else ''}mma]", label,
             four_step_cuda.fft2_column_pass(*x, **col_kw), mid,
             FOUR_STEP_MAX_FRAC, bf16)
        hold(f"fft2_row[{suffix[1:-1] + ',' if suffix else ''}mma]", label,
             four_step_cuda.fft2_row_pass(*mid, **row_kw),
             four_step_cuda.fft2_row_pass_reference(*mid, **row_kw),
             FOUR_STEP_MAX_FRAC, bf16)
        return mid

    # K4 on each input the N-D path gave it: the 4096 x 4096 bf16 planes,
    # the float32 image of fft_convolve_2d (imaginary plane 0) and the
    # 512 x 512 planes of the 512^3 volume.
    nd_plans = fft2_kwargs(h, w, "bfloat16")
    _, _, k4_col, k4_row = nd_plans
    k4_mid = hold_fft2(f"{h}x{w} bf16",
                       tuple(p.reshape(1, h, w) for p in planes2d), k4_col, k4_row)
    _, _, col32, row32 = fft2_kwargs(h, w, "float32")
    hold_fft2(f"{h}x{w} float32 (fft_convolve_2d image)",
              (image.reshape(1, h, w), torch.zeros(1, h, w, device=dev)),
              col32, row32, bf16=False)
    n_v = ND_VOLUME[0]
    _, _, v_col, v_row = fft2_kwargs(n_v, n_v, "bfloat16")
    hold_fft2(f"{'x'.join(map(str, ND_VOLUME))} bf16", volume, v_col, v_row)
    # Kernel A on the rows the per-axis loop gave it: axis 0 of the volume
    # after K4, moved last.  The N=512 plan runs the bf16ax2 first stage.
    plan_v = tt.create_plan(n_v)
    mid = tt.fftn_split(*volume, axes=(1, 2))
    rows = [torch.movedim(t, 0, -1).reshape(-1, n_v).contiguous() for t in mid]
    v_label = (f"{'x'.join(map(str, ND_VOLUME))} axis 0, N={n_v} "
               f"x B={rows[0].shape[0]} first_dot={plan_v.first_dot}")
    v_kw = dict(radices=plan_v.radices,
                scales=stage_scales(plan_v.radices, plan_v.scaling, True),
                algorithm=plan_v.precision.dot_algorithm,
                first_dot=plan_v.first_dot)
    v_plain = fused_cuda.fused_fft_reference(*rows, **v_kw)
    v_rows = tt.fft_split(*rows, plan_v)
    hold(kernel_a(n_v, rows[0].shape[0]), v_label, v_rows, v_plain, FUSED_MAX_FRAC)
    # The same pass landed straight from K4's output (no relayout): kernel
    # A's bits on the copied rows.
    v_cols = [t.reshape(-1, n_v)
              for t in fused_cuda.fused_fft_columns(*mid, 0, **v_kw)]
    bitwise("fused_fft_cols[pipelined,tile16,cols,mma]",
            f"{v_label} (against the relayout's rows)", v_cols, v_rows)
    hold("fused_fft_cols[pipelined,tile16,cols,mma]", v_label, v_cols, v_plain,
         FUSED_MAX_FRAC)
    del mid, rows, v_plain, v_rows, v_cols
    # The spectral scale on the half spectrum the Poisson solve of the
    # volume's real plane gives it (y innermost, as the forward pass leaves
    # it), bit for bit with its plain version.
    p_tables = poisson.device_tables(ND_VOLUME, (1.0, 1.0, 1.0), True, dev)
    p_half = tt.rfftn_split(volume[0], precision="bfloat16")
    bitwise("poisson_scale", f"{'x'.join(map(str, ND_VOLUME))} half spectrum, strides "
            f"{p_half[0].stride()}", spectral_cuda.poisson_scale(*p_half, *p_tables),
            spectral_cuda.poisson_scale_reference(*p_half, *p_tables))
    # The spectral product on the spectra fft_convolve_2d gives it (the
    # image's and the kernel's, float32), bit for bit with its plain version.
    conv_spectra = [tt.fftn_split(x, torch.zeros_like(x), axes=(-2, -1), precision="float32")
                    for x in (image, conv_kernel)]
    bitwise("spectral_product", f"{h}x{w} float32 spectra (fft_convolve_2d)",
            spectral_cuda.spectral_product(*conv_spectra[0], *conv_spectra[1]),
            spectral_cuda.spectral_product_reference(*conv_spectra[0], *conv_spectra[1]))
    torch.cuda.synchronize()

    # -- 4. reference gates and round trips --------------------------------
    log(f"[phase] gates from {time.perf_counter() - t_start:.1f} s")
    # The two paths run in functions of their own, so their names do not
    # replace the main paths' (h, w, b, ...), which later phases read.
    def conformance_path():
        # -- conformance: the reference sweep through the ported harness --------
        # It replaces the C2C part of this step's gate: every length 256 ... 2^28
        # at 10 seeds under both policies, signal, oracle and deviation made on
        # the card (testing.conformance with device="cuda").
        t_phase = time.perf_counter()
        log(f"[phase] conformance path from {t_phase - t_start:.1f} s")
        n_hold = 1 << 20
        w_re, w_im = get_random_weights(20, 42), get_random_weights(20, 42 * 42)
        for w in (w_re, w_im):
            want = sine_superposition(n_hold, w)
            got = sine_superposition_torch(n_hold, w, dev)
            err = float(np.abs(got.cpu().numpy() - want).max() / np.abs(want).max())
            log(f"[conformance] card datagen N={n_hold} vs numpy: max_rel={err:.3e}")
            if err > CARD_HOLD_REL:
                raise RuntimeError(f"card datagen off by {err:.3e} of its scale")
        sig64 = [sine_superposition(n_hold, w) for w in (w_re, w_im)]
        want = fft_oracle(*sig64)
        got = fft_oracle(*sig64, device=dev)
        err = max(float(np.abs(g.cpu().numpy() - w).max()) for g, w in zip(got, want))
        err /= max(float(np.abs(w).max()) for w in want)
        log(f"[conformance] card oracle N={n_hold} vs numpy: max_rel={err:.3e}")
        if err > CARD_HOLD_REL:
            raise RuntimeError(f"card oracle off by {err:.3e} of its scale")
        del sig64, want, got

        sweep = {}

        def drive_conformance():
            for lo, hi in ((CONFORMANCE_SWEEP["start_fft_length"],
                            CONFORMANCE_SWEEP["end_fft_length"]),
                           (CONFORMANCE_SWEEP["end_fft_length"] * 2, CONFORMANCE_TAIL)):
                for precision in ("bfloat16", "float32"):
                    n = lo
                    while n <= hi:
                        works, why = tt.plan_works_on_device(
                            tt.create_plan(n, precision=precision), dev)
                        if not works:
                            log(f"[conformance] {precision} N={n}: REFUSED ({why})")
                            raise RuntimeError(f"the port refuses N={n} {precision}: {why}")
                        t0 = time.perf_counter()
                        record = []
                        ok = run_unit_sweep(
                            n, n, CONFORMANCE_SWEEP["runs_per_fft_length"],
                            CONFORMANCE_SWEEP["highest_harmonic"], precision=precision,
                            verbose=False, device=dev, record=record)
                        torch.cuda.synchronize()
                        devs = [d for _, _, d in record]
                        sweep[precision, n] = devs
                        log(f"[conformance] {precision} N={n} seeds={len(devs)} "
                            f"{tt.create_plan(n, precision=precision).resolve_strategy().value}: "
                            f"worst avg={max(d.average for d in devs):.3e} "
                            f"sigma={max(d.sigma for d in devs):.3e} "
                            f"max={max(d.maximum for d in devs):.3e} "
                            f"{'PASS' if ok else 'FAIL'} ({time.perf_counter() - t0:.2f} s)")
                        if not ok:
                            raise RuntimeError(f"reference gate failed at {precision} N={n}: "
                                               f"{devs[-1]}")
                        n *= 2
                    torch.cuda.empty_cache()

        counted("conformance", CONFORMANCE_KERNELS, drive_conformance)
        want_launches = collections.Counter()
        for (precision, n), devs in sweep.items():
            names = (("fused_fft[mma]",) if n <= 16384
                     else ("four_step_col[mma]", "four_step_row[mma]"))
            for name in names:
                want_launches[name] += len(devs)
        got_launches = {k: c for k, c in launches_by_path["conformance"].items() if c}
        if got_launches != dict(want_launches):
            raise RuntimeError(f"conformance path launched {got_launches}, "
                               f"expected {dict(want_launches)}")
        # Every run's largest deviation against the spectrum's scale S (the
        # gate alone cannot fail a wrong output at large N).
        weights = [(get_random_weights(20, 42 * i), get_random_weights(20, 42 * 42 * i))
                   for i in range(CONFORMANCE_SWEEP["runs_per_fft_length"])]
        scales = [max(np.abs(w_r[1:]).max(), np.abs(w_i[1:]).max()) / 2
                  for w_r, w_i in weights]
        for (precision, n), devs in sweep.items():
            if precision == "bfloat16":
                worst = max(d.maximum / bf16_ulp(scales[i]) for i, d in enumerate(devs))
                ok, unit = worst <= CONFORMANCE_MAX_BF16_ULPS, "bf16 ulps of S"
            else:
                worst = max(d.maximum / scales[i] for i, d in enumerate(devs))
                ok, unit = worst <= CONFORMANCE_MAX_F32_REL, "of S"
            if not ok:
                raise RuntimeError(f"conformance {precision} N={n}: largest deviation "
                                   f"{worst:.3e} {unit}")
            log(f"[conformance bound] {precision} N={n}: worst max {worst:.3e} {unit} PASS")

        # One seed per length and policy again, outside the count: each kernel
        # against its plain version on the input the sweep gave it (its
        # output tied to the sweep's by its deviation), and the round trip
        # through ifft_split at the lengths of C2C_ROUNDTRIP.
        seed = 1
        for (precision, n), devs in sweep.items():
            plan = tt.create_plan(n, precision=precision)
            storage = plan.precision.storage_dtype
            sig64 = [sine_superposition_torch(n, w, dev) for w in weights[seed]]
            x = tuple(p.to(storage).reshape(1, n) for p in sig64)
            label = f"conformance {precision} N={n} seed {seed}"
            got = hold_c2c(label, plan, x, sparse=True)
            d = deviation(tuple(g.reshape(-1).double() for g in got),
                          fft_oracle(*sig64, device=dev))
            if d != devs[seed]:
                raise RuntimeError(f"{label}: held output {d} is not the sweep's {devs[seed]}")
            if n in C2C_ROUNDTRIP[precision]:
                rt = roundtrip(tt.ifft_split(*got, plan), x, storage)
                ok = rt <= ROUNDTRIP_TOL[precision]
                log(f"[conformance] {precision} N={n} roundtrip_rel={rt:.3e} "
                    f"(tol {ROUNDTRIP_TOL[precision]:g}) {'PASS' if ok else 'FAIL'}")
                if not ok:
                    raise RuntimeError(f"C2C round trip failed at {precision} N={n}")
            del sig64, x, got
            torch.cuda.empty_cache()
        log(f"[conformance] {len(sweep)} lengths x policies, "
            f"{sum(len(d) for d in sweep.values())} runs, all PASS, launches "
            f"{got_launches}, every length's kernels held against their plain "
            f"versions ({time.perf_counter() - t_phase:.1f} s) | {smi}")

    def any_path():
        # -- any: Bluestein, fft_split_any then ifft_split_any, counted ---------
        t_phase = time.perf_counter()
        log(f"[phase] any path from {t_phase - t_start:.1f} s")
        for label, n, b, precision, kernels in ANY_CALLS:
            x32 = np.random.default_rng(SEED + n + b).standard_normal(
                (2, b, n), dtype=np.float32)
            x_re, x_im = (torch.from_numpy(p).to(dev) for p in x32)
            storage = tt.create_plan(8, precision=precision).precision.storage_dtype
            kw = dict(precision=precision, tuning=None)
            fwd = counted(f"any fwd {label}", kernels,
                          lambda: tt.fft_split_any(x_re, x_im, **kw))
            back = counted(f"any inv {label}", kernels,
                           lambda: tt.ifft_split_any(*fwd, **kw))
            for path in (f"any fwd {label}", f"any inv {label}"):
                got_launches = {k: c for k, c in launches_by_path[path].items() if c}
                if got_launches != dict.fromkeys(kernels, 2):
                    raise RuntimeError(f"{path} launched {got_launches}, expected "
                                       f"2 of each of {kernels}")
            finite(f"fft_split_any {label}", (*fwd, *back), (b, n), storage)
            want = np.fft.fft(x32[0].astype(np.float64) + 1j * x32[1], axis=-1) / n
            got = fwd[0].double().cpu().numpy() + 1j * fwd[1].double().cpu().numpy()
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            d = deviation((got.real, got.imag), (want.real, want.imag))
            x_s = torch.stack([x_re, x_im]).double()
            rt = float((torch.stack(list(back)).double() - x_s).abs().max()
                       / x_s.abs().max())
            rt_tol = ANY_ROUNDTRIP_TOL[precision]
            ok = (rel <= ANY_F32_REL if precision == "float32"
                  else d.passes_reference_gate()) and rt <= rt_tol
            log(f"[any gate] {label}: max_rel={rel:.3e} {d} roundtrip_rel={rt:.3e} "
                f"(tol {rt_tol:g}) {'PASS' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"fft_split_any gate failed at {label}")
            del want, got
            # The M-point kernels against their plain versions on the padded
            # rows fft_split_any gives them: the chirped input forward, its
            # spectrum times the kernel's inverse (bluestein.py's steps).
            a_re, a_im, bh_re, bh_im, m = bluestein._tables(n, dev)
            mplan = tt.create_plan(m, precision=precision, scaling="none", tuning=None)
            y = tuple(torch.nn.functional.pad(p, (0, m - n)).to(storage)
                      for p in bluestein._cmul(x_re, x_im, a_re, a_im))
            f = hold_c2c(f"any {label} M={m} padded rows", mplan, y)
            g = tuple(p.to(storage) for p in bluestein._cmul(
                f[0].float(), f[1].float(), bh_re, bh_im))
            hold_c2c(f"any {label} M={m} padded rows inverse", mplan, g, forward=False)
            del f, g
            t_any = measure(lambda r, i: tt.fft_split_any(r, i, **kw), (x_re, x_im),
                            iters=10).average_time_ms
            # Of that, the two M-point transforms alone on the padded rows.
            t_m = measure(lambda r, i: tt.ifft_split(*tt.fft_split(r, i, mplan), mplan),
                          y, iters=10).average_time_ms
            x_c = torch.complex(x_re, x_im)
            t_lib = measure(lambda v: torch.fft.fft(v, dim=-1), (x_c,),
                            iters=10).average_time_ms
            log(f"[time] fft_split_any {label}: {t_any:.4f} ms, of which the two "
                f"M={m} transforms {t_m:.4f} ms | torch.fft.fft c64 {t_lib:.4f} ms | {smi}")
            del x_c, fwd, back, x_re, x_im, x_s, x32, y

        # A power of two delegates to fft_split: kernel A, the same bits.
        n, b = ANY_POW2
        x_re, x_im = inputs(n, b, torch.float32, SEED + 11)
        got = counted("any pow2", ("fused_fft[mma]",),
                      lambda: tt.fft_split_any(x_re, x_im, tuning=None))
        if {k: c for k, c in launches_by_path["any pow2"].items() if c} != {"fused_fft[mma]": 1}:
            raise RuntimeError(f"fft_split_any at N={n} launched "
                               f"{launches_by_path['any pow2']}")
        want = tt.fft_split(x_re, x_im, precision="float32", tuning=None)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"fft_split_any at N={n} differs from fft_split")
        log(f"[any] pow2 N={n} x B={b} float32: kernel A once, bit-identical to fft_split")
        del x_re, x_im, got, want
        log(f"[any] {len(ANY_CALLS)} shapes and the pow2 delegation PASS "
            f"({time.perf_counter() - t_phase:.1f} s)")

    conformance_path()
    any_path()
    log(f"[phase] R2C, N-D and convolution gates from {time.perf_counter() - t_start:.1f} s")

    for precision, lengths in (("bfloat16", R2C_GATE_BF16),
                               ("float32", R2C_GATE_F32)):
        for n in lengths:
            seeds = range(1, 3)
            sig = [make_test_signal(n, 42 * s, 42 * 42 * s) for s in seeds]
            x64 = np.stack([p for s in sig for p in s])  # 4 real rows
            plan = tt.create_plan(n // 2, precision=precision)
            x = torch.from_numpy(x64).to(dev)
            o_re, o_im = tt.rfft_split(x, plan)
            want = np.fft.rfft(x64, axis=-1) / n
            d = deviation((o_re.double().cpu().numpy(), o_im.double().cpu().numpy()),
                          (want.real, want.imag))
            x_s = x.to(plan.precision.storage_dtype).double()
            back = tt.irfft_split(o_re, o_im, plan).double()
            rt = float((back - x_s).abs().max() / x_s.abs().max())
            ok = d.passes_reference_gate() and rt <= ROUNDTRIP_TOL[precision]
            log(f"[r2c gate] {precision} N={n} rows={x64.shape[0]} "
                f"{plan.resolve_strategy().value}: {d} roundtrip_rel={rt:.3e} "
                f"{'PASS' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"R2C accuracy gate failed at {precision} N={n}")

    def nd_gate(what, shape, precision, got, want, rt):
        d = deviation((got[0].double().cpu().numpy(), got[1].double().cpu().numpy()),
                      (want.real, want.imag))
        ok = d.passes_reference_gate() and rt <= ROUNDTRIP_TOL[precision]
        log(f"[nd gate] {what} {precision} {'x'.join(map(str, shape))}: {d} "
            f"roundtrip_rel={rt:.3e} {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"N-D accuracy gate failed: {what} {precision} {shape}")

    def nd_signal(shape):
        """make_test_signal's rows (the 1D gate's signal) laid out over
        ``shape``: fp64 host planes and their device copies."""
        re64, im64 = (p.reshape(shape) for p in
                      make_test_signal(math.prod(shape), 42, 42 * 42))
        return re64, im64, torch.from_numpy(re64).to(dev), torch.from_numpy(im64).to(dev)

    for shape in ND_GATE_2D:
        re64, im64, x_re, x_im = nd_signal(shape)
        want = np.fft.fft2(re64 + 1j * im64) / (shape[0] * shape[1])
        for precision in ("bfloat16", "float32"):
            storage = tt.create_plan(8, precision=precision).precision.storage_dtype
            f = tt.fftn_split(x_re, x_im, axes=(-2, -1), precision=precision)
            back = tt.ifftn_split(*f, axes=(-2, -1), precision=precision)
            nd_gate("fft2", shape, precision, f, want,
                    roundtrip(back, (x_re, x_im), storage))
        if shape == ND_IMAGE:
            f = tt.rfftn_split(x_re)
            back = tt.irfftn_split(*f)
            nd_gate("rfftn", shape, "bfloat16", f, np.fft.rfftn(re64) / re64.size,
                    roundtrip((back,), (x_re,), torch.bfloat16))
    re64, im64, x_re, x_im = nd_signal(ND_GATE_3D)
    f = tt.fftn_split(x_re, x_im)
    nd_gate("fftn", ND_GATE_3D, "bfloat16", f,
            np.fft.fftn(re64 + 1j * im64) / re64.size,
            roundtrip(tt.ifftn_split(*f), (x_re, x_im), torch.bfloat16))
    del re64, im64, x_re, x_im, f, back, want

    want = np.fft.ifft2(np.fft.fft2(img_np.astype(np.float64))
                        * np.fft.fft2(ker_np.astype(np.float64))).real
    rel = float(np.abs(conv2d.double().cpu().numpy() - want).max() / np.abs(want).max())
    log(f"[convolve] fft_convolve_2d float32 {h}x{w} (main path output): "
        f"max_rel={rel:.3e} {'PASS' if rel <= CONVOLVE_TOL else 'FAIL'}")
    if rel > CONVOLVE_TOL:
        raise RuntimeError(f"fft_convolve_2d off by {rel:.3e}")
    del want

    n_conv = 1 << 16
    rng = np.random.default_rng(SEED + 7)
    a64, b64 = rng.standard_normal((2, 2, n_conv))
    conv = tt.fft_convolve_real(torch.from_numpy(a64).to(dev),
                                torch.from_numpy(b64).to(dev))
    want = np.fft.irfft(np.fft.rfft(a64) * np.fft.rfft(b64), n_conv)
    rel = float(np.abs(conv.double().cpu().numpy() - want).max() / np.abs(want).max())
    log(f"[convolve] fft_convolve_real float32 N={n_conv} rows=2: "
        f"max_rel={rel:.3e} {'PASS' if rel <= CONVOLVE_TOL else 'FAIL'}")
    if rel > CONVOLVE_TOL:
        raise RuntimeError(f"fft_convolve_real off by {rel:.3e}")

    @contextlib.contextmanager
    def tuner_cache(entries, path):
        """A bf16 ``cuda`` tuner cache holding ``entries`` (length -> entry)
        in a temporary directory, named by TENSORFFT_TUNER_CACHE while the
        context is open."""
        tune_dir = tempfile.mkdtemp(prefix="tfft_tuner_")
        cache = TunerCache(os.path.join(tune_dir, "tuner_cache.json"))
        for n_t, entry in entries.items():
            cache.put(n_t, "bfloat16", "cuda", entry)
        cache.save()
        log(f"[{path}] tuner cache {cache.path.name} (platform cuda): "
            f"{json.dumps({str(k): v for k, v in entries.items()})}; TPU "
            f"structures used as test plans, not CUDA tuning results")
        saved_env = os.environ.get("TENSORFFT_TUNER_CACHE")
        os.environ["TENSORFFT_TUNER_CACHE"] = str(cache.path)
        try:
            yield
        finally:
            if saved_env is None:
                os.environ.pop("TENSORFFT_TUNER_CACHE", None)
            else:
                os.environ["TENSORFFT_TUNER_CACHE"] = saved_env
            shutil.rmtree(tune_dir)

    # -- tuned: the tuned-plan path, counted, held and gated -----------------
    log(f"[phase] tuned path from {time.perf_counter() - t_start:.1f} s")
    # The JAX package's TPU-tuned structures (n=2^23 as tuned there, n=4096
    # with the planar_vpu engine) and n=16384's default radices under planar.
    tuned_in = {label: inputs(n_t, b_t, torch.bfloat16, SEED + 11 + i)
                for i, (label, n_t, b_t, _, _) in enumerate(TUNED_CALLS)}
    k4_tuned = {"fft2_col[planar_vpu,mma]": 2, "fft2_row[planar_vpu,mma]": 2}

    def expect(label, before, want):
        """Fail unless the launches since ``before`` are exactly ``want``."""
        after = launch_counts()
        delta = {k: c - before.get(k, 0) for k, c in after.items()
                 if c != before.get(k, 0)}
        if delta != want:
            raise RuntimeError(f"call {label} launched {delta}, expected {want}")
        log(f"[launches] {label}: {delta}")

    def drive_tuned():
        out = {}
        for label, _, _, layout, want in TUNED_CALLS:
            before = launch_counts()
            spec = tt.fft_split(*tuned_in[label], tuning="auto", fused_layout=layout)
            back = tt.ifft_split(*spec, tuning="auto", fused_layout=layout)
            torch.cuda.synchronize()
            expect(label, before, want)
            out[label] = (spec, back)
        before = launch_counts()
        spec = tt.fftn_split(*planes2d, axes=(-2, -1))  # inner plans: "auto"
        back = tt.ifftn_split(*spec, axes=(-2, -1))
        torch.cuda.synchronize()
        expect(f"fftn {h}x{w}", before, k4_tuned)
        out["fftn"] = (spec, back)
        return out

    required = sorted({k for *_, want in TUNED_CALLS for k in want} | set(k4_tuned))
    with tuner_cache(TUNED_ENTRIES, "tuned"):
        tuned_plans = {label: tt.create_plan(n_t, tuning="auto", fused_layout=layout)
                       for label, n_t, _, layout, _ in TUNED_CALLS}
        plan2d = tt.create_plan(h, tuning="auto")
        for label, plan in [*tuned_plans.items(), (f"fftn {h}x{w} axes", plan2d)]:
            log(f"[tuned] {label}: {plan.resolve_strategy().value} radices "
                f"{plan.radices} split {plan.four_step_split} col "
                f"{plan.col_radices} row {plan.row_radices} engine "
                f"{plan.engine} grouped {plan.grouped} first_dot "
                f"{plan.first_dot} fused_layout {plan.fused_layout}")
        tuned_out = counted("tuned", required, drive_tuned)
        nd_re64, nd_im64, nd_x_re, nd_x_im = nd_signal(ND_IMAGE)
        before = launch_counts()
        f = tt.fftn_split(nd_x_re, nd_x_im, axes=(-2, -1))
        back = tt.ifftn_split(*f, axes=(-2, -1))
        torch.cuda.synchronize()
        expect(f"fftn {h}x{w} gate", before, k4_tuned)
    nd_gate(f"fft2 tuned {plan2d.engine} radices {plan2d.radices}", ND_IMAGE,
            "bfloat16", f, np.fft.fft2(nd_re64 + 1j * nd_im64) / (h * w),
            roundtrip(back, (nd_x_re, nd_x_im), torch.bfloat16))
    del nd_re64, nd_im64, nd_x_re, nd_x_im, f, back

    def fused_kw(plan):
        return dict(radices=plan.radices,
                    scales=stage_scales(plan.radices, plan.scaling, True),
                    algorithm=plan.precision.dot_algorithm,
                    first_dot=plan.first_dot, engine=plan.engine)

    for label, n_t, b_t, layout, want in TUNED_CALLS:
        plan, x = tuned_plans[label], tuned_in[label]
        spec, back = tuned_out[label]
        finite(f"tuned {label}", (*spec, *back), (b_t, n_t), torch.bfloat16)
        rt = roundtrip(back, x, torch.bfloat16)
        log(f"[tuned] {label} x B={b_t} main path roundtrip_rel={rt:.3e}")
        if rt > ROUNDTRIP_TOL["bfloat16"]:
            raise RuntimeError(f"tuned {label}: round trip off by {rt:.3e}")
        if plan.resolve_strategy() is tt.Strategy.FOUR_STEP:
            _, _, col, row = pass_kwargs(plan, True)
            col, row = dict(col, engine=plan.engine), dict(row, engine=plan.engine)
            mid_plain = four_step_cuda.column_pass_reference(*x, **col)
            hold(f"four_step_col[{plan.engine},mma]", label,
                 four_step_cuda.column_pass(*x, **col), mid_plain, FOUR_STEP_MAX_FRAC)
            hold(f"four_step_row[{plan.engine},mma]", label,
                 four_step_cuda.row_pass(*mid_plain, **row),
                 four_step_cuda.row_pass_reference(*mid_plain, **row),
                 FOUR_STEP_MAX_FRAC)
            continue
        kw = fused_kw(plan)
        (name,) = want
        rows = slice(0, TUNED_HOLD_ROWS.get(label, b_t))
        hold(name, f"{label} x B={b_t}, rows {rows.start}..{rows.stop - 1}",
             [t[rows] for t in spec],
             fused_cuda.fused_fft_reference(*(t[rows] for t in x), **kw),
             FUSED_MAX_FRAC)
        if layout == "batch_major":
            # K3 against kernel A on the same rows and plan: each output's
            # sums run in one order whatever the rows per CTA.
            a_out = fused_cuda.fused_fft(*x, **kw)
            for g, a in zip(spec, a_out):
                if not torch.equal(g, a):
                    raise RuntimeError(f"K3 and kernel A differ at {label}")
            log(f"[kernel vs kernel A] {name} {label} x B={b_t} "
                f"(rows per CTA {four_step_cuda.batch_major_lanes(n_t, b_t)}): "
                f"bit-identical")
            del a_out
    col_t = dict(radices1=plan2d.radices,
                 scales1=stage_scales(plan2d.radices, plan2d.scaling, True),
                 sign=-1, algorithm=plan2d.precision.dot_algorithm,
                 engine=plan2d.engine)
    row_t = dict(radices2=plan2d.radices, scales2=col_t["scales1"], sign=-1,
                 algorithm=col_t["algorithm"], engine=plan2d.engine)
    finite("tuned fftn", (*tuned_out["fftn"][0], *tuned_out["fftn"][1]),
           ND_IMAGE, torch.bfloat16)
    k4t_mid = hold_fft2(f"{h}x{w} bf16 {plan2d.engine}",
                        tuple(p.reshape(1, h, w) for p in planes2d), col_t,
                        row_t, suffix=f"[{plan2d.engine}]")

    # The reference gate and round trip under every tuned plan, through the
    # same kernels and engines (8 rows, so K3 takes the batch-major route).
    for label, n_t, _, _, want in TUNED_CALLS:
        plan = tuned_plans[label]
        sig = [make_test_signal(n_t, 42 * s, 42 * 42 * s)
               for s in range(1, 3 if n_t > 16384 else 9)]
        re64 = np.stack([p[0] for p in sig])
        im64 = np.stack([p[1] for p in sig])
        x_re, x_im = (torch.from_numpy(a).to(dev) for a in (re64, im64))
        before = launch_counts()
        f_re, f_im = tt.fft_split(x_re, x_im, plan)
        r = tt.ifft_split(f_re, f_im, plan)
        torch.cuda.synchronize()
        expect(f"{label} gate", before, want)
        d = deviation((f_re.double().cpu().numpy(), f_im.double().cpu().numpy()),
                      fft_oracle(re64, im64))
        rt = roundtrip(r, (x_re, x_im), torch.bfloat16)
        ok = d.passes_reference_gate() and rt <= ROUNDTRIP_TOL["bfloat16"]
        log(f"[tuned gate] bfloat16 N={n_t} rows={len(sig)} {label} "
            f"({plan.resolve_strategy().value}, {plan.engine}): {d} "
            f"roundtrip_rel={rt:.3e} {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"tuned accuracy gate failed at {label}")
    del sig, re64, im64, x_re, x_im, f_re, f_im, r
    torch.cuda.synchronize()

    # -- tpu_tuned: the JAX package's TPU-tuned plans, counted, held, gated --
    log(f"[phase] tpu_tuned path from {time.perf_counter() - t_start:.1f} s")
    tpu_jobs = {}  # what timing needs per variant, at the first shape that ran it

    def tpu_job(name, shape, call, plain, args, io_bytes, tables,
                ops, library=None):
        """Register the timing of ``name``, a variant the tpu_tuned or bign
        path adds, at ``shape``: ``tables`` the table_bytes arguments of its
        pass, ``library`` a function giving (torch call, args)."""
        if name not in TPU_KERNELS and name not in BIGN_KERNELS:
            return
        key = name if name not in tpu_jobs else f"{name} {shape}"
        tpu_jobs.setdefault(key, dict(name=name, shape=shape, call=call,
                                      plain=plain, args=args, io_bytes=io_bytes,
                                      tables=tables, ops=ops, library=library))

    def axis_fft(x, dim=-1):
        """The one call for ``tpu_job``: torch.fft.fft along ``dim`` of the
        planes ``x`` as complex64, built when timed."""
        return lambda: (lambda v: torch.fft.fft(v, dim=dim),
                        (torch.complex(x[0].float(), x[1].float()),))

    def tpu_plan(route, n_t, precision, tuning):
        layout = "batch_major" if route == "batch_major" else None
        return tt.create_plan(n_t // 2 if route == "r2c" else n_t,
                              precision=precision, tuning=tuning,
                              fused_layout=layout)

    def tpu_forward_inverse(route, plan, x, tuning):
        if route == "r2c":
            spec = tt.rfft_split(x[0], plan)
            return spec, (tt.irfft_split(*spec, plan),)
        if route == "fftn":  # the inner plans read the cache ("auto")
            spec = tt.fftn_split(*x, axes=(-2, -1))
            return spec, tt.ifftn_split(*spec, axes=(-2, -1))
        if tuning == "auto":
            layout = "batch_major" if route == "batch_major" else "auto"
            spec = tt.fft_split(*x, tuning="auto", fused_layout=layout)
            return spec, tt.ifft_split(*spec, tuning="auto", fused_layout=layout)
        spec = tt.fft_split(*x, plan)
        return spec, tt.ifft_split(*spec, plan)

    def state_of(plan):
        """The state dtype the plan's passes run (narrow-panel rule)."""
        if plan.four_step_split is None:
            return plan.state_dtype
        return effective_state_dtype(plan.state_dtype, *plan.four_step_split,
                                     plan.lane_tile, plan.k1_tile)

    def hold_fused(label, route, plan, x, spec, precision):
        kw = dict(fused_kw(plan), grouped=plan.grouped,
                  complex_mult=plan.complex_mult, state_dtype=plan.state_dtype)
        fn = (four_step_cuda.fused_fft_batch_major if route == "batch_major"
              else fused_cuda.fused_fft)
        rows = slice(0, min(x[0].shape[0], TPU_HOLD_ROWS))
        name, _ = named(lambda: fn(*(t[rows] for t in x), **kw))
        b, n = x[0].shape
        hold(name, f"{label} x B={b}, main path rows {rows.start}..{rows.stop - 1}",
             [t[rows] for t in spec],
             fused_cuda.fused_fft_reference(*(t[rows] for t in x), round_input=True,
                                            **kw),
             **tol(precision, plan.state_dtype, n > 16384))
        item = x[0].element_size()
        tpu_job(name, f"N={n} x B={b} {precision}",
                lambda r, i: fn(r, i, **kw),
                lambda r, i: fused_cuda.fused_fft_reference(r, i, round_input=True,
                                                            **kw),
                x, 4 * item * n * b,
                [(plan, plan.radices, kw["scales"], -1)],
                pass_flops(plan, plan.radices, n * b), axis_fft(x))

    def pq_bytes(col):
        t = min(col["lane_tile"], col["n2"])
        return 2 * 4 * (col["n1"] * col["n2"] // t + col["n1"] * t)

    def hold_passes(label, plan, x, precision, shape, col_call, col_ref, row_call,
                    row_ref, col, row, elems, col_first_dot=None, library=False,
                    whole=None):
        """Hold a column pass on ``x`` and a row pass on the plain column
        pass's output against their plain versions; register both, with
        ``torch.fft.fft`` along each pass's axis as its one call where
        ``library`` (the K4 passes), else ``whole`` (the whole transform's
        one call, for both passes of a four-step pair)."""
        t = tol(precision, col["state_dtype"], True)
        # At 2^27 the hold is on a slice: the first BIGN_HOLD_ELEMS of each
        # plane of the outputs (the plain versions run whole on the card).
        keep = BIGN_HOLD_ELEMS if elems > BIGN_SLICE_ABOVE else elems
        cut = (lambda ts: [v.reshape(-1)[:keep]
                           for v in (ts if isinstance(ts, tuple) else [ts])])
        where = f"{label}, first {keep} elements" if keep < elems else label
        name_c, mid = named(lambda: col_call(*x, **col))
        mid_plain = col_ref(*x, **col)
        hold(name_c, where, cut(mid), cut(mid_plain), **t)
        del mid
        name_r, out = named(lambda: row_call(*mid_plain, **row))
        want = row_ref(*mid_plain, **row)
        hold(name_r, where, cut(out), cut(want), **t)
        del out, want
        item = x[0].element_size()
        radices_c = col.get("radices1")
        tpu_job(name_c, shape, lambda *a: col_call(*a, **col),
                lambda *a: col_ref(*a, **col), x,
                4 * item * elems + (pq_bytes(col) if "lane_tile" in col else 0),
                [(plan, radices_c, col["scales1"], col["sign"], col_first_dot)],
                pass_flops(plan, radices_c, elems, col_first_dot),
                axis_fft(x, -2) if library else whole)
        tpu_job(name_r, shape, lambda *a: row_call(*a, **row),
                lambda *a: row_ref(*a, **row), mid_plain, 4 * item * elems,
                [(plan, row["radices2"], row["scales2"], row["sign"], col_first_dot)],
                pass_flops(plan, row["radices2"], elems, col_first_dot),
                axis_fft(mid_plain, -1) if library else whole)
        return mid_plain

    def hold_r2c_fused(label, plan, x, spec, precision):
        """The fused R2C route: kernel A on the packed rows (a slice), K9 on
        its output, K10 on the main path's spectrum, K7 and K8 bit for
        bit."""
        b, n = x[0].shape
        rows = slice(0, min(b, TPU_HOLD_ROWS))
        z = rfft_cuda.pack_split(x[0][rows])
        bitwise("pack_split", label, z, rfft_cuda.pack_split_reference(x[0][rows]))
        zf = tt.fft_split(*z, plan)
        hold_fused(label, "c2c", plan, z, zf, precision)
        fs = float(_output_scale(plan, True))
        name, got = named(lambda: rfft_cuda.untangle_fwd(*zf, n=n, scale=fs))
        bitwise(name, label, got, rfft_cuda.untangle_fwd_reference(*zf, n=n, scale=fs))
        inv = dict(n=n, scale=float(_inverse_pre_scale(plan)),
                   out_dtype=plan.precision.storage_dtype)
        s_rows = [t[rows] for t in spec]
        name, zi = named(lambda: rfft_cuda.retangle_inv(*s_rows, **inv))
        bitwise(name, label, zi, rfft_cuda.retangle_inv_reference(*s_rows, **inv))
        o = tt.ifft_split(*zi, plan)
        bitwise("interleave_split", label, [rfft_cuda.interleave_split(*o)],
                [rfft_cuda.interleave_split_reference(*o)])

    def tpu_holds(label, route, plan, x, spec, precision):
        """Each kernel of one call against its plain version on the card."""
        if route == "fftn":
            k4 = dict(sign=-1, algorithm=plan.precision.dot_algorithm,
                      engine=plan.engine, grouped=plan.grouped,
                      complex_mult=plan.complex_mult, state_dtype=plan.state_dtype)
            scales = stage_scales(plan.radices, plan.scaling, True)
            n = plan.fft_length
            hold_passes(label, plan, tuple(p.reshape(1, n, n) for p in x), precision,
                        f"{n}x{n} {precision}", four_step_cuda.fft2_column_pass,
                        four_step_cuda.fft2_column_pass_reference,
                        four_step_cuda.fft2_row_pass,
                        four_step_cuda.fft2_row_pass_reference,
                        dict(radices1=plan.radices, scales1=scales, **k4),
                        dict(radices2=plan.radices, scales2=scales, **k4), n * n,
                        "default", library=True)
            return
        if plan.four_step_split is None and route == "r2c":
            hold_r2c_fused(label, plan, x, spec, precision)
            return
        if plan.four_step_split is None:
            hold_fused(label, route, plan, x, spec, precision)
            return
        kw, _, col, row = pass_kwargs(plan, True)
        b, n = x[0].shape
        shape = f"N={n} x B={b} {precision}"
        if route == "c2c":
            hold_passes(label, plan, x, precision, shape, four_step_cuda.column_pass,
                        four_step_cuda.column_pass_reference, four_step_cuda.row_pass,
                        four_step_cuda.row_pass_reference, col, row, n * b,
                        whole=axis_fft(x))
            return
        # R2C: K5 (the packed column pass, then kernel C), untangle; the
        # inverse's retangle, kernel B (K6g under gridslice) and K6.
        m = plan.fft_length
        shape = f"real N={n} x B={b} {precision}"
        k5_engine = four_step_cuda.pass_engine(plan.engine, col["radices1"],
                                               plan.grouped, gridslice=False)
        hold_passes(label, plan, x, precision, shape, four_step_cuda.column_pass_packed,
                    four_step_cuda.column_pass_packed_reference, four_step_cuda.row_pass,
                    four_step_cuda.row_pass_reference, dict(col, engine=k5_engine),
                    dict(row, engine=k5_engine), m * b,
                    whole=lambda: (lambda v: torch.fft.rfft(v, dim=-1), (x[0].float(),)))
        fs = float(_output_scale(plan, True))
        z_fwd = four_step_cuda.four_step_fft_packed_real(x[0], **kw)
        name, got = named(lambda: rfft_cuda.untangle_fwd(*z_fwd, n=n, scale=fs))
        bitwise(name, label, got, rfft_cuda.untangle_fwd_reference(*z_fwd, n=n, scale=fs))
        inv = dict(n=n, scale=float(_inverse_pre_scale(plan)),
                   out_dtype=plan.precision.storage_dtype)
        name, z = named(lambda: rfft_cuda.retangle_inv(*spec, **inv))
        bitwise(name, label, z, rfft_cuda.retangle_inv_reference(*spec, **inv))
        _, _, inv_col, inv_row = pass_kwargs(plan, False)
        hold_passes(label, plan, z, precision, shape, four_step_cuda.column_pass,
                    four_step_cuda.column_pass_reference,
                    four_step_cuda.row_pass_interleave,
                    four_step_cuda.row_pass_interleave_reference, inv_col, inv_row,
                    m * b, whole=lambda: (lambda v: torch.fft.irfft(v, n=n, dim=-1),
                                          (torch.complex(spec[0].float(),
                                                         spec[1].float()),)))

    def tpu_bitwise(label, route, plan, x, spec, back):
        """The call's output equals the stacked engine's (grouping off
        under pretwiddle) bit for bit, forward and inverse."""
        stacked = dataclasses.replace(
            plan, engine="stacked", grouped=plan.grouped and plan.engine != "pretwiddle")
        if route == "r2c":
            pairs = [(spec, tt.rfft_split(x[0], stacked)),
                     (back, (tt.irfft_split(*spec, stacked),))]
        else:
            pairs = [(spec, tt.fft_split(*x, stacked)),
                     (back, tt.ifft_split(*spec, stacked))]
        for got, want in pairs:
            for g, s in zip(got, want):
                if g.dtype != s.dtype or not torch.equal(g, s):
                    raise RuntimeError(f"{label} ({plan.engine}) differs from the "
                                       f"stacked engine")
        log(f"[tpu_tuned] {label}: {plan.engine} bit-identical to stacked "
            f"(forward and inverse)")

    def tpu_gate(label, route, plan, want):
        """The reference gate and round trip through the same kernels."""
        n_t = plan.fft_length * (2 if route == "r2c" else 1)
        precision = plan.precision.value
        storage = plan.precision.storage_dtype
        rt_tol = ROUNDTRIP_TOL["bfloat16" if state_of(plan) == "bfloat16" else precision]
        # The gate's few rows (at most SMs) run kernel A one CTA a row.
        want = {k.replace("pipelined,", ""): c for k, c in want.items()}
        before = launch_counts()
        if route == "fftn":
            re64, im64, x_re, x_im = nd_signal((n_t, n_t))
            f = tt.fftn_split(x_re, x_im, axes=(-2, -1))
            r = tt.ifftn_split(*f, axes=(-2, -1))
            oracle = np.fft.fft2(re64 + 1j * im64) / (n_t * n_t)
            oracle = (oracle.real, oracle.imag)
            x = (x_re, x_im)
        elif route == "r2c":
            x64 = np.stack(make_test_signal(n_t, 42, 42 * 42))  # 2 real rows
            x = (torch.from_numpy(x64).to(dev),)
            f = tt.rfft_split(x[0], plan)
            r = (tt.irfft_split(*f, plan),)
            oracle = np.fft.rfft(x64, axis=-1) / n_t
            oracle = (oracle.real, oracle.imag)
        elif n_t >= 1 << 26:
            x, oracle = sine_signal(n_t)
            f = tt.fft_split(*x, plan)
            r = tt.ifft_split(*f, plan)
        else:
            sig = [make_test_signal(n_t, 42 * s, 42 * 42 * s)
                   for s in range(1, 3 if n_t > 16384 else 9)]
            planes = [np.stack([p[i] for p in sig]) for i in range(2)]
            x = tuple(torch.from_numpy(p).to(dev) for p in planes)
            f = tt.fft_split(*x, plan)
            r = tt.ifft_split(*f, plan)
            oracle = fft_oracle(*planes)
        torch.cuda.synchronize()
        expect(f"{label} gate", before, want)
        d = deviation((f[0].double().cpu().numpy(), f[1].double().cpu().numpy()),
                      oracle)
        rt = roundtrip(r, x, storage)
        ok = d.passes_reference_gate() and rt <= rt_tol
        log(f"[{path_of[label]} gate] {precision} {label} rows={x[0].shape[0]}: {d} "
            f"roundtrip_rel={rt:.3e} (bound {rt_tol:g}) {'PASS' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{path_of[label]} accuracy gate failed at {label}")

    path_of = {}  # call label -> its path

    def knob_path(path, calls, entries, seed, make=inputs):
        """Drive ``calls`` (TPU_CALLS' format) through the public entry
        points, counted as ``path`` (a tuner cache holding ``entries`` open
        for ``tuning="auto"``), each call launching exactly its variants, on
        inputs from ``make``; then per call its finite outputs, round trip,
        holds against the plain versions, bitwise checks and gate.  Returns
        the plans and inputs."""
        ins, plans = {}, {}
        for i, (label, route, n_t, b_t, precision, _, _) in enumerate(calls):
            path_of[label] = path
            storage = torch.bfloat16 if precision == "bfloat16" else torch.float32
            if route == "r2c":
                ins[label] = make(n_t, b_t, storage, seed + i, planes=1)
            elif route == "fftn":
                ins[label] = tuple(p.reshape(n_t, n_t) for p in
                                   make(n_t * n_t, 1, storage, seed + i))
            else:
                ins[label] = make(n_t, b_t, storage, seed + i)

        def drive():
            out = {}
            for label, route, _, _, _, tuning, want in calls:
                before = launch_counts()
                out[label] = tpu_forward_inverse(route, plans[label], ins[label],
                                                 tuning)
                torch.cuda.synchronize()
                expect(label, before, want)
            return out

        with (tuner_cache(entries, path) if entries else contextlib.nullcontext()):
            for label, route, n_t, _, precision, tuning, _ in calls:
                plans[label] = plan = tpu_plan(route, n_t, precision, tuning)
                ok, why = tt.plan_works_on_device(plan, "cuda")
                log(f"[{path}] {label}: {plan.resolve_strategy().value} radices "
                    f"{plan.radices} split {plan.four_step_split} col "
                    f"{plan.col_radices} row {plan.row_radices} engine "
                    f"{plan.engine} grouped {plan.grouped} complex_mult "
                    f"{plan.complex_mult} state {plan.state_dtype} (in effect "
                    f"{state_of(plan)}) first_dot {plan.first_dot} lane_tile "
                    f"{plan.lane_tile} k1_tile {plan.k1_tile}; works on cuda: "
                    f"{ok} ({why})")
                if not ok:
                    raise RuntimeError(f"{path} plan {label} refused: {why}")
            log(f"[{path}] inputs and plans at {time.perf_counter() - t_start:.1f} s")
            outs = counted(path, sorted({k for *_, want in calls for k in want}),
                           drive)
            for label, route, n_t, b_t, precision, _, want in calls:
                plan, x = plans[label], ins[label]
                spec, back = outs.pop(label)
                shape = ((b_t, n_t // 2 + 1) if route == "r2c" else x[0].shape)
                finite(f"{path} {label}", spec, shape, x[0].dtype)
                finite(f"{path} {label}", back, x[0].shape, x[0].dtype)
                rt_tol = ROUNDTRIP_TOL["bfloat16" if state_of(plan) == "bfloat16"
                                       else precision]
                rt = roundtrip(back, x, plan.precision.storage_dtype)
                log(f"[{path}] {label} main path roundtrip_rel={rt:.3e} "
                    f"(bound {rt_tol:g}; at {time.perf_counter() - t_start:.1f} s)")
                if rt > rt_tol:
                    raise RuntimeError(f"{path} {label}: round trip off by {rt:.3e}")
                tpu_holds(label, route, plan, x, spec, precision)
                if label in TPU_BITWISE:
                    tpu_bitwise(label, route, plan, x, spec, back)
                del spec, back
                tpu_gate(label, route, plan, want)
        torch.cuda.synchronize()
        return plans, ins

    knob_path("tpu_tuned", TPU_CALLS, {4096: TPU_ENTRIES[4096]}, SEED + 31)

    # -- bign: plans past one CTA, on thread-block clusters -----------------
    log(f"[phase] bign path from {time.perf_counter() - t_start:.1f} s")
    bign_plans, bign_in = knob_path("bign", BIGN_CALLS, {}, SEED + 61,
                                    device_inputs)
    # The cluster mode alone: a row one CTA holds, forced onto a cluster
    # through the private launchers, equals the one-CTA tensor-core kernel
    # bit for bit (kernel A on 2 and 4 CTAs, K3 and kernel C on 2).  The
    # plain-torch kernel A (another summation order) is held at the fused
    # bound, one-CTA K4c (tensor cores, columns over the rows viewed as
    # (B, N, 1)) at the four-step one.
    def same_bits(label, got, want):
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise RuntimeError(f"{label}: not bit-identical")
        log(f"[bign] {label}: bit-identical")

    x16 = inputs(16384, 256, torch.bfloat16, SEED + 60)
    r16 = (128, 128)
    s16 = stage_scales(r16, "forward", True)
    kw16 = dict(radices=r16, scales=s16, sign=-1, algorithm="bf16",
                first_dot="default", engine="stacked", grouped=False,
                complex_mult="block", state_dtype="float32")
    one16 = fused_cuda._launch_fused(*x16, cluster=1, **kw16)
    cl16 = fused_cuda._launch_fused(*x16, cluster=2, **kw16)
    same_bits("kernel A, N=16384 x B=256 on 2 CTAs vs one CTA", cl16, one16)
    same_bits("kernel A, N=16384 x B=256 on 4 CTAs vs one CTA",
              fused_cuda._launch_fused(*x16, cluster=4, **kw16), one16)
    knobs16 = four_step_cuda._knobs("stacked", False, "block", "float32")
    k3_16 = dict(radices=r16, scales=s16, sign=-1, algorithm="bf16",
                 first_dot="default", knobs=knobs16)
    same_bits("K3, N=16384 x B=256 on 2 CTAs vs one CTA",
              four_step_cuda._launch_batch_major(*x16, cluster=2, **k3_16),
              four_step_cuda._launch_batch_major(*x16, **k3_16))
    mid16 = tuple(t.reshape(16, 16 * 16384) for t in x16)
    row16 = dict(n1=16, n2=16384, radices2=r16, scales2=s16, sign=-1,
                 algorithm="bf16", first_dot="default", knobs=knobs16)
    same_bits("kernel C, n1=16 x n2=16384 x B=16 on 2 CTAs vs one CTA",
              four_step_cuda._launch_row_pass(*mid16, cluster=2, **row16),
              four_step_cuda._launch_row_pass(*mid16, **row16))
    # Kernel B, K4's column pass and K5 over 256 columns of 16384 points,
    # forced onto every (lanes, cluster) that holds them.
    b16 = tuple(t.reshape(1, -1) for t in x16)
    cp16 = dict(n1=16384, n2=256, radices1=r16, scales1=s16, sign=-1,
                algorithm="bf16", first_dot="default", knobs=knobs16)
    for what, src, lane_tile in (
            ("kernel B", b16, 128),
            ("K4c", tuple(t.reshape(1, 16384, 256) for t in x16), None),
            ("K5", (torch.stack(b16, -1).reshape(1, -1),), 128)):
        one = four_step_cuda._launch_col_pass(src, lane_tile=lane_tile, **cp16)
        for lanes, cluster in [(t, c) for c in (2, 4, 8) for t in (1, 2, 4, 8)
                               if t <= c]:
            same_bits(f"{what}, n1=16384 x n2=256 on {lanes} columns x {cluster} "
                      f"CTAs vs one CTA",
                      four_step_cuda._launch_col_pass(
                          src, lane_tile=lane_tile, cluster=cluster, lanes=lanes,
                          **cp16), one)
        del one
    cols16 = tuple(t.reshape(256, 16384, 1) for t in x16)
    k4c16 = dict(radices1=r16, scales1=s16, sign=-1, algorithm="bf16")
    plain16 = fused_cuda.fused_fft_reference(*x16, **kw16)
    a16 = agreement([c.float().cpu() for c in cl16],
                    [t.float().cpu() for t in plain16], bf16=True)
    log(f"[bign] N=16384 x B=256 on 2 CTAs vs the plain-torch kernel A: {a16}")
    if not a16.within(FUSED_MAX_FRAC):
        raise RuntimeError(f"kernel A on 2 CTAs and its plain version disagree: {a16}")
    c16 = agreement([c.float().cpu() for c in cl16],
                    [t.reshape(256, 16384).float().cpu()
                     for t in four_step_cuda.fft2_column_pass(*cols16, **k4c16)],
                    bf16=True)
    log(f"[bign] N=16384 x B=256 on 2 CTAs vs one-CTA K4c over (B, N, 1) "
        f"(tensor cores): {c16}")
    if not c16.within(FOUR_STEP_MAX_FRAC):
        raise RuntimeError(f"kernel A on 2 CTAs and one-CTA K4c disagree: {c16}")
    del x16, one16, cl16, mid16, plain16, b16
    # Past a cluster of 8 CTAs a plan is refused, before any launch.
    big = tt.create_plan(1 << 18, max_fused_length=1 << 18)
    ok, why = tt.plan_works_on_device(big, "cuda")
    before = launch_counts()
    try:
        tt.fft_split(*inputs(1 << 18, 1, torch.bfloat16, SEED + 59), big)
        refused = False
    except ValueError:
        refused = True
    log(f"[bign] N=2^18 fused: works on cuda {ok} ({why}); fft_split raises "
        f"ValueError: {refused}")
    if ok or not refused or launch_counts() != before:
        raise RuntimeError("a plan past 8 CTAs must be refused with no launch")
    torch.cuda.synchronize()

    # -- 5. timing ---------------------------------------------------------
    log(f"[phase] timing from {time.perf_counter() - t_start:.1f} s")
    log(f"[card] {smi}; shares against the {H100.kind} data sheet: "
        f"{H100.fp32_flops / 1e12:g} TFLOP/s fp32, "
        f"{H100.bf16_flops / 1e12:g} TFLOP/s bf16, "
        f"{H100.hbm_bandwidth / 1e12:g} TB/s HBM")

    def shares(plan, b, ms):
        flops, nbytes = kernel_work(plan, b)
        return (f"fp32 share {flops / (H100.fp32_flops * ms / 1e3):.1%}, "
                f"HBM share {nbytes / (H100.hbm_bandwidth * ms / 1e3):.1%}")

    def bound(nbytes, ops, peak):
        """(least ms the card could take, what bounds it)."""
        t_bytes = nbytes / H100.hbm_bandwidth * 1e3
        t_ops = ops / peak * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def table_bytes(plan, radices, scales, sign, first_dot=None, mma=False):
        """Bytes of one pass's tables (folded slices included): fp32, or
        under ``mma`` (the tensor-core engine) the matrices in bf16 and the
        twiddles in fp32."""
        tables, meta = fused_cuda.kernel_tables(
            tuple(radices), tuple(map(float, scales)), int(sign),
            plan.precision.dot_algorithm,
            plan.first_dot if first_dot is None else first_dot, dev,
            plan.engine, plan.grouped, plan.complex_mult)
        if not mma:
            return tables.numel() * 4
        twiddles, k = 0, 1
        for st in range(int(meta[0])):
            r = int(meta[1 + 4 * st])
            twiddles += 2 * r * k if meta[4 + 4 * st] else 0
            k *= r
        return (tables.numel() - twiddles) * 2 + twiddles * 4

    timing = {}  # name -> dict(ms, plain_ms, library_ms, bound_ms, bound_by, shape)

    kernel_ms = {}
    for label, (plan, re_, im_) in data.items():
        n, b = plan.fft_length, re_.shape[0]
        flops = 5.0 * n * math.log2(n) * b
        if plan.resolve_strategy() is tt.Strategy.FUSED:
            kwargs = dict(radices=plan.radices,
                          scales=stage_scales(plan.radices, plan.scaling, True),
                          algorithm=plan.precision.dot_algorithm,
                          first_dot=plan.first_dot)
            plain_fn = lambda r, i, kw=kwargs: fused_cuda.fused_fft_reference(r, i, **kw)
        else:
            kw = four_step_call_kwargs(plan, True)
            kwargs = {k: kw[k] for k in ("n1", "n2", "radices1", "radices2",
                                         "scales1", "scales2", "sign",
                                         "lane_tile", "algorithm", "first_dot")}
            plain_fn = lambda r, i, kw=kwargs: four_step_cuda.four_step_fft_reference(r, i, **kw)
        x_c = torch.complex(re_.float(), im_.float())
        # plain, kernel, kernel, plain: compare within one call, in turns.
        t_plain = measure(plain_fn, (re_, im_), iters=5)
        t_kern = measure(lambda r, i: tt.fft_split(r, i, plan), (re_, im_), iters=10)
        t_kern2 = measure(lambda r, i: tt.fft_split(r, i, plan), (re_, im_), iters=10)
        t_plain2 = measure(plain_fn, (re_, im_), iters=5)
        t_cufft = measure(lambda x: torch.fft.fft(x, dim=-1), (x_c,), iters=10)
        k_ms = min(t_kern.average_time_ms, t_kern2.average_time_ms)
        p_ms = min(t_plain.average_time_ms, t_plain2.average_time_ms)
        c_ms = t_cufft.average_time_ms
        log(f"[time] {label} N={n} B={b} bf16: kernel {k_ms:.4f} ms "
            f"({flops / k_ms / 1e6:.1f} GFLOP/s; runs {t_kern.average_time_ms:.4f}, "
            f"{t_kern2.average_time_ms:.4f}) | plain {p_ms:.4f} ms "
            f"({flops / p_ms / 1e6:.1f}) | torch.fft c64 {c_ms:.4f} ms "
            f"({flops / c_ms / 1e6:.1f}) | kernel {shares(plan, b, k_ms)} | {smi}")
        item = plan.precision.storage_dtype.itemsize
        elems = n * b
        if plan.resolve_strategy() is tt.Strategy.FUSED:
            if label == "bench-headline":
                nbytes = 4 * item * elems + table_bytes(
                    plan, plan.radices, kwargs["scales"], -1, mma=True)
                b_ms, b_by = bound(nbytes, pass_flops(plan, plan.radices, elems),
                                   H100.bf16_flops)
                # Kernel A on both paths, in turns: one CTA a row, pipelined,
                # pipelined, one CTA a row.
                a_kw = dict(kwargs, sign=-1, engine="stacked", grouped=False,
                            complex_mult="block", state_dtype="float32")
                paths = {"fused_fft[mma]": False, "fused_fft[pipelined,mma]": None}
                runs = {name: [] for name in paths}
                for name in (*paths, *reversed(paths)):
                    runs[name].append(measure(
                        lambda r, i, p=paths[name]: fused_cuda._launch_fused(
                            r, i, pipelined=p, **a_kw),
                        (re_, im_), iters=10).average_time_ms)
                for name, ms in runs.items():
                    timing[name] = dict(ms=min(ms), plain_ms=p_ms, library_ms=c_ms,
                                        bound_ms=b_ms, bound_by=b_by,
                                        shape=f"N={n} x B={b} bf16")
                    log(f"[time] kernel A {name} N={n} B={b} bf16: {min(ms):.4f} ms "
                        f"(runs {', '.join(f'{t:.4f}' for t in ms)}) | bound "
                        f"{b_ms:.4f} ms ({b_by}) | {b_ms / min(ms):.1%} of bound | {smi}")
            continue
        # Each four-step pass alone, on the same inputs.
        col = {k: kwargs[k] for k in ("n1", "n2", "radices1", "scales1", "sign",
                                      "lane_tile", "algorithm", "first_dot")}
        row = {k: kwargs[k] for k in ("n1", "n2", "radices2", "scales2", "sign",
                                      "algorithm", "first_dot")}
        mid = four_step_cuda.column_pass(re_, im_, **col)
        pq = 2 * 4 * (kwargs["n1"] * kwargs["n2"] // min(kwargs["lane_tile"], kwargs["n2"])
                      + kwargs["n1"] * min(kwargs["lane_tile"], kwargs["n2"]))
        for name, fn, ref, args, kw_pass, radices, scales, extra in (
                ("four_step_col[mma]", four_step_cuda.column_pass,
                 four_step_cuda.column_pass_reference, (re_, im_), col,
                 kwargs["radices1"], kwargs["scales1"], pq),
                ("four_step_row[mma]", four_step_cuda.row_pass,
                 four_step_cuda.row_pass_reference, mid, row,
                 kwargs["radices2"], kwargs["scales2"], 0)):
            tk = measure(lambda r, i: fn(r, i, **kw_pass), args, iters=10)
            tp = measure(lambda r, i: ref(r, i, **kw_pass), args, iters=5)
            kernel_ms[name] = (tk.average_time_ms, tp.average_time_ms)
            nbytes = 4 * item * elems + extra + table_bytes(plan, radices, scales, -1,
                                                            mma=True)
            b_ms, b_by = bound(nbytes, pass_flops(plan, radices, elems), H100.bf16_flops)
            # The pass's one call: the whole transform's torch.fft.fft.
            timing[name] = dict(ms=tk.average_time_ms, plain_ms=tp.average_time_ms,
                                library_ms=c_ms, bound_ms=b_ms, bound_by=b_by,
                                shape=f"N={n} x B={b} bf16")
            log(f"[time] {name} N={n} B={b}: kernel {tk.average_time_ms:.4f} ms "
                f"| plain {tp.average_time_ms:.4f} ms | bound {b_ms:.4f} ms "
                f"({b_by}) | {smi}")

    # Kernel A's pipelined kernel on tiles of short rows, in turns with one
    # CTA a row, a row a step, the half tile and (at the grid's rows) K3;
    # every output equal to one CTA a row's bit for bit.
    log(f"[phase] kernel A tiles from {time.perf_counter() - t_start:.1f} s")
    for n, b in TILE_SHAPES:
        plan = tt.create_plan(n)
        a_kw = dict(radices=plan.radices, sign=-1,
                    scales=stage_scales(plan.radices, plan.scaling, True),
                    algorithm=plan.precision.dot_algorithm, first_dot=plan.first_dot,
                    engine="stacked", grouped=False, complex_mult="block",
                    state_dtype="float32")
        x = device_inputs(n, b, torch.bfloat16, SEED + n + b)
        rule = kernel_a(n, b)
        paths = {"fused_fft[mma]": dict(pipelined=False),
                 "fused_fft[pipelined,mma]": dict(pipelined=True, tile=1)}
        tiles = {fused_cuda.MAX_CTA_ELEMS // n, fused_cuda.MAX_CTA_ELEMS // 2 // n,
                 fused_cuda.pipeline_tile(n, b, sms)}
        for tile in sorted(tiles - {0, 1}, reverse=True):
            paths[kernel_a(n, b, tile)] = dict(pipelined=True, tile=tile)
        fns = {name: (lambda r, i, o=o: fused_cuda._launch_fused(r, i, **o, **a_kw))
               for name, o in paths.items()}
        rules, grid = {rule}, None
        if (n, b) == (ND_VOLUME[0], math.prod(ND_VOLUME[1:])):
            fns["K3 fused_fft_batch_major[mma]"] = (
                lambda r, i: four_step_cuda.fused_fft_batch_major(r, i, **a_kw))
            # The grid's axis-0 pass as the N-D loop runs it: from the
            # (N, B) grid, the relayout's copy then the rule's tiles, or the
            # tiles landed straight from the grid (T = 16, the rule's, and
            # T = 32).
            grid = [p.t().contiguous() for p in x]
            fns["relayout + fused_fft[pipelined,tile16,mma]"] = (
                lambda r, i: fused_cuda._launch_fused(
                    *(p.movedim(0, -1).contiguous() for p in grid),
                    pipelined=True, tile=16, **a_kw))
            for tile in (16, 32):
                fns[f"fused_fft_cols[pipelined,tile{tile},cols,mma]"] = (
                    lambda r, i, t=tile: fused_cuda.fused_fft_columns(
                        *grid, 0, tile=t, **a_kw))
            rules.add("fused_fft_cols[pipelined,tile16,cols,mma]")
        want = fns["fused_fft[mma]"](*x)
        for name, fn in fns.items():
            bitwise(name, f"N={n} x B={b} (against one CTA a row)", fn(*x), want)
        del want
        runs = {name: [] for name in fns}
        for name in (*fns, *reversed(fns)):
            runs[name].append(measure(fns[name], x, iters=10).average_time_ms)
        plain_kw = {k: a_kw[k] for k in ("radices", "scales", "sign", "algorithm",
                                         "first_dot")}
        p_ms = measure(lambda r, i: fused_cuda.fused_fft_reference(r, i, **plain_kw),
                       x, iters=3).average_time_ms
        x_c = torch.complex(x[0].float(), x[1].float())
        c_ms = measure(lambda v: torch.fft.fft(v, dim=-1), (x_c,), iters=10).average_time_ms
        del x_c
        b_ms, b_by = bound(4 * 2 * n * b + table_bytes(plan, plan.radices,
                                                       a_kw["scales"], -1, mma=True),
                           pass_flops(plan, plan.radices, n * b), H100.bf16_flops)
        for name, ms in runs.items():
            log(f"[time] kernel A tiles N={n} x B={b} first_dot={plan.first_dot} {name}: "
                f"{min(ms):.4f} ms (runs {', '.join(f'{v:.4f}' for v in ms)}) | bound "
                f"{b_ms:.4f} ms ({b_by}) | {b_ms / min(ms):.1%} of bound | plain "
                f"{p_ms:.4f} ms | torch.fft c64 {c_ms:.4f} ms"
                f"{' | the rule' if name in rules else ''} | {smi}")
            if name in KERNELS and name not in timing and name in rules:
                timing[name] = dict(ms=min(ms), plain_ms=p_ms, library_ms=c_ms,
                                    bound_ms=b_ms, bound_by=b_by,
                                    shape=f"N={n} x B={b} bf16 first_dot={plan.first_dot}")
        del x, fns, grid
        torch.cuda.empty_cache()

    # The float32 policy at the headline shape (kernel A, bf16x3).
    plan32 = tt.create_plan(16384, precision="float32")
    r32, i32 = inputs(16384, 4096, torch.float32, SEED + 1)
    t32 = measure(lambda r, i: tt.fft_split(r, i, plan32), (r32, i32), iters=5)
    flops = 5.0 * 16384 * 14 * 4096
    log(f"[time] float32 policy N=16384 B=4096: kernel "
        f"{t32.average_time_ms:.4f} ms ({flops / t32.average_time_ms / 1e6:.1f} "
        f"GFLOP/s) | {shares(plan32, 4096, t32.average_time_ms)} | {smi}")
    del r32, i32

    # The R2C kernels at both main-path shapes, each call on a cold L2.
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def time_r2c(name, label, fn, plain, library, args, nbytes, ops, peak):
        tp1 = measure(plain, args, iters=5, flush=flush)
        tk1 = measure(fn, args, iters=20, flush=flush)
        tk2 = measure(fn, args, iters=20, flush=flush)
        tp2 = measure(plain, args, iters=5, flush=flush)
        k_ms = min(tk1.average_time_ms, tk2.average_time_ms)
        p_ms = min(tp1.average_time_ms, tp2.average_time_ms)
        l_ms = (measure(library, args, iters=20, flush=flush).average_time_ms
                if library is not None else None)
        b_ms, b_by = bound(nbytes, ops, peak)
        log(f"[time] {name} {R2C_SHAPE[label]}: kernel {k_ms:.4f} ms (runs "
            f"{tk1.average_time_ms:.4f}, {tk2.average_time_ms:.4f}) | plain "
            f"{p_ms:.4f} ms | library "
            f"{'none' if l_ms is None else f'{l_ms:.4f} ms'} | bound "
            f"{b_ms:.4f} ms ({b_by}) | {b_ms / k_ms:.1%} of bound | {smi}")
        # The JSON line keeps config 4's shape for the kernels that route
        # runs, the fused route's for pack and interleave; PERF.md has both.
        if name not in timing or (label == "r2c-config4" and name not in
                                  ("pack_split", "interleave_split")):
            timing[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                shape=R2C_SHAPE[label])

    def time_untangle_pair(label, n, b, fs, inv, Z, spec):
        """K9 on Z and K10 on spec, bf16 (B, N/2) and (B, N/2 + 1) planes."""
        m, s = n // 2, 2  # bf16 bytes
        table = 2 * 4 * m
        time_r2c("untangle_fwd", label,
                 lambda r, i: rfft_cuda.untangle_fwd(r, i, n=n, scale=fs),
                 lambda r, i: rfft_cuda.untangle_fwd_reference(r, i, n=n, scale=fs),
                 None, Z, 2 * s * b * m + table + 2 * s * b * (m + 1),
                 UNTANGLE_OPS * b * m, H100.fp32_flops)
        time_r2c("retangle_inv", label,
                 lambda r, i: rfft_cuda.retangle_inv(r, i, **inv),
                 lambda r, i: rfft_cuda.retangle_inv_reference(r, i, **inv),
                 None, spec, 2 * s * b * (m + 1) + table + 2 * s * b * m,
                 UNTANGLE_OPS * b * m, H100.fp32_flops)

    for label, (plan, x) in r2c.items():
        b, n = x.shape
        m = n // 2
        s = 2  # bf16 bytes
        a = r2c_args[label]
        fs, inv = a["fwd_scale"], a["inv"]
        Z, spec = a["Z"], a["spec"]
        time_untangle_pair(label, n, b, fs, inv, Z, spec)
        if plan.resolve_strategy() is tt.Strategy.FOUR_STEP:
            col, row = a["col"], a["row"]
            elems = m * b
            n1, n2 = col["n1"], col["n2"]
            t = min(col["lane_tile"], n2)
            pq = 2 * 4 * (n1 * n2 // t + n1 * t)
            time_r2c("four_step_col_packed[mma]", label,
                     lambda v: four_step_cuda.column_pass_packed(v, **col),
                     lambda v: four_step_cuda.column_pass_packed_reference(v, **col),
                     None, (x,),
                     4 * s * elems + pq + table_bytes(plan, col["radices1"],
                                                      col["scales1"], col["sign"],
                                                      mma=True),
                     pass_flops(plan, col["radices1"], elems), H100.bf16_flops)
            time_r2c("four_step_row_interleave[mma]", label,
                     lambda r, i: four_step_cuda.row_pass_interleave(r, i, **row),
                     lambda r, i: four_step_cuda.row_pass_interleave_reference(r, i, **row),
                     None, a["mid"],
                     4 * s * elems + table_bytes(plan, row["radices2"],
                                                 row["scales2"], row["sign"],
                                                 mma=True),
                     pass_flops(plan, row["radices2"], elems), H100.bf16_flops)
            # What the fused load and store maps cost: kernels B and C on the
            # same shape, with the planes already packed.
            t_b = measure(lambda r, i: four_step_cuda.column_pass(r, i, **col),
                          rfft_cuda.pack_split(x), iters=20, flush=flush)
            t_c = measure(lambda r, i: four_step_cuda.row_pass(r, i, **row),
                          a["mid"], iters=20, flush=flush)
            log(f"[time] unfused passes {R2C_SHAPE[label]}: kernel B "
                f"{t_b.average_time_ms:.4f} ms | kernel C "
                f"{t_c.average_time_ms:.4f} ms | split ({n1}, {n2}) | {smi}")
        # pack and interleave at both shapes (the fused route runs them).
        time_r2c("pack_split", label, rfft_cuda.pack_split,
                 rfft_cuda.pack_split_reference,
                 lambda v: v.view(b, m, 2).permute(2, 0, 1).contiguous(),
                 (x,), 4 * s * b * m, 0, H100.fp32_flops)
        planes = a.get("planes") or rfft_cuda.pack_split(x)
        time_r2c("interleave_split", label, rfft_cuda.interleave_split,
                 rfft_cuda.interleave_split_reference,
                 lambda r, i: torch.stack([r, i], -1).reshape(b, 2 * m),
                 planes, 4 * s * b * m, 0, H100.fp32_flops)
        # The whole R2C pair against torch.fft on float32 of the same shape.
        x32 = x.float()
        spec32 = torch.complex(spec[0].float(), spec[1].float())
        t_rf = measure(lambda v: tt.rfft_split(v, plan), (x,), iters=10, flush=flush)
        t_irf = measure(lambda r, i: tt.irfft_split(r, i, plan), spec, iters=10,
                        flush=flush)
        t_trf = measure(lambda v: torch.fft.rfft(v, dim=-1), (x32,), iters=10,
                        flush=flush)
        t_tirf = measure(lambda v: torch.fft.irfft(v, n=n, dim=-1), (spec32,),
                         iters=10, flush=flush)
        c2c = (data["bench-headline"] if label == "r2c-fused" else data["four-step"])
        log(f"[time] {label} N={n} B={b} bf16: rfft_split "
            f"{t_rf.average_time_ms:.4f} ms | irfft_split "
            f"{t_irf.average_time_ms:.4f} ms | torch.fft.rfft f32 "
            f"{t_trf.average_time_ms:.4f} ms | torch.fft.irfft c64 "
            f"{t_tirf.average_time_ms:.4f} ms | half-length C2C plan "
            f"{c2c[0].resolve_strategy().value} | {smi}")
        del x32, spec32
    time_untangle_pair(short_label, **short)
    del short

    # The N-D path: each K4 pass at 4096 x 4096 bf16, then the entry points
    # against their torch.fft counterparts on complex64 of the same shape.
    ph, pw, k4_col, k4_row = nd_plans
    x3 = tuple(p.reshape(1, h, w) for p in planes2d)
    x_c = torch.complex(planes2d[0].float(), planes2d[1].float())
    elems = h * w
    for name, fn, ref, args, kw, plan, dim in (
            ("fft2_col[mma]", four_step_cuda.fft2_column_pass,
             four_step_cuda.fft2_column_pass_reference, x3, k4_col, ph, -2),
            ("fft2_row[mma]", four_step_cuda.fft2_row_pass,
             four_step_cuda.fft2_row_pass_reference, k4_mid, k4_row, pw, -1)):
        radices = kw.get("radices1", kw.get("radices2"))
        scales = kw.get("scales1", kw.get("scales2"))
        call = lambda r, i, fn=fn, kw=kw: fn(r, i, **kw)
        plain = lambda r, i, ref=ref, kw=kw: ref(r, i, **kw)
        tp1 = measure(plain, args, iters=3)
        tk1 = measure(call, args, iters=10)
        tk2 = measure(call, args, iters=10)
        tp2 = measure(plain, args, iters=3)
        tl = measure(lambda x, dim=dim: torch.fft.fft(x, dim=dim), (x_c,), iters=10)
        k_ms = min(tk1.average_time_ms, tk2.average_time_ms)
        p_ms = min(tp1.average_time_ms, tp2.average_time_ms)
        nbytes = 4 * 2 * elems + table_bytes(plan, radices, scales, -1, "default",
                                             mma="mma" in name)
        b_ms, b_by = bound(nbytes, pass_flops(plan, radices, elems, "default"),
                           H100.bf16_flops)
        timing[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=tl.average_time_ms,
                            bound_ms=b_ms, bound_by=b_by, shape=f"{h}x{w} bf16")
        log(f"[time] {name} {h}x{w} bf16: kernel {k_ms:.4f} ms (runs "
            f"{tk1.average_time_ms:.4f}, {tk2.average_time_ms:.4f}) | plain "
            f"{p_ms:.4f} ms | torch.fft.fft(dim={dim}) c64 "
            f"{tl.average_time_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by}) | "
            f"{b_ms / k_ms:.1%} of bound | {smi}")
    t_2d = measure(lambda r, i: tt.fftn_split(r, i, axes=(-2, -1)), planes2d, iters=10)
    t_t2d = measure(lambda x: torch.fft.fft2(x), (x_c,), iters=10)
    log(f"[time] fftn_split {h}x{w} bf16: {t_2d.average_time_ms:.4f} ms | "
        f"torch.fft.fft2 c64 {t_t2d.average_time_ms:.4f} ms | {smi}")
    t_conv = measure(tt.fft_convolve_2d, (image, conv_kernel), iters=5)
    t_tconv = measure(lambda a, k: torch.fft.ifft2(torch.fft.fft2(a) * torch.fft.fft2(k)).real,
                      (image, conv_kernel), iters=10)
    log(f"[time] fft_convolve_2d {h}x{w} float32: {t_conv.average_time_ms:.4f} ms | "
        f"torch.fft fft2, fft2, ifft2 {t_tconv.average_time_ms:.4f} ms | {smi}")
    del x_c
    t_vol = measure(lambda r, i: tt.fftn_split(r, i), volume, iters=5)
    t_vk4 = measure(lambda r, i: tt.fftn_split(r, i, axes=(1, 2)), volume, iters=5)
    t_vax0 = measure(lambda r, i: tt.fftn_split(r, i, axes=(0,)), volume, iters=5)
    t_copy = measure(lambda r, i: [torch.movedim(t, 0, -1).reshape(-1, n_v).contiguous()
                                   for t in (r, i)], volume, iters=5)
    v_c = torch.complex(volume[0].float(), volume[1].float())
    t_tvol = measure(lambda x: torch.fft.fftn(x), (v_c,), iters=5)
    log(f"[time] fftn_split {'x'.join(map(str, ND_VOLUME))} bf16: "
        f"{t_vol.average_time_ms:.4f} ms (K4 over axes 1, 2: "
        f"{t_vk4.average_time_ms:.4f} ms; axis 0 through kernel A's tiles "
        f"landed from the grid: {t_vax0.average_time_ms:.4f} ms; the moveaxis "
        f"copies it does without: {t_copy.average_time_ms:.4f} ms) | "
        f"torch.fft.fftn c64 "
        f"{t_tvol.average_time_ms:.4f} ms | {smi}")
    del v_c


    # The tuned-plan path: each new kernel at its tuned shape against its
    # plain version, torch.fft on the same shape and its bound; the stacked
    # kernel A on the same rows and radices beside it.
    def time_kernel(name, shape, call, plain, library, args, nbytes, ops,
                    extra="", record=True):
        """Time ``name`` at ``shape``; ``record`` keeps it for the JSON line
        (a variant's first shape)."""
        tp1 = measure(plain, args, iters=3)
        tk1 = measure(call, args, iters=10)
        tk2 = measure(call, args, iters=10)
        tp2 = measure(plain, args, iters=3)
        l_ms = (measure(library[0], library[1], iters=10).average_time_ms
                if library is not None else None)
        k_ms = min(tk1.average_time_ms, tk2.average_time_ms)
        p_ms = min(tp1.average_time_ms, tp2.average_time_ms)
        b_ms, b_by = bound(nbytes, ops, H100.bf16_flops)
        if record:
            timing[name] = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                bound_ms=b_ms, bound_by=b_by, shape=shape)
        log(f"[time] {name} {shape}: kernel {k_ms:.4f} ms (runs "
            f"{tk1.average_time_ms:.4f}, {tk2.average_time_ms:.4f}) | plain "
            f"{p_ms:.4f} ms | torch.fft "
            f"{'none' if l_ms is None else f'{l_ms:.4f} ms'} | bound "
            f"{b_ms:.4f} ms ({b_by}) | {b_ms / k_ms:.1%} of bound{extra} | {smi}")

    # The spectral scale on the solve's half spectrum, and the whole solve
    # beside torch.fft's real transforms of the same grid.
    n_half = p_half[0].numel()
    time_kernel("poisson_scale", f"{tuple(p_half[0].shape)} bf16, strides {p_half[0].stride()}",
                lambda r, i: spectral_cuda.poisson_scale(r, i, *p_tables),
                lambda r, i: spectral_cuda.poisson_scale_reference(r, i, *p_tables),
                None, p_half, 8 * n_half, 6 * n_half)
    # The convolution's spectral product: its plain version is the six torch
    # launches of the JAX package's _cmul (four products, a difference and a
    # sum); 24 bytes a point, four fp32 planes in and two out.
    time_kernel("spectral_product", f"{h}x{w} float32 spectra (fft_convolve_2d)",
                spectral_cuda.spectral_product, spectral_cuda.spectral_product_reference,
                None, (*conv_spectra[0], *conv_spectra[1]), 24 * h * w, 6 * h * w)
    del conv_spectra
    # Kernel A on the solve's half-length rows (rfft_split's transform of
    # 262,144 rows of 256 in the default plan), in the rule's tile.
    n_h = nz // 2
    plan_h = tt.create_plan(n_h)
    kw_h = fused_kw(plan_h)
    x_h = device_inputs(n_h, nx * ny, torch.bfloat16, SEED + 7)
    elems = n_h * nx * ny
    # Both ways, the rule's launch (the roots' persistent walk: about 62
    # tiles a CTA) equals one CTA a row bit for bit and the plain version
    # within the fused bound.
    for sign in (-1, 1):
        kw_s = dict(kw_h, sign=sign,
                    scales=stage_scales(plan_h.radices, plan_h.scaling, sign < 0))
        name_h, got = named(lambda: fused_cuda.fused_fft(*x_h, **kw_s))
        label = f"N={n_h} x B={nx * ny} sign {sign} (the solve's half-length rows)"
        bitwise(name_h, f"{label}, against one CTA a row", got, fused_cuda._launch_fused(
            *x_h, pipelined=False, grouped=False, complex_mult="block",
            state_dtype="float32", **kw_s))
        hold(name_h, label, got, fused_cuda.fused_fft_reference(*x_h, **kw_s),
             FUSED_MAX_FRAC)
        del got
    time_kernel(name_h, f"N={n_h} x B={nx * ny} bf16 (the solve's "
                f"half-length rows)", lambda r, i: fused_cuda.fused_fft(r, i, **kw_h),
                lambda r, i: fused_cuda.fused_fft_reference(r, i, **kw_h),
                (lambda v: torch.fft.fft(v, dim=-1),
                 (torch.complex(x_h[0].float(), x_h[1].float()),)), x_h,
                4 * 2 * elems + table_bytes(plan_h, plan_h.radices, kw_h["scales"], -1,
                                            mma=True),
                pass_flops(plan_h, plan_h.radices, elems), record=False)
    # Two stages (16, 16) at the same rows, for the record: the plan stays
    # the JAX plan's one radix-256 stage.
    kw_16 = dict(kw_h, radices=(16, 16), scales=stage_scales((16, 16), plan_h.scaling, True))
    time_kernel("fused_fft (16, 16)", f"N={n_h} x B={nx * ny} bf16 (the solve's "
                f"half-length rows, radices (16, 16))",
                lambda r, i: fused_cuda.fused_fft(r, i, **kw_16),
                lambda r, i: fused_cuda.fused_fft_reference(r, i, **kw_16),
                None, x_h,
                4 * 2 * elems + table_bytes(plan_h, (16, 16), kw_16["scales"], -1,
                                            mma=True),
                pass_flops(plan_h, (16, 16), elems), record=False)
    del x_h
    t_solve = measure(lambda f: poisson_solve_3d(f, precision="bfloat16"), (volume[0],),
                      iters=5)
    f32 = volume[0].float()
    t_tsolve = measure(lambda f: torch.fft.irfftn(torch.fft.rfftn(f)), (f32,), iters=5)
    log(f"[time] poisson_solve_3d {'x'.join(map(str, ND_VOLUME))} bf16: "
        f"{t_solve.average_time_ms:.4f} ms | torch.fft rfftn + irfftn float32 "
        f"{t_tsolve.average_time_ms:.4f} ms | {smi}")
    del p_half, f32

    for label, n_t, b_t, layout, want in TUNED_CALLS:
        plan, x = tuned_plans[label], tuned_in[label]
        elems = n_t * b_t
        shape = f"N={n_t} x B={b_t} bf16"
        x_c = torch.complex(x[0].float(), x[1].float())
        library = (lambda v: torch.fft.fft(v, dim=-1), (x_c,))
        if plan.resolve_strategy() is tt.Strategy.FOUR_STEP:
            _, _, col, row = pass_kwargs(plan, True)
            col, row = dict(col, engine=plan.engine), dict(row, engine=plan.engine)
            mid = four_step_cuda.column_pass(*x, **col)
            n1, n2 = col["n1"], col["n2"]
            t_pq = min(col["lane_tile"], n2)
            pq = 2 * 4 * (n1 * n2 // t_pq + n1 * t_pq)
            for pname, fn, ref, args, kw_pass, radices, scales, extra_bytes in (
                    ("four_step_col", four_step_cuda.column_pass,
                     four_step_cuda.column_pass_reference, x, col,
                     col["radices1"], col["scales1"], pq),
                    ("four_step_row", four_step_cuda.row_pass,
                     four_step_cuda.row_pass_reference, mid, row,
                     row["radices2"], row["scales2"], 0)):
                time_kernel(f"{pname}[{plan.engine},mma]", shape,
                            lambda r, i, fn=fn, kw=kw_pass: fn(r, i, **kw),
                            lambda r, i, ref=ref, kw=kw_pass: ref(r, i, **kw),
                            None, args,
                            4 * 2 * elems + extra_bytes
                            + table_bytes(plan, radices, scales, -1, mma=True),
                            pass_flops(plan, radices, elems))
            t_all = measure(lambda r, i: tt.fft_split(r, i, plan), x, iters=10)
            t_lib = measure(*library, iters=10)
            log(f"[time] fft_split {label} x B={b_t} (split {plan.four_step_split}, "
                f"{plan.engine}): {t_all.average_time_ms:.4f} ms | torch.fft.fft "
                f"c64 {t_lib.average_time_ms:.4f} ms | {smi}")
            del mid, x_c
            continue
        kw = fused_kw(plan)
        (name,) = want
        fn = (four_step_cuda.fused_fft_batch_major if layout == "batch_major"
              else fused_cuda.fused_fft)
        stacked_kw = dict(kw, engine="stacked")
        t_a = measure(lambda r, i: fused_cuda.fused_fft(r, i, **stacked_kw), x,
                      iters=10)
        time_kernel(name, shape, lambda r, i: fn(r, i, **kw),
                    lambda r, i: fused_cuda.fused_fft_reference(r, i, **kw),
                    library, x,
                    4 * 2 * elems + table_bytes(plan, plan.radices, kw["scales"], -1,
                                                mma=True),
                    pass_flops(plan, plan.radices, elems),
                    extra=f" | stacked kernel A, radices {plan.radices}, same "
                          f"rows: {t_a.average_time_ms:.4f} ms")
        del x_c
    elems = h * w
    x3 = tuple(p.reshape(1, h, w) for p in planes2d)
    x_c = torch.complex(planes2d[0].float(), planes2d[1].float())
    for name, fn, ref, args, kw, dim in (
            ("fft2_col[mma]", four_step_cuda.fft2_column_pass,
             four_step_cuda.fft2_column_pass_reference, x3, col_t, -2),
            ("fft2_row[mma]", four_step_cuda.fft2_row_pass,
             four_step_cuda.fft2_row_pass_reference, k4t_mid, row_t, -1)):
        radices = kw.get("radices1", kw.get("radices2"))
        scales = kw.get("scales1", kw.get("scales2"))
        tagged = (name.replace("[", f"[{plan2d.engine},") if "[" in name
                  else f"{name}[{plan2d.engine}]")
        time_kernel(tagged, f"{h}x{w} bf16",
                    lambda r, i, fn=fn, kw=kw: fn(r, i, **kw),
                    lambda r, i, ref=ref, kw=kw: ref(r, i, **kw),
                    (lambda v, dim=dim: torch.fft.fft(v, dim=dim), (x_c,)), args,
                    4 * 2 * elems + table_bytes(plan2d, radices, scales, -1, "default",
                                                mma="mma" in name),
                    pass_flops(plan2d, radices, elems, "default"))
    del x_c

    # The tpu_tuned path: each variant at each shape that ran it, with its
    # bound counting the tables a folded stage reads (bf16 on the
    # tensor-core engine, fp32 elsewhere).
    log(f"[phase] tpu_tuned timing from {time.perf_counter() - t_start:.1f} s")
    for key, job in tpu_jobs.items():
        library = job["library"]() if job["library"] is not None else None
        tables = sum(table_bytes(*t, mma=on_tensor_cores(job["name"]))
                     for t in job["tables"])
        time_kernel(job["name"], job["shape"], job["call"], job["plain"], library,
                    job["args"], job["io_bytes"] + tables, job["ops"],
                    extra=f" | tables {tables} B", record=key == job["name"])
        del library

    # Kernel B's twin at 2^27 on each (lanes, cluster) candidate of the
    # column-cluster rule, on the bign path's input, in turns (every
    # candidate, then every one again), beside its bound (bf16 tables).
    log(f"[phase] column-cluster candidates from {time.perf_counter() - t_start:.1f} s")
    label = "K2c cluster N=2^27 (32768, 4096)"
    plan, x = bign_plans[label], bign_in[label]
    _, _, col, _ = pass_kwargs(plan, True)
    knobs = four_step_cuda._knobs(col["engine"], col["grouped"],
                                  col["complex_mult"], col["state_dtype"])
    ck = {k: col[k] for k in ("n1", "n2", "radices1", "scales1", "sign",
                              "lane_tile", "algorithm", "first_dot")}
    elems = col["n1"] * col["n2"]
    b_ms, b_by = bound(4 * 2 * elems + pq_bytes(col)
                       + table_bytes(plan, col["radices1"], col["scales1"], -1,
                                     mma=True),
                       pass_flops(plan, col["radices1"], elems), H100.bf16_flops)
    rule = fused_cuda.column_cluster(
        col["n1"], four_step_cuda.pass_lanes(col["n1"], col["n2"]), col["n2"],
        col["algorithm"], fused_cuda.pass_stages(tuple(col["radices1"])), label)
    runs = {tc: [] for tc in K2C_CANDIDATES}
    for _ in range(2):
        for lanes, cluster in K2C_CANDIDATES:
            runs[lanes, cluster].append(measure(
                lambda r, i, t=lanes, c=cluster: four_step_cuda._launch_col_pass(
                    (r, i), cluster=c, lanes=t, knobs=knobs, **ck),
                x, iters=5).average_time_ms)
    for (lanes, cluster), v in runs.items():
        log(f"[time] K2c candidate {lanes} columns x {cluster} CTAs, N=2^27 x 1 "
            f"(32768, 4096) bf16: kernel {min(v):.4f} ms (runs "
            f"{', '.join(f'{t:.4f}' for t in v)}) | bound {b_ms:.4f} ms ({b_by}) | "
            f"{b_ms / min(v):.1%} of bound | "
            f"{'the rule' if (lanes, cluster) == rule else 'not taken'} | {smi}")
    # The whole transform at that split: the twin on the rule's tile, then
    # one-CTA kernel C.
    runs = [measure(lambda r, i: tt.fft_split(r, i, plan), x, iters=5).average_time_ms
            for _ in range(2)]
    log(f"[time] fft_split N=2^27 x 1 (32768, 4096) bf16, kernel B's twin on "
        f"{rule[0]} columns x {rule[1]} CTAs, then one-CTA kernel C: {min(runs):.4f} ms "
        f"(runs {', '.join(f'{t:.4f}' for t in runs)}) | {smi}")

    # The choice the JAX tuner's fused_bign branch makes: K1 on a cluster
    # against the default four-step plan at the same N and rows, in turns
    # (K1, four-step, K1, four-step), beside torch.fft.fft.
    log(f"[phase] bign comparison from {time.perf_counter() - t_start:.1f} s")
    for label in BIGN_VS_FOUR_STEP:
        plan, x = bign_plans[label], bign_in[label]
        b_t, n_t = x[0].shape
        default = tt.create_plan(n_t)
        plans = {f"K1 {plan.radices} {plan.state_dtype} state": plan,
                 f"four-step {default.four_step_split}": default}
        if plan.state_dtype != "float32":
            plans[f"K1 {plan.radices} float32 state"] = dataclasses.replace(
                plan, state_dtype="float32")
        times = {k: [] for k in plans}
        for _ in range(2):
            for k, pl in plans.items():
                times[k].append(measure(lambda r, i, pl=pl: tt.fft_split(r, i, pl),
                                        x, iters=10).average_time_ms)
        x_c = torch.complex(x[0].float(), x[1].float())
        t_lib = measure(lambda v: torch.fft.fft(v, dim=-1), (x_c,), iters=10)
        flops = 5.0 * n_t * math.log2(n_t) * b_t
        log(f"[time] fft_split N={n_t} x B={b_t} bf16: " + " | ".join(
            f"{k} {min(v):.4f} ms ({flops / min(v) / 1e6:.1f} GFLOP/s; runs "
            f"{', '.join(f'{t:.4f}' for t in v)})" for k, v in times.items())
            + f" | torch.fft.fft c64 {t_lib.average_time_ms:.4f} ms | {smi}")
        del x_c

    kernels = []
    for name in KERNELS:
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": sum(c.get(name, 0) for c in launches_by_path.values()),
            "launches_by_path": {p: c.get(name, 0) for p, c in launches_by_path.items()},
            "max_abs_err": errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
        })
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
