#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--json PATH]

It needs a CUDA device; without one (or without the rest of the checkout)
it exits non-zero and prints no result. It imports neither JAX nor the JAX
package. Phases, each of which raises on failure:

1. the card (``nvidia-smi`` name and power limit) and the kernel build,
   from the sources in ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   all started together); ``cuobjdump -sass`` of the PIM matmul library
   must show int8 wgmma (IGMMA) in every instantiation of the wgmma
   route's kernel;
2. kernels: every variant of the PIM matmul kernel (fused, fused + bias,
   fused + row-sums, raw int32) at w4a4 and w8a8, on its three routes
   (``kernels/pim_matmul/pim_matmul.py small_m_grid``): the CNN path's
   shapes, hymba's four decode shapes at M = 1, 5, 8, 16 and 64 (the
   small-M route, also through the tiled yardstick symbol), its four
   prefill shapes and M = 65 (the wgmma route, also through the mma.sync
   kernel's yardstick symbol and, at w4a4, the wgmma route on K-major
   weight planes) and ragged ones, against its plain PyTorch version on
   the card, bit for bit; w8a8 cases at M = 8 and M = 256 that wrap mod
   2^32, and the wgmma route's level-overflow case (every plane 127, K =
   139,264: each shift level's own sum overflows int32); then both passes of the analog readout kernel (full scale and
   readout, with and without a bias) at w4a4 and w8a8 on main-path shapes
   and a ragged one, with the (chunk, ADC bits) sweep on the ragged one
   (chunks 4, 8, 16 on the tensor-core route, 3 and 24 on the CUDA-core
   route: ``analog_readout.analog_route``), with the activation planes as
   wide as the weight planes and narrower (Ka < Kw, as the main path
   passes them), bit for bit on the deterministic path, a second launch
   bit for bit, the yardstick symbols (``analog_*_simt``, the CUDA-core
   kernel) equal to the route, and with noise (CUDA-core route) within
   the tolerance stated at ``NOISY_SHARE``; the tensor-core route's ADC
   (its quotient against ``__fdiv_rn(s, lsb)``, its code against
   ``__float2int_rn`` of that) for every integer s in [-2^22, 2^22] at
   ``ADC_CHECK_BITS`` x ``ADC_CHECK_FULL_SCALES``;
3. the exact path: full-width ResNet18 (CIFAR-100, 32x32, random weights
   from seed 0) programmed once at w4a4 on ``exact-cuda``, then 4
   requests of 128 synthetic images through ``cnn_forward``; 21 kernel
   launches per request, logits bit-identical to ``exact-torch`` on the
   card; one request also at w8a8;
4. numbers of the exact path: request latency and images/s, a
   torch.profiler breakdown of one request's device time by stage with
   the device's idle share, and per main-path kernel shape the kernel's
   device time in turns with the mma.sync yardstick, launches, both
   bounds, plain-version time and two library yardsticks
   (``torch._int_mm`` on one plane pair as the port keeps it, N-major,
   and on a K-major copy, each + the epilogue);
5. the analog path: the same network and requests programmed at w4a4
   with a 5-bit ADC on ``analog-cuda``; 21 launches of each analog pass
   per request, all on the tensor-core route, and none of the PIM matmul
   kernel, logits bit-identical to the plain ``analog`` substrate on the
   card; one noisy request (CPU generator of seed 9, the cell model's
   implied sigma) that is finite, differs from the deterministic one and
   repeats bit for bit;
6. numbers of the analog path: latency, a profile with both analog
   kernels named, and per shape, on the inputs the path gave it (the
   activation planes unpadded), each pass's device time in turns with
   its yardstick (the CUDA-core kernel) on activation planes padded to
   Kw, the yardstick on the unpadded planes, launches, bound,
   plain-version time, the share of zero chunk sums and of chunks never
   formed (wholly past Ka), and the ADC check at the shape's own lsb;
7. the ADC ablation and Table II (``repro_torch.benchmarks_impl.table2``)
   on the card, printing their rows;
8. the SSD scan kernel (a chunk-parallel pass on the tensor cores, 3xTF32)
   against its plain version (the chunked form, or the sequential
   recurrence for a ragged length) and the sequential recurrence, within
   the tolerance stated at ``SSD_RTOL``, at hymba-1.5b's and
   mamba2-370m's scan shapes, a ragged one, the long-decay case and 16
   chunks (L = 2048); two launches on the same inputs bit for bit; at
   each shape its device time in turns with the serial CUDA-core kernel
   it replaced (the C library's yardstick symbol ``ssd_scan_serial``,
   which no wrapper calls), the plain version's time, and its bytes
   bound beside both operation bounds (CUDA-core float32 and 3xTF32);
9. the LM path: hymba-1.5b at full width (32 layers, d_model 1600, random
   weights from seed 0), its float prefill logits through the SSD kernel
   against the chunked route (within ``LM_FLOAT_TOL``), then programmed
   once at w4a4 on ``exact-cuda`` and served with
   ``ssd_backend="cuda"`` by the static loop of
   ``repro_torch.launch.serve`` (batch 8, prompt 512, 16 new tokens):
   32 SSD launches per prefill and none per decode step, 7 x 32 PIM
   launches per prefill and per decode step, no analog launch; prefill
   logits and all 16 decode steps' logits bit-identical to
   ``exact-torch``; the PIM route's logit gap and greedy agreement
   against the chunked SSD route, reported; prefill and decode times,
   tokens/s, peak memory, a profile by stage; one decode step profiled
   (224 small-M PIM kernels, no tiled one) and its 224 PIM launches
   captured and replayed back to back on the device, the small-M route
   against the tiled yardstick and the step's bytes bound, with nothing
   but those kernels on the device; the PIM kernel at the path's shapes
   (bit for bit, then timed: the prefill shapes as device time in turns
   with the mma.sync yardstick, beside the wgmma route on K-major planes
   and both library yardsticks; the decode shapes as device time with
   cold weights, beside the tiled yardstick); and the small-M and tiled
   routes at M = 64 and 128 on the decode shapes (reported, to re-read
   the small-M threshold);
10. ``repro_torch.launch.serve.serve("hymba-1.5b", ..., pim=True)`` itself
    at full width (default ``ssd_backend="chunked"``);
11. mamba2-370m at full width (48 layers) with ``ssd_backend="cuda"``: 48
    SSD launches per prefill, its prefill logits against the chunked
    route, and the request's time;
12. the MoE path: moonshot-v1-16b-a3b at full width (48 layers, d_model
    2048, 64 experts top-6 of d_ff 1408, 2 shared experts, vocab 163840,
    random weights from seed 0): first at 2 layers (full width), its
    prefill and 16 decode steps' logits on ``exact-cuda`` bit-identical to
    ``exact-torch``; then ``repro_torch.launch.serve``'s set-up, which
    programs each layer at w4a4 on ``exact-cuda`` as it is drawn (the
    float32 expert stacks, 106 GB, never exist at once), and the static
    loop (batch 8, prompt 512, 16 new tokens): 199 PIM launches per layer
    and forward step (4 attention, 3 shared, 3 x 64 expert), all on the
    wgmma route in prefill and on the small-M route in decode, no other
    kernel; prefill and decode times, tokens/s, programming time, peak
    memory, the weight planes one decode step reads and their bytes
    bound, a profile of one request by stage (B1 by route, quantize +
    nibbles, plane padding, the (E, T, ·) glue, the combine, attention,
    the router); then the PIM kernel at the path's ten shapes (M = 4096
    and 8) bit for bit and timed as for hymba;
13. plan persistence: qwen3-4b at full width (36 layers, d_model 2560,
    32 heads on 8 KV heads, head_dim 128, d_ff 9728, vocab 151936,
    qk-norm, tied embeddings; random weights from seed 0) through
    ``repro_torch.launch.serve.serve(..., pim=True, plan_dir=)`` into a
    fresh temporary directory: the set-up draws the weights for their
    digest, programs them at w4a4 on ``exact-cuda`` and saves the plans
    (about 9 GB; a lack of disk space fails the phase), then serves batch
    8 x prompt 512 with 16 greedy tokens (7 x 36 PIM launches per forward
    step); the set-up's parts timed (digest, programming, save, sha256);
14. continuous batching: ``serve_continuous(qwen3-4b, ...)`` through the
    same directory (its set-up restores the plans: digest, load and the
    load's sha256 share timed) with 8 slots and 32 Poisson requests at
    0.5 per step (seed 0), prompts 128-512, 4-16 new tokens: launches by
    route (whole prefill on the wgmma route, decode at M = 8 on the
    small-M route, none other), tokens/s, TTFT and latency percentiles
    (virtual steps and wall), prefill ms per admitted request, decode ms
    per step; the restored plans' static request equal to phase 13's bit
    for bit (prefill logits and tokens); on the restored plans
    ``sync_every`` 4 = 1, chunked prefill (64) = whole and a prefix-cache
    hit = a miss (shared prefix 128) on the trace's first 6 requests,
    four requests' streams = ``static_generate`` at the slots' shapes,
    and at 2 layers ``exact-cuda`` = ``exact-torch`` for the whole trace
    (token streams and stop reasons); one fused decode window profiled
    (idle share); then the PIM kernel at the path's ten shapes (M = 512
    and 8) bit for bit and timed as for hymba; the directory is deleted;
15. the flash-attention kernels against their plain versions: the
    forward on the JAX kernel test's cases in float32 and bfloat16 (within
    the tolerances stated at ``FLASH_RTOL``), then the forward and the
    three backward kernels (dQ, dK/dV per query head, the head sum) at
    gemma3-1b's training shapes (window 512 and global), each against its
    own plain version (delta within ``FLASH_DELTA_RTOL``; the head sum
    also equal to head-order float32 adds bit for bit, and timed as device
    time beside ``torch.sum``), timed with it
    and with its bound, and ``scaled_dot_product_attention`` as a
    yardstick; the forward, the dQ and the dK/dV pass (3xTF32 on the
    tensor cores) each also against the CUDA-core kernel it replaced (the
    library's ``flash_fwd_simt``, ``flash_bwd_dq_simt`` and
    ``flash_bwd_dkv_simt``, which no wrapper calls): both against the
    plain version, the dQ yardstick's delta equal to the pass's bit for
    bit, the three against a float64 evaluation of the same inputs
    (``fwd_float64`` for o and the log-sum-exp, ``dq_float64``,
    ``dkv_float64``; the kernel held within ``FLASH_F64_REL``, the others
    reported), kernel and yardstick timed in turns, with the kernel's
    3xTF32 bound and its CUDA-core float32 bound; and the backward's three
    passes summed against SDPA's backward (its forward + backward minus
    its forward);
16. the training path: gemma3-1b at full width (26 layers, d_model 1152,
    vocab 262144, float32, random weights from seed 0) through
    ``repro_torch.launch.train``, ``attn_backend="cuda"``: the loss,
    gradient norm and every gradient leaf against the ``"jnp"`` route on
    one state (within ``TRAIN_LOSS_REL``, ``TRAIN_GNORM_REL`` and
    ``TRAIN_LEAF_GAP_REL``, with a control that the leaf check sees a lost
    window), then AdamW steps of batch 2 x 2048 tokens (a warm-up and
    ``TRAIN_STEPS`` timed: 26 launches of each flash kernel per step, no
    other kernel), one step with int8 gradient compression, and a profile
    of one step by stage;
17. checkpoint and restart on the card at a reduced gemma3-1b: a run
    resumed from a step-6 checkpoint against the unbroken run.

Each path's launch counts are set to 0 just before its requests and read
just after (B1's also by route, held to what the route chooser gives the
path's shapes). It prints a ``{"kernels": [...]}`` line (one entry per
kernel and path), then the device line
``{"ok": true, "device": {...}}`` last. ``--json PATH`` also writes every
number of the run (per-shape timings, the profiles, the study rows) to
``PATH``.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15        # H100 SXM dense int8 tensor cores
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12          # H100 SXM dense TF32 tensor cores
BATCH = 128
REQUESTS = 4
CNN_CHECK_SHAPES = {             # (M, K, N) as the kernel sees them
    "stage0": (131072, 1024, 64),
    "stage3": (2048, 4608, 512),
    "fc": (128, 512, 100),
    "ragged": (1000, 333, 77),
}
# hymba-1.5b's decode projections as the kernel sees them (planes padded
# by the plan): q and o, k and v, gate and up, down
HYMBA_DECODE_KN = {"qo": (2048, 1664), "kv": (2048, 384),
                   "gate_up": (2048, 5504), "down": (5632, 1664)}
# hymba-1.5b's prefill projections: batch 8 x prompt 512 rows
HYMBA_PREFILL_M = 8 * 512
# the small-M route: hymba's decode shapes at every batch up to its limit,
# and a shape ragged in M, K (not a whole number of splits) and N (not a
# whole number of strips); the wgmma route: hymba's prefill shapes, the
# first M above the small-M limit, and a shape ragged in M and N on
# 256-row tiles
CHECK_SHAPES = {
    **CNN_CHECK_SHAPES,
    **{f"{lb}_m{m}": (m, k, n) for lb, (k, n) in HYMBA_DECODE_KN.items()
       for m in (1, 5, 8, 16, 64)},
    **{f"{lb}_prefill": (HYMBA_PREFILL_M, k, n)
       for lb, (k, n) in HYMBA_DECODE_KN.items()},
    "down_m65": (65, *HYMBA_DECODE_KN["down"]),
    "ragged_small_m": (7, 333, 77),
    "ragged_wgmma": (4100, 1040, 2064),
}
# The wgmma route's level-overflow check: every plane 127 and K = 139,264,
# so that each shift level's own int32 sum (127 * 127 * K per plane pair)
# overflows inside the tensor cores' s32 accumulation
LEVEL_OVERFLOW_SHAPE = (128, 139264, 64)
KERNEL_SOURCE = "src/repro_torch/csrc/pim_matmul.cu"
ANALOG_SOURCE = "src/repro_torch/csrc/analog_readout.cu"
SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_attention_fwd":
        "src/repro/kernels/flash_attention/flash_attention.py:94",
    # the TPU kernel has no backward; these three kernels are the
    # gradient of that kernel
    "flash_attention_bwd_dq":
        "src/repro/kernels/flash_attention/flash_attention.py:94",
    "flash_attention_bwd_dkv":
        "src/repro/kernels/flash_attention/flash_attention.py:94",
    "flash_attention_bwd_sum":
        "src/repro/kernels/flash_attention/flash_attention.py:94",
    "ssd_scan": "src/repro/kernels/ssd_scan/ssd_scan.py:67",
    "pim_matmul_fused": "src/repro/kernels/pim_matmul/pim_matmul.py:227",
    "pim_matmul_int": "src/repro/kernels/pim_matmul/pim_matmul.py:108",
    "analog_fullscale":
        "src/repro/kernels/analog_readout/analog_readout.py:263",
    "analog_readout":
        "src/repro/kernels/analog_readout/analog_readout.py:322",
}
# (M, Ka, Kw, N): the analog kernels take the weights' K in whole WDM
# chunks (336 = 21 * 16); the activation planes as wide or narrower, as
# the main path passes them (stage 0: 576 of 1024; the stem: 27 of 32)
ANALOG_CHECK_SHAPES = {
    **{lb: (m, k, k, n) for lb, (m, k, n) in CNN_CHECK_SHAPES.items()
       if lb != "ragged"},
    "ragged": (1000, 336, 336, 77),
    "stage0_unpadded": (131072, 576, 1024, 64),
    "stem_unpadded": (131072, 27, 32, 64),
    "ragged_unpadded": (1000, 333, 336, 77),
}
# (chunk, adc_bits) on the ragged shapes: the tensor-core route's three
# chunks, two the CUDA-core route takes, and a 24-bit ADC (the tensor-core
# route's blocks then divide: |s / lsb| may pass 2^21)
ANALOG_SWEEP = ((4, 3), (8, 5), (16, 8), (3, 5), (24, 6), (8, 24))
# the ADC check: every integer chunk sum in [-2^22, 2^22] at these widths
# and full scales (1e-6 is the floor; 262144 = 16 * 128 * 128, the
# largest |s| of int8 planes at chunk 16), and at the main path's lsb
ADC_CHECK_BITS = (2, 3, 5, 8, 12, 16, 24)
ADC_CHECK_FULL_SCALES = (1e-6, 1.0, 7.0, 225.0, 1000.0, 1800.0, 3600.0,
                         262144.0)
NOISE_SIGMA = 0.05
NOISE_SEED = 1234
# Noisy kernel checks: the kernel and the plain version evaluate the same
# counter-based normals, and only the transcendental functions of the
# normal transform (logf, cosf, as compiled into the kernel and into
# PyTorch) may round differently. A last-ulp difference moves a chunk sum
# across an ADC code edge only rarely, and then moves the output by whole
# codes of its shift level. So the full scale must agree to 1e-6
# relative, at most NOISY_SHARE of the outputs may differ, and each by at
# most 2 codes of the top shift level.
NOISY_SHARE = 1e-3
# The LM paths: static serving of batch 8, prompt 512, 16 new tokens
LM_BATCH, LM_PROMPT, LM_GEN, LM_REQUESTS = 8, 512, 16, 3
# SSD kernel checks, (BH, L, P, N, chunk, decay): hymba-1.5b's and
# mamba2-370m's scans at that batch and prompt, a ragged tail, and the
# long-decay case (a = 1e-6, where exp(cl_i - cl_j) above the diagonal
# overflows). The kernel must agree with its plain version (the chunked
# form, or the sequential recurrence where L % chunk != 0) within JAX's
# own kernel-vs-oracle bound, |got - want| <= SSD_ATOL + SSD_RTOL * |want|:
# float32 sums in another order.
SSD_CHECKS = {
    "hymba": (400, 512, 64, 16, 128, None),
    "mamba2": (256, 512, 64, 128, 128, None),
    "ragged": (400, 600, 64, 16, 128, None),
    "long_decay": (400, 512, 64, 16, 128, 1e-6),
    "many_chunks": (256, 2048, 64, 128, 128, None),
}
SSD_RTOL, SSD_ATOL = 2e-4, 2e-5
# Float-path prefill logits of the SSD kernel route against the chunked
# plain route, through every layer of the model: each layer's scan
# differs within the bound above, and the gap may grow through depth, so
# the logits are held to |gap| <= LM_FLOAT_TOL * max |logit|.
LM_FLOAT_TOL = 1e-3
# Flash-attention kernel checks, (b, s, h, kv, d, causal, window, prefix):
# the JAX kernel test's cases (tests/test_kernels.py), in float32 within
# that test's rtol 2e-4, atol 2e-5 of the plain version and in bfloat16
# within 3e-2; then gemma3-1b's training shapes (local window 512 and
# global), forward and backward. Each backward gradient (dQ, dK, dV) must
# lie within FLASH_BWD_REL of that gradient's largest magnitude: float32
# sums over thousands of keys or queries in another order, through exp
# and the recomputed probabilities. The same holds for each backward
# kernel against its own plain version; delta = rowsum(dO * O) is held to
# FLASH_DELTA_RTOL, and the head sum (four float32 adds)
# to FLASH_SUM_REL of its largest magnitude.
FLASH_CASES = (
    (2, 128, 4, 2, 32, True, 0, 0),
    (1, 128, 8, 1, 16, True, 0, 0),
    (2, 64, 4, 4, 32, False, 0, 0),
    (1, 128, 4, 2, 16, True, 40, 0),
    (1, 128, 4, 2, 16, True, 0, 24),
    (1, 128, 4, 2, 16, True, 24, 16),
)
FLASH_RTOL, FLASH_ATOL, FLASH_BF16_TOL = 2e-4, 2e-5, 3e-2
FLASH_BWD_REL = 1e-3
FLASH_SUM_REL = 1e-6
# delta = rowsum(dO * O) of the dQ pass against its plain version: rtol
# FLASH_DELTA_RTOL, atol FLASH_ATOL (float32 sums of D products in another
# order; at D = 256 the terms cancel, and an element near 0 differs by a few
# float32 ulps of the terms' magnitude, 5.2e-6 read on an H100)
FLASH_DELTA_RTOL = 1e-6
# The tensor-core kernels (the forward, dQ, dK/dV) against a float64
# evaluation of the same inputs: each output (o and the log-sum-exp; each
# gradient) within FLASH_F64_REL of its largest magnitude.
# The float32 plain version reads 2.44e-6 at the global shape and the dK/dV
# pass 1.24e-6; an accumulator that takes every key or query of the global
# layer in the tensor cores (which truncate as they add) drifted to 2.7e-5.
FLASH_F64_REL = 1e-5
# The training path: gemma3-1b at full width (26 layers, d_model 1152,
# vocab 262144), float32 parameters, AdamW, batch 2 x 2048 tokens.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 3
GEMMA_FLASH = {"local": (TRAIN_BATCH, TRAIN_SEQ, 4, 1, 256, True, 512, 0),
               "global": (TRAIN_BATCH, TRAIN_SEQ, 4, 1, 256, True, 0, 0)}
# End to end, the "cuda" route against the "jnp" route on one parameter
# state: the loss within TRAIN_LOSS_REL and the gradient's global norm
# within TRAIN_GNORM_REL, relative (float32 through 26 layers; the
# attention differs only in summation order). The loss and the norm are
# means and sums over the whole model and barely see attention, so every
# gradient leaf is held too: its largest gap within TRAIN_LEAF_GAP_REL of
# that leaf's largest gradient (7.0e-6 measured on an H100; about 14x
# margin). A control run, the "cuda" route with every layer global, must
# exceed that limit, or the check could not see a miswired window.
TRAIN_LOSS_REL, TRAIN_GNORM_REL, TRAIN_LEAF_GAP_REL = 1e-4, 1e-3, 1e-4
RESTART_TOL = 1e-4   # resumed vs unbroken training, last loss (absolute)


def log(*args):
    print(*args, flush=True)


def time_ms(torch, fn, budget_ms=300.0):
    """Mean milliseconds per call over a run of calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(3, min(50, int(budget_ms / max(start.elapsed_time(end),
                                                1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps=200):
    """Device milliseconds per call of ``fn(i)`` over ``reps`` calls: the
    calls are queued behind a spin kernel, so the host's enqueue rate
    (the ctypes wrappers take tens of microseconds a call) does not show;
    raises if the enqueue outran the spin."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((4 * host_s + 5e-3) * 2e9))  # ~2 GHz cycles
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    if start.query():
        raise AssertionError("the calls' enqueue outran the spin kernel")
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(pa, pw, m, k, n, out_bytes, extra_bytes):
    """Least time (ms) for one call: each input read once, each output
    written once, against HBM bandwidth; int8 ops against the tensor-core
    peak. Returns (ms, "bytes" | "operations")."""
    moved = pa * m * k + pw * k * n + out_bytes * m * n + extra_bytes
    ops = 2.0 * pa * pw * m * k * n
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def planes(torch, gen, p, rows, cols, dev, lo=-15, hi=16):
    return torch.randint(lo, hi, (p, rows, cols), generator=gen,
                         device=dev, dtype=torch.int8)


def scales(torch, gen, m, n, dev):
    a_s = torch.rand((m, 1), generator=gen, device=dev) + 0.1
    w_s = torch.rand((1, n), generator=gen, device=dev) + 0.1
    bias = torch.randn((1, n), generator=gen, device=dev)
    return a_s, w_s, bias


def max_err(torch, got, ref):
    if not torch.equal(got, ref):
        raise AssertionError(
            f"kernel differs from its plain version: max |diff| "
            f"{(got.double() - ref.double()).abs().max().item()}")
    return (got.double() - ref.double()).abs().max().item()


def reset_counts(*kernel_modules):
    for mod in kernel_modules:
        mod.reset_launches()


def read_counts(*kernel_modules):
    counts = {}
    for mod in kernel_modules:
        counts.update(mod.LAUNCHES)
    return counts


def route_counts(kern, name):
    """B1's launches of one entry point by route since the last reset."""
    return {r: n for r, n in kern.ROUTE_LAUNCHES[name].items() if n}


def expected_routes(kern, shapes, repeats):
    """The launches by route that (M, K, N) -> launches per request
    give over ``repeats`` requests, by the wrappers' route chooser."""
    want = Counter()
    for (m, k, n), count in shapes.items():
        want[kern.small_m_grid(m, k, n)[0]] += count * repeats
    return dict(want)


def tiled_fused(torch, kern, a, w, a_s, w_s, bias=None):
    """B1 on the route it takes above the small-M limit, at any M: the
    C library's yardstick symbol ``pim_matmul_fused_tiled`` (the wgmma
    route) where TMA can describe the planes, else
    ``pim_matmul_fused_mma_sync``; the port's wrappers never call them.
    The small-M route's comparison at the same shapes."""
    route = kern.tiled_route(a.shape[2], w.shape[2])
    return kern.yardstick_fused(
        "pim_matmul_fused_tiled" if route == "wgmma"
        else "pim_matmul_fused_mma_sync", a, w, a_s, w_s, bias)


def fused_variants(torch, kern, ref, a, w, a_s, w_s, bias):
    """Every variant through the wrappers (fused, + bias, + row-sums,
    int32) against the plain version, bit for bit; the largest error of
    the fused variants and of int32, and the plain (out, rowsum) with
    bias."""
    want, want_rs = ref.pim_matmul_fused_ref(a, w, a_s, w_s, bias,
                                             want_rowsum=True)
    out, rs = kern.pim_matmul_fused_cuda(a, w, a_s, w_s, bias,
                                         want_rowsum=True)
    e = [max_err(torch, kern.pim_matmul_fused_cuda(a, w, a_s, w_s),
                 ref.pim_matmul_fused_ref(a, w, a_s, w_s)),
         max_err(torch, kern.pim_matmul_fused_cuda(a, w, a_s, w_s, bias),
                 want),
         max_err(torch, out, want), max_err(torch, rs, want_rs)]
    e_int = max_err(torch, kern.pim_matmul_cuda(a, w),
                    ref.pim_matmul_ref(a, w))
    return max(e), e_int, want, want_rs


def yardstick_errors(torch, kern, a, w, a_s, w_s, bias, want, want_rs):
    """The mma.sync kernel the wgmma route replaced, and at w4a4 with N >
    64 the wgmma route on K-major weight planes, bit for bit against the
    plain version (with bias and row-sums)."""
    symbols = [("pim_matmul_fused_mma_sync", w)]
    if a.shape[0] == w.shape[0] == 1 and w.shape[2] > 64:
        symbols.append(("pim_matmul_fused_kmajor",
                        w.transpose(1, 2).contiguous()))
    e = []
    for symbol, planes in symbols:
        out, rs = kern.yardstick_fused(symbol, a, planes, a_s, w_s, bias,
                                       want_rowsum=True)
        e += [max_err(torch, out, want), max_err(torch, rs, want_rs)]
    return max(e), [s for s, _ in symbols]


def sass_check(runtime):
    """The wgmma route's kernels hold int8 warpgroup MMAs: ``cuobjdump
    -sass`` of the built library, the IGMMA instructions of each
    instantiation of ``pim_matmul_wgmma_kernel``; raises if one has
    none."""
    tool = Path(runtime._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass",
                           str(runtime.library_path("pim_matmul"))],
                          capture_output=True, text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            current = name if "pim_matmul_wgmma_kernel" in name else None
            if current:
                counts[current] = 0
        elif current and "IGMMA" in line:
            counts[current] += 1
    if not counts or not all(counts.values()):
        raise AssertionError(f"wgmma kernels without IGMMA: {counts}")
    log(f"cuobjdump -sass: {len(counts)} instantiations of "
        f"pim_matmul_wgmma_kernel, {sum(counts.values())} IGMMA "
        f"instructions ({min(counts.values())}-{max(counts.values())} "
        f"each), e.g. {sass_line(sass)}")
    return {"kernels": len(counts), "igmma": sum(counts.values())}


def sass_line(sass):
    """The first IGMMA instruction of a listing, without its address
    and encoding."""
    for line in sass.splitlines():
        if "IGMMA" in line:
            return line.split("*/", 1)[-1].split("/*")[0].strip()
    return ""


def kernel_phase(torch, dev, kern, ref):
    """Every variant against the plain version, bit for bit, on all three
    routes (the small-M shapes also through the tiled yardstick, the wgmma
    shapes also through the mma.sync yardstick and, at w4a4, the K-major
    one); an extreme-value case at decode's M and one on the wgmma route
    that wrap mod 2^32; and the wgmma route's level-overflow case."""
    err = {"pim_matmul_fused": 0.0, "pim_matmul_int": 0.0}
    gen = torch.Generator(device=dev).manual_seed(1)

    def record(e_fused, e_int):
        err["pim_matmul_fused"] = max(err["pim_matmul_fused"], e_fused)
        err["pim_matmul_int"] = max(err["pim_matmul_int"], e_int)

    for label, (m, k, n) in CHECK_SHAPES.items():
        for pa, pw in ((1, 1), (2, 2)):
            a = planes(torch, gen, pa, m, k, dev)
            w = planes(torch, gen, pw, k, n, dev)
            a_s, w_s, bias = scales(torch, gen, m, n, dev)
            e, e_int, want, want_rs = fused_variants(torch, kern, ref, a, w,
                                                     a_s, w_s, bias)
            route = kern.small_m_grid(m, k, n)
            also = ""
            if route[0] == "small_m":
                e = max(e, max_err(
                    torch, tiled_fused(torch, kern, a, w, a_s, w_s, bias),
                    want))
                also = "; the tiled yardstick bit-exact"
            elif route[0] == "wgmma":
                e_y, symbols = yardstick_errors(torch, kern, a, w, a_s, w_s,
                                                bias, want, want_rs)
                e = max(e, e_y)
                also = f"; {', '.join(symbols)} bit-exact"
            record(e, e_int)
            log(f"kernel check {label} M={m} K={k} N={n} w{4 * pw}a{4 * pa}"
                f" {route}: fused, fused+bias, fused+rowsum, int32 all "
                f"bit-exact{also}")
            del a, w, want, want_rs
            torch.cuda.empty_cache()
    # full-range same-signed planes (fault injection can write any int8)
    # overflow int32 at w8a8: the small-M and the wgmma route wrap like
    # the plain version
    for m in (LM_BATCH, 256):
        k, n = HYMBA_DECODE_KN["down"]
        a = planes(torch, gen, 2, m, k, dev, 100, 128)
        w = planes(torch, gen, 2, k, n, dev, 100, 128)
        a_s, w_s, bias = scales(torch, gen, m, n, dev)
        codes = [(p[0].double() + 16 * p[1].double()) for p in (a, w)]
        if not bool(((codes[0] @ codes[1]).abs() > 2 ** 31).all()):
            raise AssertionError("the wrap case does not overflow int32")
        record(*fused_variants(torch, kern, ref, a, w, a_s, w_s, bias)[:2])
        log(f"kernel wrap check M={m} K={k} N={n} w8a8, planes in [100, "
            f"128) {kern.small_m_grid(m, k, n)}: every accumulator beyond "
            "2^31; int32, fused, fused+bias, fused+rowsum bit-exact")
        del a, w, codes
    # each shift level's own sum overflows int32 inside the tensor cores:
    # integer wgmma without .satfinite wraps like the plain version
    m, k, n = LEVEL_OVERFLOW_SHAPE
    if 127 * 127 * k <= 2 ** 31 or kern.small_m_grid(m, k, n)[0] != "wgmma":
        raise AssertionError("the level-overflow case does not overflow a "
                             "level on the wgmma route")
    for p in (1, 2):
        a = torch.full((p, m, k), 127, dtype=torch.int8, device=dev)
        w = torch.full((p, k, n), 127, dtype=torch.int8, device=dev)
        a_s, w_s, bias = scales(torch, gen, m, n, dev)
        record(*fused_variants(torch, kern, ref, a, w, a_s, w_s, bias)[:2])
        log(f"kernel level-overflow check M={m} K={k} N={n} w{4 * p}a{4 * p}"
            f", every plane 127 {kern.small_m_grid(m, k, n)}: each level's "
            f"sum {127 * 127 * k * p} beyond 2^31 wraps; int32, fused, "
            "fused+bias, fused+rowsum bit-exact")
        del a, w
    torch.cuda.empty_cache()
    return err


def analog_kernel_phase(torch, dev, akern, aref):
    """Both analog passes against their plain versions: bit for bit on
    the deterministic path (on the route ``analog_route`` gives, with the
    activation planes as wide as the weights or narrower; the yardstick
    symbols and a second launch bit for bit too), within the NOISY_SHARE
    rule with noise; then the tensor-core route's ADC against the IEEE
    divide."""
    import torch.nn.functional as F
    err = {"analog_fullscale": 0.0, "analog_readout": 0.0}
    noisy = []
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, (m, ka, k, n) in ANALOG_CHECK_SHAPES.items():
        for pa, pw in ((1, 1), (2, 2)):
            a = planes(torch, gen, pa, m, ka, dev)
            w = planes(torch, gen, pw, k, n, dev)
            a_pad = F.pad(a, (0, k - ka))
            a_s, w_s, bias = scales(torch, gen, m, n, dev)
            sweep = ANALOG_SWEEP if label.startswith("ragged") else ((8, 5),)
            for chunk, adc in sweep:
                fs = akern.analog_fullscale_cuda(a, w, chunk=chunk)
                ref_fs = aref.analog_fullscale_ref(a_pad, w, chunk).reshape(1)
                err["analog_fullscale"] = max(
                    err["analog_fullscale"], max_err(torch, fs, ref_fs),
                    max_err(torch, akern.yardstick_fullscale(a, w,
                                                             chunk=chunk),
                            ref_fs))
                for b in (None, bias):
                    kw = dict(chunk=chunk, adc_bits=adc, bias=b)
                    got = akern.analog_readout_cuda(a, w, a_s, w_s, fs, **kw)
                    want = aref.analog_readout_ref(a_pad, w, a_s, w_s, ref_fs,
                                                   chunk, adc, bias=b)
                    again = akern.analog_readout_cuda(a, w, a_s, w_s, fs,
                                                      **kw)
                    yard = akern.yardstick_readout(a, w, a_s, w_s, fs, **kw)
                    err["analog_readout"] = max(
                        err["analog_readout"], max_err(torch, got, want),
                        max_err(torch, again, want),
                        max_err(torch, yard, want))
                log(f"analog check {label} M={m} Ka={ka} Kw={k} N={n} "
                    f"w{4 * pw}a{4 * pa} chunk={chunk} adc={adc}b "
                    f"{akern.analog_route(chunk, False)}: full scale, "
                    "readout, readout+bias, a second launch and the "
                    "yardstick all bit-exact")
            if label in ("ragged", "stage3") and (label, pa) != ("stage3",
                                                                 2):
                noisy.append(noisy_check(torch, akern, aref, label, a, w,
                                         a_s, w_s, pa + pw - 1))
            del a, w, a_pad
            torch.cuda.empty_cache()
    adc_rows = [adc_check(akern, f"{bits}b fs={fs:g}",
                          float(torch.tensor(fs, dtype=torch.float32) *
                                torch.tensor(aref.inv_half_levels(bits),
                                             dtype=torch.float32)))
                for bits in ADC_CHECK_BITS for fs in ADC_CHECK_FULL_SCALES]
    log(f"ADC check: {len(adc_rows)} lsb values x every integer s in "
        f"[-2^22, 2^22]: no quotient differs from __fdiv_rn and no code "
        f"from __float2int_rn(__fdiv_rn) ("
        f"{sum(r['rounded'] for r in adc_rows)} of "
        f"{sum(r['sums'] for r in adc_rows)} in the magic add's range)")
    return err, noisy, adc_rows


def adc_check(akern, label, lsb):
    """The tensor-core route's ADC at one lsb, every integer chunk sum in
    [-2^22, 2^22]; raises on any quotient or code that differs from the
    divide's."""
    bad, rounded = akern.adc_check_cuda(lsb, -(1 << 22), 1 << 22)
    row = {"lsb": lsb, "label": label, "mismatches": bad,
           "rounded": rounded, "sums": (1 << 23) + 1}
    if bad:
        raise AssertionError(f"the tensor-core route's ADC differs from "
                             f"__fdiv_rn + rint: {row}")
    return row


def noisy_check(torch, akern, aref, label, a, w, a_s, w_s, levels):
    """Kernel against plain version with noise on: the same normals, so
    only transcendental ulps may move a code (see NOISY_SHARE)."""
    kw = dict(chunk=8, sigma=NOISE_SIGMA, seed=NOISE_SEED)
    fs = akern.analog_fullscale_cuda(a, w, **kw)
    ref_fs = aref.analog_fullscale_ref(a, w, 8, NOISE_SIGMA,
                                       NOISE_SEED).reshape(1)
    fs_rel = float((fs.double() - ref_fs.double()).abs() / ref_fs.double())
    got = akern.analog_readout_cuda(a, w, a_s, w_s, ref_fs, adc_bits=5, **kw)
    want = aref.analog_readout_ref(a, w, a_s, w_s, ref_fs, 8, 5, NOISE_SIGMA,
                                   NOISE_SEED)
    again = akern.analog_readout_cuda(a, w, a_s, w_s, ref_fs, adc_bits=5,
                                      **kw)
    det = akern.analog_readout_cuda(a, w, a_s, w_s, ref_fs, chunk=8,
                                    adc_bits=5)
    diff = (got.double() - want.double()).abs()
    step = aref.lsb_from_fullscale(ref_fs, 5).double() * a_s.double() * \
        w_s.double()
    moved = diff > 0
    share = float(moved.double().mean())
    max_codes = float((diff / step)[moved].max()) if bool(moved.any()) \
        else 0.0
    result = {"shape": label, "M": a.shape[1], "K": a.shape[2],
              "N": w.shape[2], "planes": [a.shape[0], w.shape[0]],
              "sigma": NOISE_SIGMA, "fullscale_rel_diff": fs_rel,
              "max_abs_diff": float(diff.max()), "share_differing": share,
              "max_diff_in_codes": max_codes,
              "differs_from_deterministic": not torch.equal(got, det)}
    log(f"analog noisy check {label} M={a.shape[1]} K={a.shape[2]} "
        f"N={w.shape[2]} w{4 * w.shape[0]}a{4 * a.shape[0]} sigma "
        f"{NOISE_SIGMA}: full scale rel diff {fs_rel:.3g}, max |diff| "
        f"{result['max_abs_diff']:.6g}, share of outputs differing "
        f"{share:.3g} (max {max_codes:.3g} codes)")
    if fs_rel > 1e-6 or share > NOISY_SHARE or \
            max_codes > 2 * 16 ** (levels - 1) + 1e-3:
        raise AssertionError(f"noisy analog kernel outside the stated "
                             f"tolerance: {result}")
    if not torch.equal(got, again) or torch.equal(got, det):
        raise AssertionError("noisy analog readout is not reproducible, or "
                             "equals the deterministic one")
    return result


def build_model(torch, dev, cnn, workloads, pipeline):
    """Full-width ResNet18 (random weights from seed 0) and the REQUESTS
    batches of synthetic images."""
    layers = workloads.resnet18(100, 32)
    params = cnn.init_cnn(layers, torch.Generator().manual_seed(0),
                          device=dev)
    requests = [torch.from_numpy(pipeline.synthetic_images(
        seed, BATCH, 32, 100)[0]).to(dev) for seed in range(REQUESTS)]
    return layers, params, requests


def serve(torch, fwd, requests, counters):
    """A warm-up, then every request with the launch counts set to 0
    just before and read just after; per-request CUDA-event latency."""
    fwd(requests[0])                                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters)
    logits, lat_ms = [], []
    for x in requests:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits.append(fwd(x))
        end.record()
        end.synchronize()
        lat_ms.append(start.elapsed_time(end))
    launches = read_counts(*counters)
    for out in logits:
        if tuple(out.shape) != (BATCH, 100) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"bad logits {tuple(out.shape)}")
    return logits, lat_ms, launches, torch.cuda.max_memory_allocated()


def main_path(torch, model, cnn, pim, counters):
    """Full-width ResNet18 at w4a4 on exact-cuda: program once, answer
    REQUESTS batches; then the exact-torch and w8a8 checks."""
    layers, params, requests = model
    cfg4 = pim.PimConfig(weight_bits=4, act_bits=4, substrate="exact-cuda")
    t0 = time.perf_counter()
    plans = cnn.plan_cnn_weights(params, layers, cfg4)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    fwd = lambda x, cfg, p: cnn.cnn_forward(params, layers, x, pim=cfg,
                                            plans=p)

    logits, lat_ms, launches, peak = serve(
        torch, lambda x: fwd(x, cfg4, plans), requests, counters)
    routes = route_counts(counters[0], "pim_matmul_fused")
    per_request = len(plans)
    if launches["pim_matmul_fused"] != per_request * REQUESTS or \
            launches["analog_fullscale"] or launches["analog_readout"]:
        raise AssertionError(f"exact path launches {launches}, expected "
                             f"{per_request} fused launches per request "
                             "and no analog launch")
    want_routes = expected_routes(counters[0], plan_shapes(layers, plans),
                                  REQUESTS)
    if routes != want_routes:
        raise AssertionError(f"exact path routes {routes}, expected "
                             f"{want_routes}")
    ref = fwd(requests[0], pim.PimConfig(weight_bits=4, act_bits=4,
                                         substrate="exact-torch"), plans)
    if not torch.equal(ref, logits[0]):
        raise AssertionError("exact-cuda logits differ from exact-torch")
    log(f"exact path: {REQUESTS} requests x {BATCH} images, logits "
        f"({BATCH}, 100) finite, {per_request} fused launches per request "
        f"(by route over the {REQUESTS} requests: {routes}), w4a4 logits "
        "bit-identical to exact-torch")

    cfg8 = pim.PimConfig(weight_bits=8, act_bits=8, substrate="exact-cuda")
    plans8 = cnn.plan_cnn_weights(params, layers, cfg8)
    out8 = fwd(requests[0], cfg8, plans8)
    ref8 = fwd(requests[0], pim.PimConfig(weight_bits=8, act_bits=8,
                                          substrate="exact-torch"), plans8)
    if tuple(out8.shape) != (BATCH, 100) or not torch.equal(out8, ref8):
        raise AssertionError("w8a8 exact-cuda differs from exact-torch")
    floats = cnn.cnn_forward(params, layers, requests[0])
    agree = (floats.argmax(1) == logits[0].argmax(1)).float().mean().item()
    log("w8a8 request: logits bit-identical to exact-torch; w4a4 argmax "
        f"agrees with the float forward on {agree:.3f} of images")

    med = statistics.median(lat_ms)
    numbers = {
        "latency_ms": lat_ms, "latency_ms_median": med,
        "images_per_s": BATCH / (med / 1e3), "program_s": program_s,
        "peak_bytes": peak, "launches": launches,
        "launches_by_route": routes, "launches_per_request": per_request,
        "shapes": plan_shapes(layers, plans),
        "argmax_agreement_with_float": agree,
    }
    return numbers, lambda: fwd(requests[0], cfg4, plans), logits[0]


def layer_rows(spec):
    """Rows of a layer's matmul in one request."""
    return BATCH * (spec.out_h * spec.out_w if hasattr(spec, "out_h")
                    else 1)


def plan_shapes(layers, plans):
    """(M, K, N) as the kernels see them -> launches per request."""
    return Counter((layer_rows(spec), *plans[spec.name].planes.shape[1:])
                   for spec in layers)


def analog_path(torch, model, cnn, pim, counters, exact_logits):
    """Full-width ResNet18 at w4a4 with a 5-bit ADC on analog-cuda,
    deterministic (rng=None): REQUESTS batches, the plain ``analog``
    check, one noisy request and its rerun."""
    layers, params, requests = model
    cfg = pim.PimConfig(weight_bits=4, act_bits=4, adc_bits=5,
                        substrate="analog-cuda")
    plans = cnn.plan_cnn_weights(params, layers, cfg)
    fwd = lambda x, c=cfg, rng=None: cnn.cnn_forward(
        params, layers, x, pim=c, rng=rng, plans=plans)
    logits, lat_ms, launches, peak = serve(torch, fwd, requests, counters)
    akern = counters[1]
    routes = {name: route_counts(akern, name)
              for name in ("analog_fullscale", "analog_readout")}
    per_request = len(plans)
    want_routes = {"mma_sync": per_request * REQUESTS}
    if launches["analog_fullscale"] != per_request * REQUESTS or \
            launches["analog_readout"] != per_request * REQUESTS or \
            launches["pim_matmul_fused"] or launches["pim_matmul_int"] or \
            any(r != want_routes for r in routes.values()):
        raise AssertionError(f"analog path launches {launches} by route "
                             f"{routes}, expected {per_request} of each "
                             "analog pass per request, all on the "
                             "tensor-core route, and no PIM matmul launch")
    plain = fwd(requests[0], pim.PimConfig(weight_bits=4, act_bits=4,
                                           adc_bits=5, substrate="analog"))
    if not torch.equal(plain, logits[0]):
        raise AssertionError("analog-cuda logits differ from analog")
    seeded = lambda: torch.Generator().manual_seed(9)
    noisy = fwd(requests[0], rng=seeded())
    noisy_again = fwd(requests[0], rng=seeded())
    if tuple(noisy.shape) != (BATCH, 100) or \
            not bool(torch.isfinite(noisy).all()) or \
            torch.equal(noisy, logits[0]) or \
            not torch.equal(noisy, noisy_again):
        raise AssertionError("the noisy request is not finite, equals the "
                             "deterministic one, or does not repeat")
    agree = (logits[0].argmax(1) == exact_logits.argmax(1)).float().mean()
    agree_noisy = (noisy.argmax(1) == exact_logits.argmax(1)).float().mean()
    log(f"analog path: {REQUESTS} requests x {BATCH} images, logits "
        f"({BATCH}, 100) finite, {per_request} analog_fullscale + "
        f"{per_request} analog_readout launches per request (by route "
        f"over the {REQUESTS} requests: {routes['analog_readout']}) and no "
        "pim_matmul launch, logits bit-identical to analog; the noisy "
        "request (seed 9) repeats bit for bit; argmax agrees with "
        f"exact-cuda on {agree.item():.3f} of images deterministic, "
        f"{agree_noisy.item():.3f} noisy")
    med = statistics.median(lat_ms)
    numbers = {
        "latency_ms": lat_ms, "latency_ms_median": med,
        "images_per_s": BATCH / (med / 1e3), "peak_bytes": peak,
        "launches": launches, "launches_by_route": routes,
        "launches_per_request": per_request,
        "shapes": analog_shapes(layers, plans),
        "argmax_agreement_with_exact": agree.item(),
        "argmax_agreement_with_exact_noisy": agree_noisy.item(),
    }
    return numbers, lambda: fwd(requests[0])


def analog_shapes(layers, plans):
    """(M, K, N, chunk) as the analog kernels see them -> launches."""
    return Counter((layer_rows(spec), *plans[spec.name].planes.shape[1:],
                    min(plans[spec.name].cfg.wdm_chunk, plans[spec.name].k))
                   for spec in layers)


def capture_analog_inputs(aops, run):
    """The readout pass's inputs at each analog main-path shape, from one
    request, keyed like :func:`analog_shapes` (the weights' K): the
    per-shape numbers time the kernels on the data the main path gives
    them (the activation planes unpadded, K = Ka), whose share of zero
    chunk sums (ReLU zeros) the CUDA-core yardstick's time depends on."""
    seen = {}
    original = aops.analog_readout_cuda

    def recording(a, w, a_s, w_s, fs, *, chunk, **kw):
        seen.setdefault((a.shape[1], w.shape[1], w.shape[2], chunk),
                        (a, w, a_s, w_s, kw.get("bias")))
        return original(a, w, a_s, w_s, fs, chunk=chunk, **kw)

    aops.analog_readout_cuda = recording
    try:
        run()
    finally:
        aops.analog_readout_cuda = original
    return seen


def shape_numbers(torch, dev, kern, ref, shapes, with_bias=True):
    """Per main-path shape: kernel, plain and library times beside the
    bound, at w4a4 (one plane pair), with the main path's bias (the CNN
    path has one, the LM path none). Rows above the small-M limit are
    device times (queued behind a spin kernel, so the wrappers' enqueue
    does not show), the route in turns with the mma.sync yardstick, with
    both bounds; two library yardsticks: torch._int_mm on the planes as
    the port keeps them (N-major) and on a K-major copy, the layout
    cuBLASLt's int8 path takes, each with the epilogue."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for (m, k, n), count in sorted(shapes.items(), key=lambda s: -s[0][0]):
        a = planes(torch, gen, 1, m, k, dev)
        w = planes(torch, gen, 1, k, n, dev)
        a_s, w_s, bias = scales(torch, gen, m, n, dev)
        if not with_bias:
            bias = None
        row = {"M": m, "K": k, "N": n, "launches_per_request": count}
        args = (a, w, a_s, w_s, bias)
        row["fused_plain_ms"] = time_ms(
            torch, lambda: ref.pim_matmul_fused_ref(*args))
        row["int_plain_ms"] = time_ms(
            torch, lambda: ref.pim_matmul_ref(a, w))
        extra = 4 * m + (8 if with_bias else 4) * n
        row["fused_bound_ms"], row["fused_bound_by"] = bound(
            1, 1, m, k, n, 4, extra)
        row["fused_bound_bytes_ms"] = (m * k + k * n + 4 * m * n + extra) \
            / HBM_BYTES_PER_S * 1e3
        row["fused_bound_ops_ms"] = 2.0 * m * k * n / INT8_OPS_PER_S * 1e3
        row["int_bound_ms"], row["int_bound_by"] = bound(1, 1, m, k, n, 4, 0)
        row["route"] = list(kern.small_m_grid(m, k, n))
        w_k = w.transpose(1, 2).contiguous()   # (1, N, K): K-major
        if row["route"][0] == "small_m":
            row["fused_ms"] = time_ms(
                torch, lambda: kern.pim_matmul_fused_cuda(*args))
            row["int_ms"] = time_ms(torch, lambda: kern.pim_matmul_cuda(a, w))
            small_m_times(torch, dev, kern, gen, row, args)
            timer = lambda fn: time_ms(torch, fn)
        else:
            tiled_times(torch, kern, row, args, w_k)
            timer = lambda fn: device_ms(torch, lambda i: fn())
        # torch._int_mm takes M > 16 and K, N multiples of 8
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            for tag, mat in (("", w[0]), ("_kmajor", w_k[0].t())):
                lib_int = lambda mat=mat: torch._int_mm(a[0], mat)
                lib_fused = (lambda f=lib_int: f().float() * a_s * w_s) \
                    if bias is None else \
                    (lambda f=lib_int: f().float() * a_s * w_s + bias)
                max_err(torch, lib_fused(),
                        kern.pim_matmul_fused_cuda(a, w, a_s, w_s, bias))
                row[f"fused_library{tag}_ms"] = timer(lib_fused)
                row[f"int_library{tag}_ms"] = timer(lib_int)
        else:
            for key in ("fused_library_ms", "int_library_ms",
                        "fused_library_kmajor_ms", "int_library_kmajor_ms"):
                row[key] = None
        rows.append(row)
        log(f"shape M={m} K={k} N={n} x{count}/request {row['route']}: "
            f"fused {row['fused_ms']:.4f} ms (bound "
            f"{row['fused_bound_ms']:.4f} ms by {row['fused_bound_by']}: "
            f"bytes {row['fused_bound_bytes_ms']:.4f}, operations "
            f"{row['fused_bound_ops_ms']:.4f}; plain "
            f"{row['fused_plain_ms']:.4f} ms; torch._int_mm + epilogue "
            f"{row['fused_library_ms']}, on a K-major copy "
            f"{row['fused_library_kmajor_ms']}"
            + (f"; tiled yardstick {row['fused_tiled_ms']:.4f} ms; warm in "
               f"L2 {row['fused_warm_ms']:.4f} vs tiled "
               f"{row['fused_tiled_warm_ms']:.4f} ms; host enqueue "
               f"{row['fused_enqueue_ms']:.4f} ms a call"
               if "fused_tiled_ms" in row else "")
            + (f"; mma.sync yardstick {row['fused_mma_sync_ms']:.4f} ms "
               "(device time, turns yardstick, route, route, yardstick: "
               + ", ".join(f"{t:.4f}" for _, t in row["fused_turns_ms"])
               + ")" if "fused_mma_sync_ms" in row else "")
            + (f"; on K-major planes (no transposition) "
               f"{row['fused_kmajor_ms']:.4f} ms"
               if "fused_kmajor_ms" in row else "")
            + f"), int32 {row['int_ms']:.4f} ms")
        del a, w, w_k, args
        torch.cuda.empty_cache()
    return rows


def tiled_times(torch, kern, row, args, w_k):
    """Device times of a row above the small-M limit: the route against
    the mma.sync kernel it replaced in turns (yardstick, route, route,
    yardstick), int32, and at w4a4 with N > 64 the wgmma route on K-major
    weight planes (what a second, K-major copy of the planes would save:
    the transposition)."""
    a, w = args[0], args[1]
    calls = {"route": lambda i: kern.pim_matmul_fused_cuda(*args),
             "mma_sync": lambda i: kern.yardstick_fused(
                 "pim_matmul_fused_mma_sync", *args)}
    turns = [(name, device_ms(torch, calls[name]))
             for name in ("mma_sync", "route", "route", "mma_sync")]
    row["fused_turns_ms"] = turns
    row["fused_ms"] = statistics.mean(t for nm, t in turns if nm == "route")
    row["fused_mma_sync_ms"] = statistics.mean(t for nm, t in turns
                                               if nm == "mma_sync")
    row["int_ms"] = device_ms(torch, lambda i: kern.pim_matmul_cuda(a, w))
    if row["route"][0] == "wgmma" and row["N"] > 64:
        row["fused_kmajor_ms"] = device_ms(torch, lambda i: (
            kern.yardstick_fused("pim_matmul_fused_kmajor", args[0], w_k,
                                 *args[2:])))


def small_m_times(torch, dev, kern, gen, row, args):
    """Device times of a small-M row (queued behind a spin kernel, so the
    wrappers' enqueue does not show), the new route against the tiled
    yardstick: warm, one weight resident in L2; and cold, rotating over
    copies of the weight that exceed the 50 MB L2, as a decode step finds
    its weights, in turns new, tiled, tiled, new. ``fused_ms`` becomes
    the cold time; the wrapper's enqueue time per call stays beside it."""
    a, w, a_s, w_s, bias = args
    m, k, n = row["M"], row["K"], row["N"]
    ws = [w] + [planes(torch, gen, 1, k, n, dev)
                for _ in range(-(-100_000_000 // (k * n)))]
    calls = {
        "new": lambda i: kern.pim_matmul_fused_cuda(a, ws[i % len(ws)], a_s,
                                                    w_s, bias),
        "tiled": lambda i: tiled_fused(torch, kern, a, ws[i % len(ws)], a_s,
                                       w_s, bias)}
    row["fused_enqueue_ms"] = row["fused_ms"]
    row["fused_warm_ms"] = device_ms(torch, lambda i: calls["new"](0))
    row["fused_tiled_warm_ms"] = device_ms(torch, lambda i: calls["tiled"](0))
    cold = [(name, device_ms(torch, calls[name]))
            for name in ("new", "tiled", "tiled", "new")]
    row["fused_cold_turns_ms"] = cold
    row["fused_ms"] = statistics.mean(t for nm, t in cold if nm == "new")
    row["fused_tiled_ms"] = statistics.mean(t for nm, t in cold
                                            if nm == "tiled")


def analog_bound(pa, pw, m, ka, kw, n, chunk, conversions, out_bytes,
                 extra_bytes):
    """Least time (ms) for one analog pass, the largest of three floors:
    each input read once (the activation planes Ka wide, the weight
    planes up to Ka rounded up to a chunk, where every later chunk sum is
    zero) and each output written once at HBM bandwidth; the
    2*Pa*Pw*M*Ka*N multiply-adds at the int8 tensor-core peak; and one
    CUDA-core operation per chunk sum the pass must range or convert at
    the float32 non-tensor peak. It is a floor: a conversion is several
    operations. Returns (ms, "bytes" | "operations")."""
    kw_read = min(kw, -(-ka // chunk) * chunk)
    moved = pa * m * ka + pw * kw_read * n + out_bytes * m * n + extra_bytes
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = max(2.0 * pa * pw * m * ka * n / INT8_OPS_PER_S,
                conversions / FP32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def analog_shape_numbers(torch, akern, aref, shapes, inputs):
    """Per analog main-path shape, on the readout inputs the main path
    gave it (``inputs``: w4a4, 5-bit ADC, the layer's bias, the
    activation planes unpadded): each pass's device time (queued behind a
    spin kernel) in turns with its yardstick, the CUDA-core kernel, on the
    activation planes padded to Kw (yardstick, route, route, yardstick);
    the yardstick on the unpadded planes; the plain versions' times; the
    bound. The ranging pass must form every chunk sum up to Ka; the
    readout pass must convert only the nonzero ones, since a zero sum's
    code is 0. The ADC check runs at the shape's lsb."""
    import torch.nn.functional as F
    rows = []
    for (m, k, n, chunk), count in sorted(shapes.items(),
                                          key=lambda s: -s[0][0]):
        a, w, a_s, w_s, bias = inputs[(m, k, n, chunk)]
        pa, pw, ka = a.shape[0], w.shape[0], a.shape[2]
        a_pad = F.pad(a, (0, k - ka))
        fs = akern.analog_fullscale_cuda(a, w, chunk=chunk)
        nonzero = sum(int(torch.count_nonzero(sums)) for _, _, sums in
                      aref.chunk_sum_blocks(a_pad, w, chunk))
        needed = pa * pw * m * n * (-(-ka // chunk))
        route = akern.analog_route(chunk, False)
        # chunks a kernel forms: up to Ka in whole k16 steps on the
        # tensor-core route, in whole chunks on the CUDA-core one
        formed = -(-ka // chunk) if route == "simt" else \
            min(k, -(-ka // 16) * 16) // chunk
        row = {"M": m, "Ka": ka, "K": k, "N": n, "chunk": chunk,
               "planes": [pa, pw], "launches_per_request": count,
               "route": route,
               "zero_chunk_sum_share": 1.0 - nonzero / (pa * pw * m * n
                                                        * (k // chunk)),
               "chunk_sums_needed": needed, "chunk_sums_nonzero": nonzero,
               "skipped_chunk_share": 1.0 - formed / (k // chunk)}
        row["adc_check"] = adc_check(
            akern, f"shape M={m} Kw={k} N={n}",
            float(aref.lsb_from_fullscale(fs, 5)))
        passes = {
            "fullscale": (
                lambda i: akern.analog_fullscale_cuda(a, w, chunk=chunk),
                lambda i: akern.yardstick_fullscale(a_pad, w, chunk=chunk),
                lambda i: akern.yardstick_fullscale(a, w, chunk=chunk)),
            "readout": (
                lambda i: akern.analog_readout_cuda(
                    a, w, a_s, w_s, fs, chunk=chunk, adc_bits=5, bias=bias),
                lambda i: akern.yardstick_readout(
                    a_pad, w, a_s, w_s, fs, chunk=chunk, adc_bits=5,
                    bias=bias),
                lambda i: akern.yardstick_readout(
                    a, w, a_s, w_s, fs, chunk=chunk, adc_bits=5,
                    bias=bias))}
        for name, (route, yard, yard_unpadded) in passes.items():
            calls = {"route": route, "yardstick": yard}
            turns = [(nm, device_ms(torch, calls[nm], reps=50))
                     for nm in ("yardstick", "route", "route", "yardstick")]
            row[f"{name}_turns_ms"] = turns
            row[f"{name}_ms"] = statistics.mean(t for nm, t in turns
                                                if nm == "route")
            row[f"{name}_yardstick_ms"] = statistics.mean(
                t for nm, t in turns if nm == "yardstick")
            row[f"{name}_yardstick_unpadded_ms"] = device_ms(
                torch, yard_unpadded, reps=50)
        row["fullscale_plain_ms"] = time_ms(
            torch, lambda: aref.analog_fullscale_ref(a_pad, w, chunk),
            budget_ms=150.0)
        row["readout_plain_ms"] = time_ms(
            torch, lambda: aref.analog_readout_ref(
                a_pad, w, a_s, w_s, fs, chunk, 5, bias=bias), budget_ms=150.0)
        row["fullscale_bound_ms"], row["fullscale_bound_by"] = analog_bound(
            pa, pw, m, ka, k, n, chunk, needed, 0, 4)
        row["readout_bound_ms"], row["readout_bound_by"] = analog_bound(
            pa, pw, m, ka, k, n, chunk, nonzero, 4, 4 * m + 8 * n + 4)
        row["fullscale_library_ms"] = row["readout_library_ms"] = None
        rows.append(row)
        log(f"analog shape M={m} Ka={ka} Kw={k} N={n} chunk={chunk} "
            f"x{count}/request {row['route']} (zero chunk sums "
            f"{row['zero_chunk_sum_share']:.3f}, chunks past Ka never formed "
            f"{row['skipped_chunk_share']:.3f}):"
            + "".join(
                f" {nm} {row[f'{nm}_ms']:.4f} ms (yardstick on padded "
                f"planes {row[f'{nm}_yardstick_ms']:.4f}, turns "
                + ", ".join(f"{t:.4f}" for _, t in row[f"{nm}_turns_ms"])
                + f"; on unpadded {row[f'{nm}_yardstick_unpadded_ms']:.4f};"
                f" bound {row[f'{nm}_bound_ms']:.4f} by "
                f"{row[f'{nm}_bound_by']}; plain {row[f'{nm}_plain_ms']:.4f})"
                for nm in ("fullscale", "readout")))
        del a_pad
    return rows


PROFILED = (  # (module, attribute, range name) wrapped while profiling
    ("cnn", "_im2col", "im2col"),
    ("pim", "_quantize_activations", "quantize+nibbles"),
    ("pim", "_pad_act_planes", "pad activation planes"),
)


# B1's routes above the small-M limit: the wgmma kernel, and the mma.sync
# one for ResNet18's fc (N = 100)
PIM_KERNELS = {"pim_matmul kernel": ("pim_matmul_wgmma_kernel",
                                     "pim_matmul_kernel")}
ANALOG_KERNELS = {  # demangled and mangled template names of each pass
    "analog_fullscale kernel": ("analog_mma_kernel<false",
                                "analog_mma_kernelILb0"),
    "analog_readout kernel": ("analog_mma_kernel<true",
                              "analog_mma_kernelILb1"),
}


def profile_request(torch, modules, run, kernels, what, profiled=PROFILED,
                    nested=None):
    """Device time of one request by stage, and the device's idle share,
    from torch.profiler. The stages are named ranges wrapped around the
    port's functions for this run only (``profiled``: module key,
    attribute, label), plus each kernel of ``kernels`` (label -> name
    fragments) by name; ``nested`` maps a stage's label to the labels of
    stages inside it, whose time it does not count. "other" is the rest of
    the busy time (on the CNN path relu, residual adds, pooling, means,
    bias padding, output allocation and slicing)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(fn, label):
        def wrapper(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    saved = [(modules[m], attr, getattr(modules[m], attr))
             for m, attr, _ in profiled]
    for (mod, attr, fn), (_, _, label) in zip(saved, profiled):
        setattr(mod, attr, ranged(fn, label))
    try:
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    events = list(prof.events())
    labels = {label for _, _, label in profiled}
    # the ranges also appear on the device timeline as user annotations
    # that span from their first kernel to their last, idle gaps
    # included; they are not device work
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and e.name not in labels]
    if not device:
        log("profile: the profiler saw no device activity; device busy "
            "time and stage breakdown not measured")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = max(e.time_range.end for e in events) - \
        min(e.time_range.start for e in events)
    # a stage is the device time of the kernels launched inside its
    # host-side range (the profiler's correlation of launch and kernel)
    stages = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.name in labels:
            stages[e.name] = stages.get(e.name, 0.0) + e.device_time_total
    by_name = Counter()
    launches = Counter()
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us()
        launches[e.name] += 1
    top = [{"kernel": name[:120], "ms": us / 1e3, "count": launches[name]}
           for name, us in by_name.most_common(12)]
    for label, fragments in kernels.items():
        stages[label] = sum(e.time_range.elapsed_us() for e in device
                            if any(f in e.name for f in fragments))
        if not stages[label]:
            raise AssertionError(f"the profile of one {what} request shows "
                                 f"no {label}")
    for outer, inner in (nested or {}).items():
        stages[outer] = stages.get(outer, 0.0) - sum(stages[k] for k in inner)
    stages = {k: v / 1e3 for k, v in stages.items()}
    stages["other"] = busy / 1e3 - sum(stages.values())
    result = {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
              "device_idle_share": 1.0 - busy / window,
              "device_events": len(device), "stages_ms": stages,
              "top_device_events": top}
    log(f"profile of one {what} request: device busy {busy / 1e3:.3f} ms "
        f"of a "
        f"{window / 1e3:.3f} ms profiled window (idle share "
        f"{result['device_idle_share']:.3f}, {len(device)} device events);"
        " by stage: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
    log("  top device events: " + "; ".join(
        f"{t['kernel'][:60]} {t['ms']:.3f} ms x{t['count']}" for t in top))
    return result


def kernel_entry(name, prefix, rows, launches, err, source=KERNEL_SOURCE,
                 per=None, path="resnet18 exact", routes=None):
    """Per-request totals over the path's launches of each shape; for
    B1 also the mma.sync yardstick's, the K-major library call's and the
    launches by route."""
    tot = lambda key: sum(r[key] * r["launches_per_request"] for r in rows)
    lib_rows = [r for r in rows if r[f"{prefix}_library_ms"] is not None]
    extra = {}
    if any(f"{prefix}_mma_sync_ms" in r for r in rows):
        extra["yardstick_ms"] = sum(
            r[f"{prefix}_mma_sync_ms"] * r["launches_per_request"]
            for r in rows if f"{prefix}_mma_sync_ms" in r)
    if lib_rows and f"{prefix}_library_kmajor_ms" in lib_rows[0]:
        extra["library_kmajor_ms"] = sum(
            r[f"{prefix}_library_kmajor_ms"] * r["launches_per_request"]
            for r in lib_rows)
    if routes is not None:
        extra["launches_by_route"] = routes
    bound_by = Counter()
    for r in rows:
        bound_by[r[f"{prefix}_bound_by"]] += \
            r[f"{prefix}_bound_ms"] * r["launches_per_request"]
    return {
        "name": name, "path": path, "route": "cuda", "source": source,
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": err[name], "ms": tot(f"{prefix}_ms"),
        "plain_ms": tot(f"{prefix}_plain_ms"),
        "bound_ms": tot(f"{prefix}_bound_ms"),
        "bound_by": bound_by.most_common(1)[0][0],
        "library_ms": sum(r[f"{prefix}_library_ms"]
                          * r["launches_per_request"] for r in lib_rows)
        if lib_rows else None,
        "per": per or (
            "one request (batch 128): sum over the 21 main-path layer "
            "shapes, device times; library_ms is torch._int_mm on the "
            "planes as the port keeps them (N-major) with the epilogue, "
            "library_kmajor_ms the same on a K-major copy, both over the "
            "shapes torch._int_mm takes "
            f"({sum(r['launches_per_request'] for r in lib_rows)} of 21)"),
        **extra,
    }


ANALOG_PER = ("one analog-path request (batch 128, w4a4, 5-bit ADC): sum "
              "over the 21 layer shapes, each timed on the inputs the "
              "path gave it (device time, queued behind a spin kernel); "
              "yardstick_ms is the CUDA-core kernel the tensor-core route "
              "replaced (the library's analog_*_simt symbol, which no "
              "wrapper calls) on the activation planes padded to Kw, "
              "timed in turns with the route; "
              "yardstick_unpadded_ms the same kernel on the unpadded "
              "planes; bound_ms reads the weight planes up to Ka rounded "
              "up to a chunk and counts one conversion per nonzero chunk "
              "sum for the readout pass, one per chunk sum up to Ka for "
              "the ranging pass; library_ms is null because no single PyTorch call "
              "computes the per-chunk ADC readout chain (chunk sums, shared "
              "full scale, per-chunk rounding, code sums)")


def analog_entries(rows, apath, err):
    """The two analog passes' lines: B1's fields, plus each pass's
    yardsticks and launches by route."""
    entries = []
    for name, prefix in (("analog_fullscale", "fullscale"),
                         ("analog_readout", "readout")):
        entry = kernel_entry(name, prefix, rows, apath["launches"], err,
                             source=ANALOG_SOURCE, per=ANALOG_PER,
                             path="resnet18 analog",
                             routes=apath["launches_by_route"][name])
        for key in ("yardstick", "yardstick_unpadded"):
            entry[f"{key}_ms"] = sum(r[f"{prefix}_{key}_ms"]
                                     * r["launches_per_request"]
                                     for r in rows)
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# The LM paths: the SSD scan kernel, hymba-1.5b served on the PIM engine,
# the serve() entry point, mamba2-370m
# ---------------------------------------------------------------------------
def ssd_inputs(torch, dev, bh, l, p, n, seed, decay=None):
    """x, a, b, c as the tests make them: unit normals, decays
    sigmoid(z + 2) (or a constant), b and c scaled by 1/sqrt(N)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((bh, l, p), generator=gen, device=dev)
    a = torch.sigmoid(torch.randn((bh, l), generator=gen, device=dev) + 2.0) \
        if decay is None else torch.full((bh, l), decay, device=dev)
    b = torch.randn((bh, l, n), generator=gen, device=dev) / n ** 0.5
    c = torch.randn((bh, l, n), generator=gen, device=dev) / n ** 0.5
    return x, a, b, c


def ssd_plain(sref, x, a, b, c, chunk):
    """The kernel's plain version: the chunked form, or the sequential
    recurrence for a ragged length (what the ops route takes on the CPU)."""
    if x.shape[1] % chunk:
        return sref.ssd_scan_ref(x, a, b, c)
    return sref.ssd_chunked_ref(x, a, b, c, chunk)


def ssd_bound(bh, l, p, n, chunk):
    """Least times (ms) of one scan: the bytes of x, a, b, c read once and
    y and the final state written once, at HBM bandwidth; the float32
    multiply-adds the chunked form needs (the causal half of the two
    Q x Q products, the inter-chunk product and the state update, for the
    chunk lengths of this L) at the CUDA cores' peak, and as 3xTF32 (three
    TF32 tensor-core products each, at a third of the dense TF32 peak),
    which is what the kernel runs. Returns (ms, "bytes" | "operations",
    {"bytes_ms", "cuda_core_ms", "tf32x3_ms"}), ms that of the kernel:
    the larger of the bytes and the 3xTF32 time."""
    moved = 4 * bh * (2 * l * p + l + 2 * l * n + n * p)
    flops = 0
    for start in range(0, l, chunk):
        q = min(chunk, l - start)
        tri = q * (q + 1) // 2
        flops += 2 * (tri * n + tri * p + 2 * q * n * p)
    flops *= bh
    parts = {"bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
             "cuda_core_ms": flops / FP32_OPS_PER_S * 1e3,
             "tf32x3_ms": flops / (TF32_OPS_PER_S / 3) * 1e3}
    by_bytes = parts["bytes_ms"] >= parts["tf32x3_ms"]
    return max(parts["bytes_ms"], parts["tf32x3_ms"]), \
        ("bytes" if by_bytes else "operations"), parts


def ssd_gap(torch, got, want):
    """Max |got - want| over (y, state), raising outside the stated
    tolerance |got - want| <= SSD_ATOL + SSD_RTOL * |want|."""
    gap = 0.0
    for g, w in zip(got, want):
        diff = (g.double() - w.double()).abs()
        limit = SSD_ATOL + SSD_RTOL * w.double().abs()
        if not bool(torch.isfinite(g).all()) or bool((diff > limit).any()):
            raise AssertionError(
                f"SSD kernel outside rtol {SSD_RTOL}, atol {SSD_ATOL} of its "
                f"plain version: max |diff| {diff.max().item()}, worst "
                f"excess {(diff - limit).max().item()}")
        gap = max(gap, diff.max().item())
    return gap


def ssd_time_row(torch, skern, sref, label, args, chunk, count):
    """Times of one scan on ``args``: the kernel's device time in turns
    with the serial CUDA-core kernel it replaced (yardstick, kernel,
    kernel, yardstick; queued behind a spin kernel, so the ctypes
    wrappers' enqueue does not show), the plain version's, and the
    bounds."""
    x = args[0]
    bh, l, p = x.shape
    n = args[2].shape[-1]
    row = {"shape": label, "BH": bh, "L": l, "P": p, "N": n, "chunk": chunk,
           "launches_per_request": count}
    calls = {"kernel": lambda i: skern.ssd_scan_cuda(*args, chunk),
             "serial": lambda i: skern.yardstick_serial(*args, chunk)}
    turns = [(name, device_ms(torch, calls[name], reps=50))
             for name in ("serial", "kernel", "kernel", "serial")]
    row["turns_ms"] = turns
    row["ms"] = statistics.mean(t for nm, t in turns if nm == "kernel")
    row["serial_ms"] = statistics.mean(t for nm, t in turns
                                       if nm == "serial")
    row["plain_ms"] = time_ms(torch, lambda: ssd_plain(sref, *args, chunk))
    row["bound_ms"], row["bound_by"], parts = ssd_bound(bh, l, p, n, chunk)
    row.update({f"bound_{k}": v for k, v in parts.items()})
    log(f"ssd_scan {label} BH={bh} L={l} P={p} N={n} Q={chunk}: kernel "
        f"{row['ms']:.4f} ms device time (turns serial, kernel, kernel, "
        f"serial: " + ", ".join(f"{t:.4f}" for _, t in turns) + " ms; the "
        f"serial yardstick {row['serial_ms']:.4f} ms), plain "
        f"{row['plain_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms by "
        f"{row['bound_by']} (bytes {parts['bytes_ms']:.4f} ms, 3xTF32 "
        f"{parts['tf32x3_ms']:.4f} ms, CUDA-core float32 "
        f"{parts['cuda_core_ms']:.4f} ms)")
    return row


def ssd_kernel_phase(torch, dev, skern, sref):
    """(a) The SSD kernel against its plain version on every SSD_CHECKS
    shape, and against the sequential recurrence too; then its time at
    each shape."""
    err, rows = 0.0, []
    for seed, (label, (bh, l, p, n, q, decay)) in enumerate(
            SSD_CHECKS.items()):
        args = ssd_inputs(torch, dev, bh, l, p, n, seed, decay)
        got = skern.ssd_scan_cuda(*args, q)
        torch.cuda.synchronize()
        gap = ssd_gap(torch, got, ssd_plain(sref, *args, q))
        gap_seq = ssd_gap(torch, got, sref.ssd_scan_ref(*args))
        again = skern.ssd_scan_cuda(*args, q)
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"ssd check {label}: two launches on the "
                                 "same inputs differ")
        err = max(err, gap)
        log(f"ssd check {label} BH={bh} L={l} P={p} N={n} Q={q}"
            + (f" a={decay}" if decay else "") + f": within rtol "
            f"{SSD_RTOL}, atol {SSD_ATOL} of the plain version (max |diff| "
            f"{gap:.3g}) and of the sequential recurrence ({gap_seq:.3g}); "
            "a second launch bit for bit")
        rows.append(ssd_time_row(torch, skern, sref, label, args, q, 0))
        del args, got, again
        torch.cuda.empty_cache()
    return err, rows


def capture_ssd_inputs(sops, run):
    """The SSD kernel's inputs at its first launch in ``run``."""
    seen = []
    original = sops.ssd_scan_cuda

    def recording(x, a, b, c, chunk):
        if not seen:
            seen.append(((x, a, b, c), chunk))
        return original(x, a, b, c, chunk)

    sops.ssd_scan_cuda = recording
    try:
        run()
    finally:
        sops.ssd_scan_cuda = original
    return seen[0]


def lm_tokens(torch, dev, vocab):
    """The prompt batch serve() makes: numpy's default_rng(0)."""
    import numpy as np
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(
        0, vocab, size=(LM_BATCH, LM_PROMPT))).to(dev)


def logit_gap(torch, got, want, vocab, what, tol=None):
    """Max |gap| of two (B, V) logit tensors over the first ``vocab``
    entries (the rest are the -1e30 vocab padding) and their greedy
    agreement; with ``tol``, raise unless |gap| <= tol * max |want|."""
    got, want = got[:, :vocab], want[:, :vocab]
    gap = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).double().mean().item()
    log(f"{what}: max |logit gap| {gap:.4g} (max |logit| {scale:.4g}), "
        f"greedy agreement {agree:.3f}")
    if not bool(torch.isfinite(got).all()) or \
            (tol is not None and gap > tol * scale):
        raise AssertionError(f"{what}: gap {gap} above {tol} x {scale}")
    return {"max_abs_gap": gap, "max_abs_logit": scale,
            "greedy_agreement": agree}


def with_substrate(planned, substrate):
    """The planned tree with every plan re-stamped to ``substrate`` (an
    expert stack's shared config sits on its ``dense`` plan)."""
    if isinstance(planned, dict):
        return {k: with_substrate(v, substrate) for k, v in planned.items()}
    if isinstance(planned, list):
        return [restamp(p, substrate) for p in planned]
    return planned


def restamp(plan, substrate):
    import dataclasses
    if hasattr(plan, "dense"):
        return dataclasses.replace(plan, dense=restamp(plan.dense, substrate))
    return dataclasses.replace(plan, cfg=dataclasses.replace(
        plan.cfg, substrate=substrate))


def layer_plans(planned):
    """Every plan of a planned layer tree (the per-layer lists)."""
    if isinstance(planned, dict):
        return [p for v in planned.values() for p in layer_plans(v)]
    return list(planned) if isinstance(planned, list) else []


def lm_plan_shapes(planned):
    """(M, K, N) as the PIM kernel sees them -> launches per request
    (one prefill of B * S rows, LM_GEN decode steps of B rows); an expert
    stack launches once per expert."""
    shapes = Counter()
    for plan in layer_plans(planned["layers"]):
        k, n = getattr(plan, "dense", plan).planes.shape[-2:]
        count = getattr(plan, "num_experts", 1)
        shapes[(LM_BATCH * LM_PROMPT, k, n)] += count
        shapes[(LM_BATCH, k, n)] += LM_GEN * count
    return shapes


def b1_by_phase(rows, what="hymba"):
    """B1's time per ``what`` request split into prefill (the wgmma route,
    beside the mma.sync yardstick, the wgmma route on K-major planes, the
    two library calls and the bound) and decode (small-M route, with the
    tiled yardstick at the same shapes), each the per-shape time times the
    launches."""
    keys = ("prefill_ms", "prefill_mma_sync_ms", "prefill_kmajor_ms",
            "prefill_library_ms", "prefill_library_kmajor_ms",
            "prefill_bound_ms", "prefill_bound_bytes_ms",
            "prefill_bound_ops_ms", "decode_ms", "decode_tiled_ms",
            "decode_bound_ms")
    split = dict.fromkeys(keys, 0.0)
    for r in rows:
        count = r["launches_per_request"]
        if r["route"][0] == "small_m":
            split["decode_ms"] += r["fused_ms"] * count
            split["decode_tiled_ms"] += r["fused_tiled_ms"] * count
            split["decode_bound_ms"] += r["fused_bound_ms"] * count
            continue
        for key, src in (("prefill_ms", "fused_ms"),
                         ("prefill_mma_sync_ms", "fused_mma_sync_ms"),
                         ("prefill_kmajor_ms", "fused_kmajor_ms"),
                         ("prefill_library_ms", "fused_library_ms"),
                         ("prefill_library_kmajor_ms",
                          "fused_library_kmajor_ms"),
                         ("prefill_bound_ms", "fused_bound_ms"),
                         ("prefill_bound_bytes_ms", "fused_bound_bytes_ms"),
                         ("prefill_bound_ops_ms", "fused_bound_ops_ms")):
            if r.get(src) is not None:  # hymba's prefill rows have all
                split[key] += r[src] * count
    log(f"B1 per {what} request: prefill {split['prefill_ms']:.3f} ms on "
        f"the wgmma route (the mma.sync yardstick "
        f"{split['prefill_mma_sync_ms']:.3f} ms; on K-major planes, no "
        f"transposition, {split['prefill_kmajor_ms']:.3f} ms; torch._int_mm"
        f" + epilogue {split['prefill_library_ms']:.3f} ms, on a K-major "
        f"copy {split['prefill_library_kmajor_ms']:.3f} ms; bound "
        f"{split['prefill_bound_ms']:.3f} ms: operations "
        f"{split['prefill_bound_ops_ms']:.3f}, bytes "
        f"{split['prefill_bound_bytes_ms']:.3f}); decode "
        f"{split['decode_ms']:.3f} ms on the small-M route (tiled yardstick"
        f" {split['decode_tiled_ms']:.3f} ms, bound "
        f"{split['decode_bound_ms']:.3f} ms)")
    return split


# the small-M threshold: hymba's decode shapes at these M, each route that
# takes them; launches of each shape in one decode step (32 layers)
THRESHOLD_M = (64, 128)
DECODE_STEP_COUNT = {"qo": 64, "kv": 64, "gate_up": 64, "down": 32}


def threshold_rows(torch, dev, kern):
    """The small-M route and the two tiled routes at M = 64 and 128 on
    hymba's decode shapes (the small-M route takes M <= 64 only): device
    times with cold weights (rotating over copies that exceed the 50 MB
    L2, as a decode step finds them), each route in turn, and the sum
    over one decode step's launches. Reported only: SMALL_M_MAX stays."""
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {"rows": [], "per_step_ms": {}}
    for m in THRESHOLD_M:
        for lb, (k, n) in HYMBA_DECODE_KN.items():
            a = planes(torch, gen, 1, m, k, dev)
            a_s, w_s, _ = scales(torch, gen, m, n, dev)
            ws = [planes(torch, gen, 1, k, n, dev)
                  for _ in range(-(-100_000_000 // (k * n)) + 1)]
            calls = {
                "wgmma": lambda i: kern.yardstick_fused(
                    "pim_matmul_fused_tiled", a, ws[i % len(ws)], a_s, w_s),
                "mma_sync": lambda i: kern.yardstick_fused(
                    "pim_matmul_fused_mma_sync", a, ws[i % len(ws)], a_s,
                    w_s)}
            if m <= kern.SMALL_M_MAX:
                calls["small_m"] = lambda i: kern.pim_matmul_fused_cuda(
                    a, ws[i % len(ws)], a_s, w_s)
            row = {"M": m, "K": k, "N": n, "shape": lb,
                   "route": kern.small_m_grid(m, k, n)[0],
                   "ms": {name: device_ms(torch, fn)
                          for name, fn in calls.items()}}
            out["rows"].append(row)
            for name, t in row["ms"].items():
                key = f"m{m}_{name}"
                out["per_step_ms"][key] = out["per_step_ms"].get(key, 0.0) \
                    + t * DECODE_STEP_COUNT[lb]
            del a, ws
    torch.cuda.empty_cache()
    log("B1 small-M threshold, hymba decode shapes, device time with cold "
        "weights: " + "; ".join(
            f"M={r['M']} {r['shape']} (wrappers take {r['route']}) "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["ms"].items())
            for r in out["rows"])
        + "; per decode step of 224 launches: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in out["per_step_ms"].items()))
    return out


def lm_kernel_checks(torch, dev, kern, ref, shapes):
    """The PIM kernel at the LM path's shapes (w4a4, no bias, as serving
    drives it), bit for bit against its plain version."""
    err = 0.0
    gen = torch.Generator(device=dev).manual_seed(4)
    for m, k, n in sorted(shapes):
        a = planes(torch, gen, 1, m, k, dev)
        w = planes(torch, gen, 1, k, n, dev)
        a_s, w_s, _ = scales(torch, gen, m, n, dev)
        err = max(err, max_err(torch, kern.pim_matmul_fused_cuda(
            a, w, a_s, w_s), ref.pim_matmul_fused_ref(a, w, a_s, w_s)))
    log(f"kernel check at the {len(shapes)} LM path shapes (w4a4, no bias):"
        " fused bit-exact")
    return err


def lm_serve_requests(torch, serve_mod, params, cfg, tokens, counters):
    """A warm-up, then LM_REQUESTS requests through the static serving
    loop, launch counts set to 0 just before and read just after;
    per-request prefill and decode times (CUDA events)."""
    serve_mod.static_loop(params, cfg, tokens, LM_GEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters)
    outs = [serve_mod.static_loop(params, cfg, tokens, LM_GEN)
            for _ in range(LM_REQUESTS)]
    torch.cuda.synchronize()
    launches = read_counts(*counters)
    for generated, _, _, logits in outs:
        if tuple(generated.shape) != (LM_BATCH, LM_GEN) or \
                tuple(logits.shape) != (LM_BATCH, cfg.padded_vocab) or \
                not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
            raise AssertionError("bad serve output")
        if not torch.equal(generated, outs[0][0]):
            raise AssertionError("repeated requests generated other tokens")
    prefill_ms = [o[1] * 1e3 for o in outs]
    decode_ms = [o[2] * 1e3 / LM_GEN for o in outs]
    request_ms = [p + d * LM_GEN for p, d in zip(prefill_ms, decode_ms)]
    return outs[0], {
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "prefill_ms_median": statistics.median(prefill_ms),
        "decode_ms_per_token_median": statistics.median(decode_ms),
        "request_ms_median": statistics.median(request_ms),
        "tokens_per_s": LM_BATCH * LM_GEN
        / (statistics.median(request_ms) / 1e3),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches}


def phase_counts(torch, lm, params, cfg, tokens, counters):
    """Launch counts of one prefill and of one decode step alone."""
    reset_counts(*counters)
    logits, cache = lm.prefill(params, cfg, {"tokens": tokens},
                               LM_PROMPT + LM_GEN)
    torch.cuda.synchronize()
    pre = read_counts(*counters)
    reset_counts(*counters)
    lm.decode_step(params, cfg, cache, logits.argmax(-1)[:, None],
                   LM_PROMPT)
    torch.cuda.synchronize()
    return pre, read_counts(*counters)


LM_PROFILED = (  # (module, attribute, range name) wrapped while profiling
    ("pim", "_quantize_activations", "quantize+nibbles"),
    ("attention", "_sdpa", "attention"),
    ("ssm", "ssm_apply", "ssm glue"),
    ("ssm", "ssm_step", "ssm glue"),
    ("ssm", "_project", "ssm in-projections (float32 GEMMs)"),
)
LM_KERNELS = {"pim_matmul kernel, wgmma route (prefill)":
              ("pim_matmul_wgmma_kernel",),
              "pim_matmul kernel, small-M route (decode)":
              ("pim_matmul_small_m_kernel",),
              "ssd_scan kernel": ("ssd_chunk_kernel", "ssd_state_kernel",
                                  "ssd_inter_kernel")}
# hymba's decode-step replay: 7 projections in each of 32 layers
DECODE_STEP_LAUNCHES = 7 * 32


def device_events(torch, prof):
    """The profile's device activities (kernels, memsets, copies), without
    the user annotations that also appear on the device timeline."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def capture_decode_step(torch, pops, lm, planned, cfg, tokens):
    """The inputs of every pim_matmul_fused launch of one decode step of
    the path (the first step after the prompt), and that step's device
    profile, which must show one small-M kernel per launch and no tiled
    one."""
    from torch.profiler import ProfilerActivity, profile
    logits, cache = lm.prefill(planned, cfg, {"tokens": tokens},
                               LM_PROMPT + LM_GEN)
    tok = logits.argmax(-1)[:, None]
    seen = []
    original = pops.pim_matmul_fused_cuda

    def recording(a, w, a_s, w_s, bias=None, want_rowsum=False):
        seen.append((a, w, a_s, w_s, bias, want_rowsum))
        return original(a, w, a_s, w_s, bias, want_rowsum=want_rowsum)

    torch.cuda.synchronize()
    pops.pim_matmul_fused_cuda = recording
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lm.decode_step(planned, cfg, cache, tok, LM_PROMPT)
            torch.cuda.synchronize()
    finally:
        pops.pim_matmul_fused_cuda = original
    events = device_events(torch, prof)
    small = [e for e in events if "pim_matmul_small_m_kernel" in e.name]
    tiled = [e for e in events if "pim_matmul_kernel" in e.name
             or "pim_matmul_wgmma_kernel" in e.name]
    if len(seen) != DECODE_STEP_LAUNCHES or any(c[5] for c in seen) or \
            len(small) != DECODE_STEP_LAUNCHES or tiled:
        raise AssertionError(
            f"one decode step: {len(seen)} pim_matmul_fused calls, "
            f"{len(small)} small-M and {len(tiled)} tiled device kernels; "
            f"expected {DECODE_STEP_LAUNCHES} small-M kernels")
    return seen, {"small_m_kernels": len(small),
                  "small_m_device_ms": sum(e.time_range.elapsed_us()
                                           for e in small) / 1e3,
                  "device_events": len(events)}


def decode_replay(torch, kern, ref, calls):
    """One decode step's PIM launches replayed back to back on the device
    (queued behind a spin kernel): the small-M route and the tiled
    yardstick in turns new, tiled, tiled, new, against the step's bytes
    bound; every launch of the two routes bit for bit equal to the plain
    version; and the replay's profile, which must hold the launches'
    kernels and nothing else (no memset, no second pass)."""
    from torch.profiler import ProfilerActivity, profile
    for a, w, a_s, w_s, bias, _ in calls:
        want = ref.pim_matmul_fused_ref(a, w, a_s, w_s, bias)
        max_err(torch, kern.pim_matmul_fused_cuda(a, w, a_s, w_s, bias), want)
        max_err(torch, tiled_fused(torch, kern, a, w, a_s, w_s, bias), want)
    routes = {
        "new": lambda i: [kern.pim_matmul_fused_cuda(*c[:5]) for c in calls],
        "tiled": lambda i: [tiled_fused(torch, kern, *c[:5])
                            for c in calls]}
    turns = [(name, device_ms(torch, routes[name], reps=3))
             for name in ("new", "tiled", "tiled", "new")]
    torch.cuda.synchronize()
    # the launches queue behind a spin kernel (left out below), so the
    # tracer is running before the first of them reaches the device
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        routes["new"](0)
        torch.cuda.synchronize()
    # the tracer does not always record every one of the queued kernels
    # (the decode step's own profile holds the exact count); what it
    # records must all be the launches' own kernels
    events = [e for e in device_events(torch, prof)
              if "spin_kernel" not in e.name]
    if not events or len(events) > len(calls) or any(
            "pim_matmul_small_m_kernel" not in e.name for e in events):
        raise AssertionError(
            f"the replayed step's {len(calls)} launches ran "
            f"{len(events)} device activities: "
            f"{Counter(e.name[:60] for e in events).most_common(4)}")
    bound_ms = sum(bound(a.shape[0], w.shape[0], a.shape[1], a.shape[2],
                         w.shape[2], 4, 4 * a.shape[1]
                         + (8 if bias is not None else 4) * w.shape[2])[0]
                   for a, w, _, _, bias, _ in calls)
    plane_bytes = sum(w.numel() for _, w, _, _, _, _ in calls)
    out = {"launches": len(calls), "turns_ms": turns,
           "ms": statistics.mean(t for n, t in turns if n == "new"),
           "tiled_ms": statistics.mean(t for n, t in turns if n == "tiled"),
           "bound_ms": bound_ms, "plane_bytes": plane_bytes,
           "device_activities": len(events)}
    log(f"hymba decode-step replay ({len(calls)} launches, "
        f"{plane_bytes / 1e9:.3f} GB of weight planes): small-M route "
        f"{out['ms']:.4f} ms, tiled yardstick {out['tiled_ms']:.4f} ms "
        f"(turns " + ", ".join(f"{n} {t:.4f}" for n, t in turns)
        + f"), bytes bound {bound_ms:.4f} ms; both routes bit-exact on "
        f"every launch; the replay's profile recorded {len(events)} device "
        "activities, all small-M kernels (no memset, no second pass)")
    return out


def hymba_path(torch, dev, mods, counters):
    """(b) hymba-1.5b at full width (32 layers, d_model 1600), random
    weights from seed 0, programmed once at w4a4 on exact-cuda, served
    with ssd_backend="cuda": launch counts, the float-path and PIM-path
    comparisons with the chunked route, exact-cuda against exact-torch,
    and the numbers."""
    import dataclasses
    lm, serve_mod, pim, configs = (mods["lm"], mods["serve"], mods["pim"],
                                   mods["configs"])
    cfg = dataclasses.replace(configs.get_config("hymba-1.5b"),
                              ssd_backend="cuda")
    chunked = dataclasses.replace(cfg, ssd_backend="chunked")
    params = lm.init_lm(cfg, 0, device=dev)
    tokens = lm_tokens(torch, dev, cfg.vocab_size)
    out = {"config": {"arch": cfg.name, "layers": cfg.num_layers,
                      "d_model": cfg.d_model, "batch": LM_BATCH,
                      "prompt": LM_PROMPT, "gen": LM_GEN, "bits": "w4a4"}}

    float_kernel, _ = lm.prefill(params, cfg, {"tokens": tokens},
                                 LM_PROMPT + LM_GEN)
    float_plain, _ = lm.prefill(params, chunked, {"tokens": tokens},
                                LM_PROMPT + LM_GEN)
    out["float_prefill_cuda_vs_chunked"] = logit_gap(
        torch, float_kernel, float_plain, cfg.vocab_size,
        "hymba float prefill, ssd cuda vs chunked", tol=LM_FLOAT_TOL)
    del float_plain

    t0 = time.perf_counter()
    planned = serve_mod.plan_params_for_pim(
        params, pim.PimConfig(weight_bits=4, act_bits=4,
                              substrate="exact-cuda"))
    torch.cuda.synchronize()
    out["program_s"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()

    (generated, _, _, logits), numbers = lm_serve_requests(
        torch, serve_mod, planned, cfg, tokens, counters)
    out.update(numbers)
    out["launches_by_route"] = route_counts(mods["pim_kern"],
                                            "pim_matmul_fused")
    per_step = 7 * cfg.num_layers
    want = {"ssd_scan": cfg.num_layers * LM_REQUESTS,
            "pim_matmul_fused": per_step * (1 + LM_GEN) * LM_REQUESTS}
    got = numbers["launches"]
    if any(got[k] != v for k, v in want.items()) or any(
            got[k] for k in got if k not in want):
        raise AssertionError(f"hymba launches {got}, expected {want} and "
                             "no other kernel")
    want_routes = expected_routes(mods["pim_kern"], lm_plan_shapes(planned),
                                  LM_REQUESTS)
    if out["launches_by_route"] != want_routes:
        raise AssertionError(f"hymba routes {out['launches_by_route']}, "
                             f"expected {want_routes}")
    pre, step = phase_counts(torch, lm, planned, cfg, tokens, counters)
    if pre["ssd_scan"] != cfg.num_layers or step["ssd_scan"] or \
            pre["pim_matmul_fused"] != per_step or \
            step["pim_matmul_fused"] != per_step:
        raise AssertionError(f"per-phase launches: prefill {pre}, one "
                             f"decode step {step}")
    out["launches_prefill"], out["launches_decode_step"] = pre, step
    log(f"hymba path: {LM_REQUESTS} requests of batch {LM_BATCH}, prompt "
        f"{LM_PROMPT}, {LM_GEN} new tokens, finite logits; launches per "
        f"prefill {pre['ssd_scan']} ssd_scan + {pre['pim_matmul_fused']} "
        f"pim_matmul_fused, per decode step {step['ssd_scan']} + "
        f"{step['pim_matmul_fused']}, no analog launch; pim_matmul_fused "
        f"by route over the requests {out['launches_by_route']}")

    # exact-cuda against exact-torch, both ssd_backend="cuda": the prefill
    # logits (tiled route) and every decode step's (small-M route), on
    # the tokens the cuda route generates
    plain_pim = with_substrate(planned, "exact-torch")
    ref_logits, ref_cache = lm.prefill(plain_pim, cfg, {"tokens": tokens},
                                       LM_PROMPT + LM_GEN)
    if not torch.equal(ref_logits, logits):
        raise AssertionError("hymba exact-cuda prefill logits differ from "
                             "exact-torch")
    step_logits, cache = lm.prefill(planned, cfg, {"tokens": tokens},
                                    LM_PROMPT + LM_GEN)
    tok, toks = step_logits.argmax(-1)[:, None], []
    for g in range(LM_GEN):
        toks.append(tok)
        step_logits, cache = lm.decode_step(planned, cfg, cache, tok,
                                            LM_PROMPT + g)
        ref_logits, ref_cache = lm.decode_step(plain_pim, cfg, ref_cache,
                                               tok, LM_PROMPT + g)
        if not torch.equal(step_logits, ref_logits):
            raise AssertionError(f"hymba decode step {g}: exact-cuda logits "
                                 "differ from exact-torch")
        tok = step_logits.argmax(-1)[:, None]
    if not torch.equal(torch.cat(toks, dim=1), generated):
        raise AssertionError("the step-by-step decode generated other "
                             "tokens than the serving loop")
    del plain_pim, ref_logits, ref_cache, step_logits, cache
    log(f"hymba prefill logits and all {LM_GEN} decode steps' logits on "
        "exact-cuda bit-identical to exact-torch; the tokens equal the "
        "serving loop's")
    gen_plain, _, _, logits_plain = serve_mod.static_loop(
        planned, chunked, tokens, LM_GEN)
    out["pim_prefill_cuda_vs_chunked"] = logit_gap(
        torch, logits, logits_plain, cfg.vocab_size,
        "hymba PIM prefill, ssd cuda vs chunked (reported, not held)")
    out["pim_generated_token_agreement"] = \
        (generated == gen_plain).double().mean().item()
    # how far w4a4 is from the float model at all (random weights)
    out["pim_prefill_vs_float"] = logit_gap(
        torch, logits, float_kernel, cfg.vocab_size,
        "hymba PIM (w4a4) vs float prefill, both ssd cuda (reported)")
    log("hymba PIM greedy tokens, ssd cuda vs chunked: agreement "
        f"{out['pim_generated_token_agreement']:.3f} of "
        f"{LM_BATCH * LM_GEN}")
    log(f"hymba serving: prefill median {out['prefill_ms_median']:.3f} ms "
        f"({', '.join(f'{t:.3f}' for t in out['prefill_ms'])}), decode "
        f"median {out['decode_ms_per_token_median']:.3f} ms/token "
        f"({', '.join(f'{t:.3f}' for t in out['decode_ms_per_token'])}), "
        f"{out['tokens_per_s']:.1f} tokens/s, programming "
        f"{out['program_s']:.3f} s, peak device memory "
        f"{out['peak_bytes'] / 2 ** 30:.3f} GiB")

    run = lambda: serve_mod.static_loop(planned, cfg, tokens, LM_GEN)
    out["profile"] = profile_request(
        torch, mods, run, LM_KERNELS, "hymba", profiled=LM_PROFILED,
        nested={"ssm glue": ("ssd_scan kernel",
                             "ssm in-projections (float32 GEMMs)")})
    ssd_args, chunk = capture_ssd_inputs(mods["ssd_kern"], run)
    out["ssd_row"] = ssd_time_row(torch, mods["ssd_wrap"], mods["ssd_ref"],
                                  "hymba (path inputs)", ssd_args, chunk,
                                  cfg.num_layers)
    out["ssd_row"]["max_abs_err"] = ssd_gap(
        torch, mods["ssd_kern"].ssd_scan_cuda(*ssd_args, chunk),
        ssd_plain(mods["ssd_ref"], *ssd_args, chunk))
    calls, out["decode_step_profile"] = capture_decode_step(
        torch, mods["pim_ops"], lm, planned, cfg, tokens)
    log(f"profile of one hymba decode step: "
        f"{out['decode_step_profile']['small_m_kernels']} small-M PIM "
        "kernels and no tiled one, "
        f"{out['decode_step_profile']['small_m_device_ms']:.4f} ms of "
        "device time")
    out["decode_replay"] = decode_replay(torch, mods["pim_kern"],
                                         mods["pim_ref"], calls)
    out["shapes"] = lm_plan_shapes(planned)
    del planned, ssd_args, calls
    torch.cuda.empty_cache()
    return out


def serve_entry_phase(torch, serve_mod, configs, counters):
    """(c) The entry point itself at full width, default ssd_backend
    ("chunked"): 7 x 32 PIM launches per forward step, no SSD launch."""
    layers = configs.get_config("hymba-1.5b").num_layers
    reset_counts(*counters)
    t0 = time.perf_counter()
    res = serve_mod.serve("hymba-1.5b", batch=LM_BATCH,
                          prompt_len=LM_PROMPT, gen=LM_GEN, pim=True)
    seconds = time.perf_counter() - t0
    launches = read_counts(*counters)
    if launches["pim_matmul_fused"] != 7 * layers * (1 + LM_GEN) or \
            launches["ssd_scan"] or tuple(res["generated"].shape) != \
            (LM_BATCH, LM_GEN):
        raise AssertionError(f"serve(): launches {launches}, generated "
                             f"{res['generated'].shape}")
    log(f"serve('hymba-1.5b', batch={LM_BATCH}, prompt_len={LM_PROMPT}, "
        f"gen={LM_GEN}, pim=True): keys {sorted(res)}; tokens_per_s "
        f"{res['tokens_per_s']:.1f}, prefill_s {res['prefill_s']:.4f}, "
        f"decode_s_per_token {res['decode_s_per_token']:.4f}; "
        f"{launches['pim_matmul_fused']} pim_matmul_fused launches, "
        f"no ssd_scan launch; {seconds:.1f} s with set-up")
    torch.cuda.empty_cache()
    return {k: v for k, v in res.items() if k not in ("generated", "emitted",
                                                      "row_stop_reasons")}


def mamba2_path(torch, dev, mods, counters):
    """(d) mamba2-370m at full width (48 layers, d_model 1024), random
    weights from seed 0, ssd_backend="cuda": one request of prefill + 16
    decode steps, 48 SSD launches per prefill, prefill logits against the
    chunked route."""
    import dataclasses
    lm, serve_mod = mods["lm"], mods["serve"]
    cfg = dataclasses.replace(mods["configs"].get_config("mamba2-370m"),
                              ssd_backend="cuda")
    params = lm.init_lm(cfg, 0, device=dev)
    tokens = lm_tokens(torch, dev, cfg.vocab_size)
    (generated, _, _, logits), numbers = lm_serve_requests(
        torch, serve_mod, params, cfg, tokens, counters)
    want = cfg.num_layers * LM_REQUESTS
    if numbers["launches"]["ssd_scan"] != want or \
            numbers["launches"]["pim_matmul_fused"]:
        raise AssertionError(f"mamba2 launches {numbers['launches']}, "
                             f"expected {want} ssd_scan")
    plain, _ = lm.prefill(params, dataclasses.replace(
        cfg, ssd_backend="chunked"), {"tokens": tokens}, LM_PROMPT + LM_GEN)
    numbers["float_prefill_cuda_vs_chunked"] = logit_gap(
        torch, logits, plain, cfg.vocab_size,
        "mamba2 prefill, ssd cuda vs chunked",
        tol=LM_FLOAT_TOL)
    log(f"mamba2 path: {LM_REQUESTS} requests, {cfg.num_layers} ssd_scan "
        f"launches per prefill, finite logits; prefill median "
        f"{numbers['prefill_ms_median']:.3f} ms, decode median "
        f"{numbers['decode_ms_per_token_median']:.3f} ms/token, request "
        f"median {numbers['request_ms_median']:.3f} ms, "
        f"{numbers['tokens_per_s']:.1f} tokens/s, peak device memory "
        f"{numbers['peak_bytes'] / 2 ** 30:.3f} GiB")
    run = lambda: serve_mod.static_loop(params, cfg, tokens, LM_GEN)
    ssd_args, chunk = capture_ssd_inputs(mods["ssd_kern"], run)
    numbers["ssd_row"] = ssd_time_row(
        torch, mods["ssd_wrap"], mods["ssd_ref"], "mamba2 (path inputs)",
        ssd_args, chunk, cfg.num_layers)
    numbers["ssd_row"]["max_abs_err"] = ssd_gap(
        torch, mods["ssd_kern"].ssd_scan_cuda(*ssd_args, chunk),
        ssd_plain(mods["ssd_ref"], *ssd_args, chunk))
    del params, ssd_args
    torch.cuda.empty_cache()
    return numbers


# ---------------------------------------------------------------------------
# The MoE path: moonshot-v1-16b-a3b served at full width on exact-cuda
# ---------------------------------------------------------------------------
MOONSHOT = "moonshot-v1-16b-a3b"
# exact-cuda against exact-torch at full width on this many layers: the
# plain substrate's float64 products over 64 experts make 48 slow
MOE_EXACT_LAYERS = 2
# moonshot's B1 (K, N) as the plans pad them: attention, shared-expert
# up/gate and down (K 2816 -> 3072), expert up/gate and down (K 1408 ->
# 1536); every one at the prefill's and the decode step's M
MOE_KN = {"attention": (2048, 2048), "shared_up": (2048, 2816),
          "shared_down": (3072, 2048), "expert_up": (2048, 1408),
          "expert_down": (1536, 2048)}


def moe_layer_launches(cfg):
    """B1 launches per layer and forward step: q, k, v, o; the shared
    experts' up, gate and down; and up, gate and down of every expert."""
    return 4 + (3 if cfg.shared_experts else 0) + 3 * cfg.num_experts


def moe_exactness(torch, dev, mods, cfg, tokens):
    """exact-cuda against exact-torch at full width and MOE_EXACT_LAYERS
    layers: the prefill logits and every decode step's, bit for bit, on
    the tokens the kernel route generates."""
    import dataclasses
    lm, serve_mod, pim = mods["lm"], mods["serve"], mods["pim"]
    short = dataclasses.replace(cfg, num_layers=MOE_EXACT_LAYERS)
    planned = serve_mod.plan_params_for_pim(
        lm.init_lm(short, 0, device=dev),
        pim.PimConfig(weight_bits=4, act_bits=4, substrate="exact-cuda"))
    plain = with_substrate(planned, "exact-torch")
    t0 = time.perf_counter()
    logits, cache = lm.prefill(planned, short, {"tokens": tokens},
                               LM_PROMPT + LM_GEN)
    want, ref_cache = lm.prefill(plain, short, {"tokens": tokens},
                                 LM_PROMPT + LM_GEN)
    if not torch.equal(logits, want):
        raise AssertionError("moonshot exact-cuda prefill logits differ "
                             "from exact-torch")
    tok = logits.argmax(-1)[:, None]
    for g in range(LM_GEN):
        logits, cache = lm.decode_step(planned, short, cache, tok,
                                       LM_PROMPT + g)
        want, ref_cache = lm.decode_step(plain, short, ref_cache, tok,
                                         LM_PROMPT + g)
        if not torch.equal(logits, want):
            raise AssertionError(f"moonshot decode step {g}: exact-cuda "
                                 "logits differ from exact-torch")
        tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())
    del planned, plain, cache, ref_cache
    torch.cuda.empty_cache()
    if not finite:
        raise AssertionError("moonshot logits not finite")
    log(f"moonshot at full width and {MOE_EXACT_LAYERS} layers (exact-torch"
        " at 48 layers is slow on the card): prefill logits and all "
        f"{LM_GEN} decode steps' logits on exact-cuda bit-identical to "
        f"exact-torch ({seconds:.1f} s for both routes)")
    return {"layers": MOE_EXACT_LAYERS, "decode_steps": LM_GEN,
            "bit_identical": True, "seconds": seconds}


MOE_RANGES = (  # (module key, attribute, range name) wrapped while profiling
    ("pim", "_quantize_activations", "quantize+nibbles"),
    ("pim", "_pad_act_planes", "pad activation planes"),
    ("attention", "_sdpa", "attention"),
    ("moe", "_route", "router"),
    ("moe", "_combine", "combine"),
    ("moe", "_moe_pim", "expert FFN"),
)
MOE_KERNELS = {"B1, wgmma route (prefill)": "pim_matmul_wgmma_kernel",
               "B1, small-M route (decode)": "pim_matmul_small_m_kernel"}


def moe_profile(torch, mods, run, what):
    """Device time of ``run`` by stage: B1 by route (its kernels by name);
    quantize + nibbles, the activation-plane padding, attention, the
    router and the combine (the kernels launched inside each range); the
    (E, T, ·) glue: the expert FFN's range less the quantize, padding and
    combine inside it (silu, products, the stacking of expert outputs,
    the router-weight scatter; the profiler does not count the PIM
    kernel, launched through ctypes, in any range, so B1 is not in it);
    other: the rest of the busy time (norms,
    residual adds, embedding and unembedding, the KV cache, the greedy
    pick). A request holds about 25 host-side events per expert matmul,
    millions in all, so stages are read from one prefill and one decode
    step, and the whole request is profiled on the device alone
    (:func:`moe_request_profile`)."""
    from bisect import bisect_right
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(fn, label):
        def wrapper(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    saved = [(mods[m], attr, getattr(mods[m], attr))
             for m, attr, _ in MOE_RANGES]
    for (mod, attr, fn), (_, _, label) in zip(saved, MOE_RANGES):
        setattr(mod, attr, ranged(fn, label))
    try:
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    events = list(prof.events())
    labels = {label for _, _, label in MOE_RANGES}
    device = [e for e in device_events(torch, prof) if e.name not in labels]
    busy, window = busy_and_window(device, events)
    ranges = {label: [] for label in labels}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and \
                e.name in labels:
            ranges[e.name].append((e.time_range.start, e.time_range.end,
                                   e.device_time_total))
    ffn = sorted(ranges["expert FFN"])
    starts = [r[0] for r in ffn]

    def inside(label):
        """Device time of ``label``'s ranges that lie in an expert FFN."""
        total = 0.0
        for s0, e0, t in ranges[label]:
            i = bisect_right(starts, s0) - 1
            if i >= 0 and e0 <= ffn[i][1]:
                total += t
        return total

    stages = {label: sum(e.time_range.elapsed_us() for e in device
                         if fragment in e.name)
              for label, fragment in MOE_KERNELS.items()}
    for label in ("quantize+nibbles", "pad activation planes", "attention",
                  "router", "combine"):
        stages[label] = sum(t for _, _, t in ranges[label])
    stages["(E,T,.) glue"] = sum(t for _, _, t in ffn) - sum(
        inside(label) for label in ("quantize+nibbles",
                                    "pad activation planes", "combine"))
    stages = {k: v / 1e3 for k, v in stages.items()}
    stages["other"] = busy / 1e3 - sum(stages.values())
    result = {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
              "device_idle_share": 1.0 - busy / window,
              "device_events": len(device), "events": len(events),
              "stages_ms": stages, "profiled_run_s": t1 - t0,
              "processing_s": time.perf_counter() - t1}
    log(f"profile of one moonshot {what}: device busy {busy / 1e3:.3f} ms "
        f"of a {window / 1e3:.3f} ms profiled window (idle share "
        f"{result['device_idle_share']:.3f}, {len(device)} device events, "
        f"{len(events)} events, {result['profiled_run_s']:.1f} s profiled "
        f"and {result['processing_s']:.1f} s to read); by stage: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
    return result


def busy_and_window(device, events):
    """Device busy time (the union of the device activities' spans) and
    the profiled window, in microseconds."""
    if not device:
        raise AssertionError("the profiler saw no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = max(e.time_range.end for e in events) - \
        min(e.time_range.start for e in events)
    return busy, window


def moe_request_profile(torch, run):
    """One whole request profiled on the device alone (no host-side
    events): busy time, the idle share over the window from its first
    device activity to its last, and B1's device time and launches by
    route."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device = device_events(torch, prof)
    busy, window = busy_and_window(device, device)
    b1 = {label: [e.time_range.elapsed_us() for e in device
                  if fragment in e.name]
          for label, fragment in MOE_KERNELS.items()}
    result = {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
              "device_idle_share": 1.0 - busy / window,
              "device_events": len(device),
              "b1_ms": {k: sum(v) / 1e3 for k, v in b1.items()},
              "b1_kernels": {k: len(v) for k, v in b1.items()}}
    log(f"device-only profile of one moonshot request: busy "
        f"{busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window (first to "
        f"last device activity), idle share "
        f"{result['device_idle_share']:.4f}, {len(device)} device events; "
        "B1 " + ", ".join(f"{k} {result['b1_ms'][k]:.3f} ms over "
                          f"{result['b1_kernels'][k]} kernels" for k in b1))
    return result


def moe_phase_launches(torch, mods, planned, cfg, tokens, counters):
    """B1 launches by route of one prefill and of one decode step alone,
    held to the route chooser on the path's shapes (at batch 8 x prompt
    512 all prefill launches take the wgmma route, all decode launches the
    small-M route); nothing else may launch."""
    lm, kern = mods["lm"], mods["pim_kern"]
    out = {}
    reset_counts(*counters)
    logits, cache = lm.prefill(planned, cfg, {"tokens": tokens},
                               LM_PROMPT + LM_GEN)
    torch.cuda.synchronize()
    out["prefill"] = route_counts(kern, "pim_matmul_fused")
    others = {k: v for k, v in read_counts(*counters).items()
              if v and k != "pim_matmul_fused"}
    reset_counts(*counters)
    lm.decode_step(planned, cfg, cache, logits.argmax(-1)[:, None],
                   LM_PROMPT)
    torch.cuda.synchronize()
    out["decode_step"] = route_counts(kern, "pim_matmul_fused")
    others.update({k: v for k, v in read_counts(*counters).items()
                   if v and k != "pim_matmul_fused"})
    shapes = lm_plan_shapes(planned)
    want = {"prefill": expected_routes(kern, Counter({
                s: c for s, c in shapes.items()
                if s[0] == LM_BATCH * LM_PROMPT}), 1),
            "decode_step": expected_routes(kern, Counter({
                s: c // LM_GEN for s, c in shapes.items()
                if s[0] == LM_BATCH}), 1)}
    per_step = cfg.num_layers * moe_layer_launches(cfg)
    if out != want or others or any(
            sum(r.values()) != per_step for r in out.values()):
        raise AssertionError(f"moonshot B1 launches by phase {out}, other "
                             f"kernels {others}; expected {want}, "
                             f"{per_step} per forward step")
    return out


def moonshot_path(torch, dev, mods, counters):
    """(e) moonshot-v1-16b-a3b at full width (48 layers, d_model 2048, 64
    experts top-6 of d_ff 1408, 2 shared experts, vocab 163840), random
    weights from seed 0: exact-cuda against exact-torch at 2 layers, then
    serving's set-up (each layer programmed at w4a4 on exact-cuda as it is
    drawn) and the static loop at batch 8, prompt 512, 16 new tokens:
    launches by route, times, memory, a profile by stage."""
    serve_mod, kern = mods["serve"], mods["pim_kern"]
    cfg = mods["configs"].get_config(MOONSHOT)
    tokens = lm_tokens(torch, dev, cfg.vocab_size)
    out = {"config": {"arch": cfg.name, "layers": cfg.num_layers,
                      "d_model": cfg.d_model, "experts": cfg.num_experts,
                      "top_k": cfg.experts_per_token,
                      "expert_d_ff": cfg.moe_d_ff,
                      "shared_experts": cfg.shared_experts,
                      "vocab": cfg.vocab_size, "batch": LM_BATCH,
                      "prompt": LM_PROMPT, "gen": LM_GEN, "bits": "w4a4"}}
    out["exactness"] = moe_exactness(torch, dev, mods, cfg, tokens)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, planned, substrate, _, _ = serve_mod._setup(
        MOONSHOT, None, None, True, 4, False, "exact-cuda", None,
        device=dev)
    torch.cuda.synchronize()
    out["program_s"] = time.perf_counter() - t0
    out["setup_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["resident_bytes"] = torch.cuda.memory_allocated()
    plans = layer_plans(planned["layers"])
    out["step_plane_bytes"] = sum(getattr(p, "dense", p).planes.numel()
                                  for p in plans)
    out["decode_step_bytes_bound_ms"] = out["step_plane_bytes"] \
        / HBM_BYTES_PER_S * 1e3
    log(f"moonshot set-up (init + programming, layer by layer, on "
        f"{substrate}): {out['program_s']:.1f} s, resident "
        f"{out['resident_bytes'] / 2 ** 30:.3f} GiB, set-up peak "
        f"{out['setup_peak_bytes'] / 2 ** 30:.3f} GiB; weight planes read "
        f"per decode step {out['step_plane_bytes'] / 1e9:.3f} GB (bytes "
        f"bound {out['decode_step_bytes_bound_ms']:.3f} ms)")

    (generated, _, _, logits), numbers = lm_serve_requests(
        torch, serve_mod, planned, cfg, tokens, counters)
    out.update(numbers)
    per_step = cfg.num_layers * moe_layer_launches(cfg)
    want = {"pim_matmul_fused": per_step * (1 + LM_GEN) * LM_REQUESTS}
    got = numbers["launches"]
    if any(got[k] != v for k, v in want.items()) or any(
            got[k] for k in got if k not in want):
        raise AssertionError(f"moonshot launches {got}, expected {want} "
                             "and no other kernel")
    out["launches_by_route"] = route_counts(kern, "pim_matmul_fused")
    out["shapes"] = lm_plan_shapes(planned)
    want_routes = expected_routes(kern, out["shapes"], LM_REQUESTS)
    if out["launches_by_route"] != want_routes:
        raise AssertionError(f"moonshot routes {out['launches_by_route']},"
                             f" expected {want_routes}")
    out["launches_by_phase"] = moe_phase_launches(torch, mods, planned, cfg,
                                                  tokens, counters)
    log(f"moonshot path: {LM_REQUESTS} requests of batch {LM_BATCH}, "
        f"prompt {LM_PROMPT}, {LM_GEN} new tokens, finite logits; "
        f"pim_matmul_fused per prefill {out['launches_by_phase']['prefill']}"
        f", per decode step {out['launches_by_phase']['decode_step']} "
        f"({moe_layer_launches(cfg)} per layer), no other kernel; by route "
        f"over the requests {out['launches_by_route']}")
    log(f"moonshot serving: prefill median {out['prefill_ms_median']:.3f} "
        f"ms ({', '.join(f'{t:.3f}' for t in out['prefill_ms'])}), decode "
        f"median {out['decode_ms_per_token_median']:.3f} ms/token "
        f"({', '.join(f'{t:.3f}' for t in out['decode_ms_per_token'])}), "
        f"{out['tokens_per_s']:.2f} tokens/s, programming "
        f"{out['program_s']:.1f} s, peak device memory "
        f"{out['peak_bytes'] / 2 ** 30:.3f} GiB")
    lm = mods["lm"]
    out["profile"] = moe_request_profile(
        torch, lambda: serve_mod.static_loop(planned, cfg, tokens, LM_GEN))
    out["prefill_profile"] = moe_profile(
        torch, mods, lambda: lm.prefill(planned, cfg, {"tokens": tokens},
                                        LM_PROMPT + LM_GEN), "prefill")
    _, cache = lm.prefill(planned, cfg, {"tokens": tokens},
                          LM_PROMPT + LM_GEN)
    tok = generated[:, :1]
    out["decode_step_profile"] = moe_profile(
        torch, mods, lambda: lm.decode_step(planned, cfg, cache, tok,
                                            LM_PROMPT), "decode step")
    pre, step = (out["prefill_profile"]["stages_ms"],
                 out["decode_step_profile"]["stages_ms"])
    out["request_stages_ms"] = {k: pre[k] + LM_GEN * step[k] for k in pre}
    log("moonshot device time per request by stage (one prefill + "
        f"{LM_GEN} x one decode step): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in out["request_stages_ms"].items()))
    del planned, plans, generated, logits, cache
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Plan persistence and continuous batching: qwen3-4b at full width
# ---------------------------------------------------------------------------
QWEN3 = "qwen3-4b"
# the continuous path: slots, a Poisson trace (prompts 128-512, 4-16 new
# tokens: serve_continuous's quarter-to-full ranges) and its variants
CONT_SLOTS, CONT_REQUESTS, CONT_RATE = 8, 32, 0.5
CONT_CHUNK, CONT_PREFIX_CACHE, CONT_SHARED_PREFIX = 64, 16, 128
CONT_WINDOW = 4            # sync_every of the fused-window variant
CONT_VARIANT_REQUESTS = 6  # the trace's first requests, for variants
CONT_STATIC_CHECKS = 4     # requests held to their static streams
CONT_EXACT_LAYERS = 2      # exact-cuda against exact-torch at this depth


class patched:
    """Replace module or class attributes for a block, restoring them."""

    def __init__(self, *swaps):
        self.swaps = swaps

    def __enter__(self):
        self.saved = [(obj, name, getattr(obj, name))
                      for obj, name, _ in self.swaps]
        for obj, name, value in self.swaps:
            setattr(obj, name, value)
        return self

    def __exit__(self, *exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)
        return False


def timed(store, key, fn, keep=None):
    """``fn`` that adds its wall seconds to ``store[key]`` (and, with
    ``keep``, stores its last result at ``store[keep]``); calls from
    several threads add up."""
    import threading
    lock = threading.Lock()

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
        finally:
            with lock:
                store[key] = store.get(key, 0.0) + time.perf_counter() - t0
        if keep is not None:
            store[keep] = out
        return out
    return wrapper


def qwen3_launches(cfg):
    """B1 launches per forward step: q, k, v, o, gate, up, down."""
    return 7 * cfg.num_layers


def persist_timers(t, mods):
    """Swaps that time serving's set-up and its parts into ``t``: the
    set-up (keeping its result, whose params are the plans), the weights'
    digest, programming, the plan directory's load and save, and every
    sha256 of a stored leaf."""
    serve_mod, engine, ckpt = mods["serve"], mods["engine"], mods["ckpt"]
    return ((serve_mod, "_setup", timed(t, "setup_s", serve_mod._setup,
                                        keep="setup")),
            (serve_mod, "_params_digest", timed(t, "digest_s",
                                                serve_mod._params_digest)),
            (serve_mod, "_program", timed(t, "program_s",
                                          serve_mod._program)),
            (engine, "load_plans", timed(t, "load_s", engine.load_plans)),
            (engine, "save_plans", timed(t, "save_s", engine.save_plans)),
            (ckpt, "payload_sha256", timed(t, "sha256_s",
                                           ckpt.payload_sha256)))


def qwen3_program_phase(torch, dev, mods, counters, plan_dir):
    """(f) ``serve(qwen3-4b, ..., plan_dir=)`` at full width into a fresh
    directory: it draws the weights (for their digest), programs them at
    w4a4 on exact-cuda, saves the plans, and serves batch 8 x prompt 512
    with 16 greedy tokens. Returns the numbers, the prefill logits and the
    tokens (the programmed plans are dropped)."""
    serve_mod = mods["serve"]
    cfg = mods["configs"].get_config(QWEN3)
    usage = shutil.disk_usage(plan_dir)
    log(f"plan directory {plan_dir}: {usage.free / 1e9:.1f} GB free")
    t = {}
    with patched(*persist_timers(t, mods),
                 (serve_mod, "static_loop", timed(
                     t, "loop_s", serve_mod.static_loop, keep="loop"))):
        torch.cuda.synchronize()
        reset_counts(*counters)
        t0 = time.perf_counter()
        res = serve_mod.serve(QWEN3, batch=LM_BATCH, prompt_len=LM_PROMPT,
                              gen=LM_GEN, pim=True, plan_dir=plan_dir)
        torch.cuda.synchronize()
        t["serve_s"] = time.perf_counter() - t0
        launches = read_counts(*counters)
    want = qwen3_launches(cfg) * (1 + LM_GEN)
    if launches["pim_matmul_fused"] != want or any(
            v for k, v in launches.items() if k != "pim_matmul_fused"):
        raise AssertionError(f"qwen3 programming run: launches {launches}, "
                             f"expected {want} pim_matmul_fused")
    if "program_s" not in t or "save_s" not in t:
        raise AssertionError("qwen3: serve(plan_dir=) into a fresh "
                             f"directory must program and save: {sorted(t)}")
    _, _, _, logits = t.pop("loop")
    t.pop("setup")
    if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        raise AssertionError("qwen3 prefill logits not finite")
    size = sum(f.stat().st_size for f in Path(plan_dir).rglob("*")
               if f.is_file())
    out = {"config": {"arch": cfg.name, "layers": cfg.num_layers,
                      "d_model": cfg.d_model, "heads": cfg.num_heads,
                      "kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff,
                      "vocab": cfg.vocab_size, "batch": LM_BATCH,
                      "prompt": LM_PROMPT, "gen": LM_GEN, "bits": "w4a4"},
           "plan_dir_bytes": size, "disk_free_bytes": usage.free,
           "launches": launches, "launches_per_request": want,
           "prefill_ms": res["prefill_s"] * 1e3,
           "decode_ms_per_token": res["decode_s_per_token"] * 1e3,
           "tokens_per_s": res["tokens_per_s"], **t}
    log(f"qwen3 serve(plan_dir=) programming run: set-up {t['setup_s']:.1f}"
        f" s (the weights' digest {t['digest_s']:.1f} s, programming "
        f"{t['program_s']:.1f} s, save {t['save_s']:.1f} s, its sha256 "
        f"{t['sha256_s']:.1f} s); plan directory {size / 1e9:.3f} GB; "
        f"prefill {out['prefill_ms']:.1f} ms, decode "
        f"{out['decode_ms_per_token']:.1f} ms/token, "
        f"{out['tokens_per_s']:.1f} tokens/s; {want} pim_matmul_fused "
        "launches")
    return out, logits, res["generated"], cfg


def qwen3_phases(torch, dev, mods, counters):
    """(f) and (g) over one fresh plan directory, deleted afterwards."""
    plan_dir = tempfile.mkdtemp(prefix="qwen3_plans_")
    try:
        program, logits, generated, cfg = qwen3_program_phase(
            torch, dev, mods, counters, plan_dir)
        cont = qwen3_continuous_phase(torch, dev, mods, counters, plan_dir,
                                      cfg, (logits, generated))
    finally:
        shutil.rmtree(plan_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return program, cont


def qwen3_trace(serving, cfg, shared=0):
    return serving.poisson_trace(
        n=CONT_REQUESTS, rate=CONT_RATE,
        prompt_lens=list(range(LM_PROMPT // 4, LM_PROMPT + 1)),
        gen_lens=list(range(LM_GEN // 4, LM_GEN + 1)), vocab=cfg.vocab_size,
        seed=0, shared_prefix_len=shared)


def streams(completions):
    """request id -> (tokens, stop reason)."""
    import numpy as np
    return {c.request_id: (np.asarray(c.tokens).tolist(), c.stop_reason)
            for c in completions}


def entry_streams(res):
    import numpy as np
    return {r["id"]: (np.asarray(r["tokens"]).tolist(), r["stop_reason"])
            for r in res["requests"]}


def qwen3_window_profile(torch, serving, params, cfg, trace):
    """One fused decode window (sync_every = CONT_WINDOW) over 8 occupied
    slots, profiled on the device: busy time and the idle share between
    its first and last device activity."""
    from torch.profiler import ProfilerActivity, profile
    eng = serving.ServingEngine(params, cfg, num_slots=CONT_SLOTS,
                                prompt_pad=LM_PROMPT,
                                max_len=LM_PROMPT + LM_GEN,
                                sync_every=CONT_WINDOW)
    state = eng.init_state()
    for r in trace[:CONT_SLOTS]:
        state, _ = eng.insert(eng.prefill(r.tokens), state,
                              max_new_tokens=LM_GEN, request_id=r.request_id)
    state, _ = eng.generate(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, res = eng.generate(state)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    device = device_events(torch, prof)
    busy, window = busy_and_window(device, device)
    out = {"steps": res.steps, "slots": CONT_SLOTS, "wall_ms": wall * 1e3,
           "device_busy_ms": busy / 1e3, "window_ms": window / 1e3,
           "device_idle_share": 1.0 - busy / window,
           "device_events": len(device)}
    log(f"qwen3 decode window ({res.steps} fused steps, {CONT_SLOTS} slots) "
        f"profiled: device busy {busy / 1e3:.3f} ms of a "
        f"{window / 1e3:.3f} ms window, idle share "
        f"{out['device_idle_share']:.3f}, {len(device)} device events, "
        f"{wall * 1e3:.1f} ms of host time")
    return out


def qwen3_continuous_phase(torch, dev, mods, counters, plan_dir, cfg,
                           programmed):
    """(g) ``serve_continuous(qwen3-4b, ...)`` at full width through the
    plans (f) saved: the entry point draws the weights for their digest
    and restores the plans (set-up timed, with the sha256 time of the
    load's reader threads), then serves 8 slots with 32 Poisson requests at 0.5
    per step (seed 0), prompts 128-512, 4-16 new tokens: B1 launches by
    route (whole prefill on the wgmma route, decode at M = 8 on the
    small-M route), tokens/s, TTFT and latency percentiles, prefill ms
    per admitted request, decode ms per step. The restored plans' static
    request (batch 8 x prompt 512, 16 tokens) equals (f)'s bit for bit.
    Then, on the restored plans, the identities: sync_every 4 = 1,
    chunked prefill (64) = whole, a prefix-cache hit = a miss (shared
    prefix 128, chunks of 64), each on the trace's first
    CONT_VARIANT_REQUESTS requests (a request's tokens never depend on
    the others), four requests' streams = their static streams at the
    slots' shapes, and at 2 layers exact-cuda = exact-torch for the whole
    trace; one fused window profiled."""
    serving, serve_mod, kern = mods["serving"], mods["serve"], \
        mods["pim_kern"]
    Engine = serving.ServingEngine
    t, p = {}, {}
    with patched(*persist_timers(p, mods),
                 (Engine, "prefill_step", timed(t, "prefill_s",
                                                Engine.prefill_step)),
                 (Engine, "generate", timed(t, "decode_s",
                                            Engine.generate))):
        torch.cuda.synchronize()
        reset_counts(*counters)
        t0 = time.perf_counter()
        res = serve_mod.serve_continuous(
            QWEN3, num_slots=CONT_SLOTS, num_requests=CONT_REQUESTS,
            prompt_len=LM_PROMPT, gen=LM_GEN, pim=True, plan_dir=plan_dir,
            arrival_rate=CONT_RATE, seed=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts(*counters)
        routes = route_counts(kern, "pim_matmul_fused")
    if "load_s" not in p or "program_s" in p or "save_s" in p:
        raise AssertionError("qwen3: serve_continuous(plan_dir=) must "
                             f"restore the saved plans: {sorted(p)}")
    params = p.pop("setup")[1]
    restore = dict(p, sha256_per_load_s=p["sha256_s"] / p["load_s"])
    generated, _, _, logits = serve_mod.static_loop(
        params, cfg, lm_tokens(torch, dev, cfg.vocab_size), LM_GEN)
    if not torch.equal(logits, programmed[0]) or not torch.equal(
            generated.cpu(), torch.as_tensor(programmed[1])):
        raise AssertionError("qwen3: the restored plans' prefill logits or "
                             "tokens differ from the programmed plans'")
    log(f"qwen3 restore (serve_continuous(plan_dir=) set-up): "
        f"{p['setup_s']:.1f} s (the weights' digest {p['digest_s']:.1f} s, "
        f"load {p['load_s']:.1f} s, its sha256 {p['sha256_s']:.1f} s on "
        "the reader threads, "
        f"{restore['sha256_per_load_s']:.3f} thread-seconds per second of "
        "the load); the restored "
        f"plans' prefill logits and {LM_GEN} tokens x {LM_BATCH} rows "
        "bit-identical to the programmed plans'")
    plans = layer_plans(params["layers"])
    kn = Counter((q.planes.shape[1], q.planes.shape[2]) for q in plans)
    # per run: one whole prefill per request (M = the prompt pad), one
    # decode step of M = slots per step; the warm-up adds one of each
    shapes, expect = Counter(), Counter()
    for (k, n), c in kn.items():
        shapes[(LM_PROMPT, k, n)] += c * res["prefills"]
        shapes[(CONT_SLOTS, k, n)] += c * res["decode_steps"]
        expect[kern.small_m_grid(LM_PROMPT, k, n)[0]] += \
            c * (res["prefills"] + 1)
        expect[kern.small_m_grid(CONT_SLOTS, k, n)[0]] += \
            c * (res["decode_steps"] + 1)
    if routes != dict(expect) or launches["pim_matmul_fused"] != sum(
            expect.values()) or any(v for k, v in launches.items()
                                    if k != "pim_matmul_fused"):
        raise AssertionError(f"qwen3 continuous launches {launches}, by "
                             f"route {routes}; expected {dict(expect)}")
    if res["num_requests"] != CONT_REQUESTS or res["prefill_traces"] != 1 \
            or res["decode_traces"] != 1:
        raise AssertionError(f"qwen3 continuous metrics {res}")
    out = {"restore": restore, "entry_s": seconds, "launches": launches,
           "launches_by_route": routes, "shapes": shapes,
           "prefill_ms_per_request": t["prefill_s"] * 1e3 / res["prefills"],
           "decode_ms_per_step": t["decode_s"] * 1e3 / res["decode_steps"],
           "plan_bytes": sum(q.planes.numel() + q.values.numel()
                             for q in plans),
           "metrics": {k: v for k, v in res.items() if k != "requests"}}
    del plans
    log(f"qwen3 continuous (serve_continuous, {CONT_SLOTS} slots, "
        f"{CONT_REQUESTS} requests at {CONT_RATE}/step, sync_every 1): "
        f"{res['generated_tokens']} tokens in {res['wall_s']:.2f} s, "
        f"{res['tokens_per_s']:.1f} tokens/s; {res['decode_steps']} decode "
        f"steps, occupancy {res['mean_slot_occupancy']:.3f}; TTFT "
        f"p50/p90/p99 {res['ttft_steps_p50']:.1f}/{res['ttft_steps_p90']:.1f}"
        f"/{res['ttft_steps_p99']:.1f} steps, "
        f"{res['first_token_wall_s_p50']:.3f}/"
        f"{res['first_token_wall_s_p90']:.3f}/"
        f"{res['first_token_wall_s_p99']:.3f} s wall; latency p50/p90/p99 "
        f"{res['latency_steps_p50']:.1f}/{res['latency_steps_p90']:.1f}/"
        f"{res['latency_steps_p99']:.1f} steps; prefill "
        f"{out['prefill_ms_per_request']:.2f} ms per admitted request, "
        f"decode {out['decode_ms_per_step']:.2f} ms per step; B1 by route "
        f"{routes}; {seconds:.1f} s with set-up and restore")

    base = entry_streams(res)
    geometry = dict(num_slots=CONT_SLOTS, prompt_pad=LM_PROMPT,
                    max_len=LM_PROMPT + LM_GEN)
    trace = qwen3_trace(serving, cfg)
    few = trace[:CONT_VARIANT_REQUESTS]
    failures, checks = [], {}

    def run(p, c, reqs, label, **kw):
        sched = serving.ContinuousScheduler(p, c, **kw)
        sched.warmup()
        v = {}
        with patched((Engine, "prefill_step", timed(v, "prefill_s",
                                                    Engine.prefill_step)),
                     (Engine, "generate", timed(v, "decode_s",
                                                Engine.generate))):
            r = sched.run(reqs)
        m = r.metrics
        checks[label] = {
            "tokens_per_s": m["tokens_per_s"], "wall_s": m["wall_s"],
            "host_syncs": m["host_syncs"], "decode_steps": m["decode_steps"],
            "prefill_units": m["prefill_units"],
            "prefill_ms_per_request": v["prefill_s"] * 1e3 / m["prefills"],
            "decode_ms_per_step": v["decode_s"] * 1e3 / m["decode_steps"],
            "prefix_cache": m["prefix_cache"]}
        return r

    def same(label, got, want):
        want = {k: v for k, v in want.items() if k in got}
        diff = sorted(k for k in want if got[k] != want[k])
        checks.setdefault(label, {})["mismatched_requests"] = diff
        if diff or not want:
            failures.append(f"{label}: {len(diff)} of {len(want)} requests "
                            f"differ ({diff[:5]})")
        log(f"qwen3 check {label}: {len(want) - len(diff)} of {len(want)} "
            "requests' token streams and stop reasons equal")

    window = run(params, cfg, few, f"sync_every {CONT_WINDOW}",
                 sync_every=CONT_WINDOW, **geometry)
    same(f"sync_every {CONT_WINDOW} = 1", streams(window.completions), base)
    if window.metrics["host_syncs"] >= window.metrics["decode_steps"]:
        failures.append(f"sync_every {CONT_WINDOW} fused no decode steps")
    chunked = run(params, cfg, few, f"prefill_chunk {CONT_CHUNK}",
                  prefill_chunk=CONT_CHUNK, **geometry)
    same(f"chunked prefill ({CONT_CHUNK}) = whole",
         streams(chunked.completions), base)
    shared = qwen3_trace(serving, cfg, CONT_SHARED_PREFIX)[
        :CONT_VARIANT_REQUESTS]
    sgeo = dict(geometry, prompt_pad=LM_PROMPT + CONT_SHARED_PREFIX,
                max_len=LM_PROMPT + CONT_SHARED_PREFIX + LM_GEN)
    miss = run(params, cfg, shared, "shared prefix, no cache",
               prefill_chunk=CONT_CHUNK, **sgeo)
    hit = run(params, cfg, shared,
              f"shared prefix, prefix cache {CONT_PREFIX_CACHE}",
              prefill_chunk=CONT_CHUNK, prefix_cache=CONT_PREFIX_CACHE,
              **sgeo)
    same("prefix-cache hit = miss", streams(hit.completions),
         streams(miss.completions))
    if not hit.metrics["prefix_cache"]["hits"]:
        failures.append("the prefix cache took no hit")
    static = {}
    for r in trace[:CONT_STATIC_CHECKS]:
        toks = serving.static_generate(
            params, cfg, r.tokens, r.max_new_tokens,
            max_len=geometry["max_len"], prompt_pad=LM_PROMPT,
            rows=CONT_SLOTS).tolist()
        static[r.request_id] = (toks, "budget")   # no stop tokens here
    same("continuous = static", {k: base[k] for k in static}, static)
    out["profile"] = qwen3_window_profile(torch, serving, params, cfg, trace)

    import dataclasses
    short = dataclasses.replace(cfg, num_layers=CONT_EXACT_LAYERS)
    planned = serve_mod.plan_params_for_pim(
        mods["lm"].init_lm(short, 0, device=dev),
        mods["pim"].PimConfig(weight_bits=4, act_bits=4,
                              substrate="exact-cuda"))
    cuda_run = run(planned, short, trace, "2 layers exact-cuda", **geometry)
    torch_run = run(with_substrate(planned, "exact-torch"), short, trace,
                    "2 layers exact-torch", **geometry)
    same(f"{CONT_EXACT_LAYERS} layers exact-cuda = exact-torch",
         streams(cuda_run.completions), streams(torch_run.completions))
    del planned, params
    out["checks"] = checks
    out["failures"] = failures
    if failures:
        raise AssertionError("qwen3 continuous identities: "
                             + "; ".join(failures))
    return out


def ssd_entry(hymba, err):
    """The SSD kernel's line: one hymba request's 32 launches, each timed
    on the path's own inputs."""
    row = hymba["ssd_row"]
    count = row["launches_per_request"]
    return {
        "name": "ssd_scan", "path": "hymba-1.5b pim", "route": "cuda",
        "source": SSD_SOURCE, "replaces": REPLACES["ssd_scan"],
        "launches": hymba["launches"]["ssd_scan"],
        "max_abs_err": max(err, row["max_abs_err"]),
        "ms": row["ms"] * count, "plain_ms": row["plain_ms"] * count,
        "bound_ms": row["bound_ms"] * count, "bound_by": row["bound_by"],
        "library_ms": None,
        "bound_cuda_core_ms": row["bound_cuda_core_ms"] * count,
        "yardstick_ms": row["serial_ms"] * count,
        "per": (f"one hymba-1.5b request (batch {LM_BATCH}, prompt "
                f"{LM_PROMPT}): {count} launches of BH {row['BH']}, L "
                f"{row['L']}, P {row['P']}, N {row['N']}, Q {row['chunk']}"
                ", device time on the path's own inputs; bound_ms is the "
                "larger of the bytes and the products as 3xTF32 (three "
                "TF32 tensor-core products each at the dense TF32 peak), "
                "bound_cuda_core_ms the products as float32 at the CUDA "
                "cores' peak; yardstick_ms is the serial CUDA-core kernel "
                "it replaced (ssd_scan_serial), timed in turns with it; "
                "library_ms is null because no single PyTorch call "
                "computes the chunked SSD scan")}


# ---------------------------------------------------------------------------
# The training path: the flash-attention kernel, gemma3-1b training steps,
# checkpoint and restart
# ---------------------------------------------------------------------------
def flash_inputs(torch, dev, b, s, h, kv, d, seed):
    """q (b, s, h, d), k and v (b, s, kv, d): unit normals."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def flash_mask(torch, dev, s, causal, window, prefix):
    """The (s, s) boolean mask of the kernel and its plain version."""
    qp = torch.arange(s, device=dev)[:, None]
    kp = torch.arange(s, device=dev)[None, :]
    ok = (qp >= kp) if causal else torch.ones((s, s), dtype=torch.bool,
                                              device=dev)
    ok = ok | (kp < prefix)
    if window > 0:
        ok = ok & (((qp - kp) < window) | (kp < prefix))
    return ok


def flash_visited(s, causal, window, prefix, bq, bk):
    """(query, key) pairs in the bq x bk tiles the kernel visits, by the
    source's tile_live rule."""
    n = 0
    for q0 in range(0, s, bq):
        qlast = min(q0 + bq, s) - 1
        for k0 in range(0, s, bk):
            klast = min(k0 + bk, s) - 1
            if k0 >= prefix and ((causal and k0 > qlast) or
                                 (window > 0 and q0 - klast >= window)):
                continue
            n += (qlast - q0 + 1) * (klast - k0 + 1)
    return n


FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "flash_attention_bwd_sum")


def flash_bound(b, s, h, kv, d, pairs, kernel, ops_per_s=FP32_OPS_PER_S):
    """Least time (ms) of one launch of ``kernel``: its float32 operations
    at ``ops_per_s`` (the CUDA cores' peak by default; the tensor-core
    kernels, the forward, dQ and dK/dV, are priced at a third of the dense
    TF32 peak by ``tensor_core_bounds``), and the bytes of its inputs read
    once and its outputs written once at HBM bandwidth.
    Per unmasked pair and head the forward needs 2 products of width d (the
    logit, P V), the dQ pass 3 (the logit, dP, dQ) and the dK/dV pass 4
    (the logit, dP, dV, dK), at 2 operations per multiply-add; the head sum
    adds h / kv - 1 times per output element. Bytes: forward q, k, v in, o
    and the log-sum-exp out; dQ pass q, k, v, o, dO, lse in, dQ and delta
    out; dK/dV pass q, k, v, dO, lse, delta in, per-query-head dK and dV
    out; head sum the two partials in, dK and dV out.
    Returns (ms, "bytes" | "operations")."""
    qo, kvb, rows = b * s * h * d, b * s * kv * d, b * h * s
    flops, moved = {
        "flash_attention_fwd": (4 * d * pairs * b * h,
                                4 * (2 * qo + 2 * kvb + rows)),
        "flash_attention_bwd_dq": (6 * d * pairs * b * h,
                                   4 * (4 * qo + 2 * kvb + 2 * rows)),
        "flash_attention_bwd_dkv": (8 * d * pairs * b * h,
                                    4 * (4 * qo + 2 * kvb + 2 * rows)),
        "flash_attention_bwd_sum": (2 * (qo - kvb), 4 * (2 * qo + 2 * kvb)),
    }[kernel]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


# the kernels on the tensor cores (3xTF32 mma.sync): the forward and the
# two backward passes, each with the CUDA-core kernel it replaced kept in
# the library as a yardstick symbol
TC_PASSES = {"flash_attention_fwd": "flash_fwd_simt",
             "flash_attention_bwd_dq": "flash_bwd_dq_simt",
             "flash_attention_bwd_dkv": "flash_bwd_dkv_simt"}


def tensor_core_bounds(kernel, b, s, h, kv, d, pairs):
    """A tensor-core kernel's bounds: (the CUDA-core float32 bound, the bound
    of what its kernel runs), each (ms, "bytes" | "operations"). The kernel
    does every float32 product as three TF32 tensor-core products, so its
    operations count at a third of the dense TF32 peak."""
    args = (b, s, h, kv, d, pairs, kernel)
    return (flash_bound(*args),
            flash_bound(*args, ops_per_s=TF32_OPS_PER_S / 3))


def run_simt(torch, fkern, symbol, tensors, causal, window, prefix):
    """Call the C library's yardstick ``symbol`` (a CUDA-core kernel that a
    tensor-core pass replaced; the port's wrappers never call it) on the
    eight tensors of its pass's entry point (q, k, ..., then the
    outputs)."""
    import ctypes
    fn = getattr(fkern._library(), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    (b, s, h, d), kv = tensors[0].shape, tensors[1].shape[2]
    rc = fn(*(t.data_ptr() for t in tensors), b, s, h, kv, d, int(causal),
            window, prefix, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA error {rc}")


def fwd_simt(torch, fkern, q, k, v, causal, window, prefix):
    """o and lse through ``flash_fwd_simt`` (the forward's CUDA-core
    yardstick, which takes the forward's arguments), on the same inputs."""
    lib = fkern._library()
    fn = getattr(lib, TC_PASSES["flash_attention_fwd"])
    if fn.argtypes is None:
        fn.argtypes, fn.restype = lib.flash_fwd.argtypes, lib.flash_fwd.restype
    (b, s, h, d), kv = q.shape, k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), b, s, h, kv, d,
            int(causal), window, prefix,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd_simt: CUDA error {rc}")
    return o, lse


def dq_simt(torch, fkern, q, k, v, o, lse, dout, *mask):
    """dQ and delta through ``flash_bwd_dq_simt``, on the same inputs."""
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    run_simt(torch, fkern, TC_PASSES["flash_attention_bwd_dq"],
             (q, k, v, o, dout, lse, dq, delta), *mask)
    return dq, delta


def dkv_simt(torch, fkern, q, k, v, lse, delta, dout, *mask):
    """dK and dV through ``flash_bwd_dkv_simt``, on the same inputs."""
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    run_simt(torch, fkern, TC_PASSES["flash_attention_bwd_dkv"],
             (q, k, v, dout, lse, delta, dk, dv), *mask)
    return dk, dv


def probs_float64(torch, q, k, v, lse, delta, dout, causal, window,
                  prefix):
    """The plain version's P and dS (b, kv, rep, s, t) in float64 from
    float32 q, k, v, lse and dout and a (b, h, s) delta, with q and dout
    grouped by kv head (b, s, kv, rep, d) in float64."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.double().reshape(b, s, kv, h // kv, d)
    dog = dout.double().reshape(b, s, kv, h // kv, d)
    ok = flash_mask(torch, q.device, s, causal, window, prefix)
    p = torch.exp(torch.einsum("bskrd,btkd->bkrst", qg, k.double())
                  / math.sqrt(d) - lse.double().reshape(b, kv, h // kv, s, 1))
    p = torch.where(ok, p, torch.zeros((), dtype=p.dtype, device=p.device))
    ds = p * (torch.einsum("bskrd,btkd->bkrst", dog, v.double())
              - delta.double().reshape(b, kv, h // kv, s, 1))
    return p, ds, qg, dog


def fwd_float64(torch, q, k, v, causal, window, prefix):
    """o (b, s, h, d) and lse (b, h, s) in float64 from the forward's
    float32 inputs, with masked logits -1e30 as in the kernel."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.double().reshape(b, s, kv, h // kv, d)
    ok = flash_mask(torch, q.device, s, causal, window, prefix)
    logits = torch.where(ok, torch.einsum("bskrd,btkd->bkrst", qg,
                                          k.double()) / math.sqrt(d),
                         torch.tensor(-1e30, dtype=torch.float64,
                                      device=q.device))
    lse = torch.logsumexp(logits, -1)
    o = torch.einsum("bkrst,btkd->bskrd", torch.exp(logits - lse[..., None]),
                     v.double())
    return o.reshape(b, s, h, d), lse.reshape(b, h, s)


def plain_lse(torch, fref, q, k, causal, window, prefix):
    """The plain version's log-sum-exp (b, h, s) in float32."""
    b, s, h, _ = q.shape
    return torch.logsumexp(fref._logits(q, k, causal, window, prefix),
                           -1).reshape(b, h, s)


def dq_float64(torch, q, k, v, o, lse, dout, *mask):
    """dQ in float64 from the dQ pass's float32 inputs (delta = rowsum(dO
    * O) formed in float64); a one-tuple, as ``float64_gap`` takes it."""
    b, s, h, d = q.shape
    delta = (dout.double() * o.double()).sum(-1).transpose(1, 2)
    _, ds, _, _ = probs_float64(torch, q, k, v, lse, delta, dout, *mask)
    return (torch.einsum("bkrst,btkd->bskrd", ds, k.double())
            .reshape(b, s, h, d) / math.sqrt(d),)


def dkv_float64(torch, q, k, v, lse, delta, dout, *mask):
    """dK and dV of every query head in float64 from the dK/dV pass's
    float32 inputs."""
    b, s, h, d = q.shape
    p, ds, qg, dog = probs_float64(torch, q, k, v, lse, delta, dout, *mask)
    return (torch.einsum("bkrst,bskrd->btkrd", ds, qg).reshape(b, s, h, d)
            / math.sqrt(d),
            torch.einsum("bkrst,bskrd->btkrd", p, dog).reshape(b, s, h, d))


def float64_gap(got, truth):
    """Largest |got - truth| over a kernel's outputs ((o, lse), (dQ,) or
    (dK, dV)), each relative to that output's largest magnitude."""
    return max(((g.double() - t).abs().max() / t.abs().max()).item()
               for g, t in zip(got, truth))


def flash_gap(torch, got, want, rtol, atol, what):
    """Max |got - want|, raising unless |got - want| <= atol + rtol |want|
    everywhere."""
    diff = (got.double() - want.double()).abs()
    limit = atol + rtol * want.double().abs()
    if not bool(torch.isfinite(got).all()) or bool((diff > limit).any()):
        raise AssertionError(f"flash kernel outside rtol {rtol}, atol {atol}"
                             f" of its plain version ({what}): max |diff| "
                             f"{diff.max().item()}")
    return diff.max().item()


def flash_grad_gap(torch, got, want, what):
    """Max |got - want| of one gradient, raising above FLASH_BWD_REL of
    its largest magnitude."""
    gap = (got.double() - want.double()).abs().max().item()
    scale = want.double().abs().max().item()
    if not bool(torch.isfinite(got).all()) or gap > FLASH_BWD_REL * scale:
        raise AssertionError(f"flash backward {what}: max |diff| {gap} above"
                             f" {FLASH_BWD_REL} x {scale}")
    return gap


def sdpa_call(torch, q, k, v, mask):
    """torch's scaled_dot_product_attention on the same (b, s, h, d)
    tensors and boolean mask, as a yardstick (the port never calls it)."""
    import torch.nn.functional as F
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                          enable_gqa=True).transpose(1, 2)


def flash_shape_row(torch, dev, fkern, fref, label, shape):
    """The four kernels at one training shape: the forward against the
    plain version, the backward kernels' gradients against autograd of
    the plain version, and each backward kernel against its own plain
    version on the same inputs; the three tensor-core kernels (the
    forward, dQ, dK/dV) also against the CUDA-core kernels they replaced
    and a float64 evaluation; then each kernel's time, its plain version's
    and its bound (the tensor-core kernels in turns with their yardsticks,
    with both bounds), SDPA with the same mask (forward, and forward +
    backward) as a yardstick, the backward's three passes against SDPA's
    backward, and the pairs the kernels visit against those counted."""
    b, s, h, kv, d, causal, win, pre = shape
    mask_args = (causal, win, pre)
    q, k, v = flash_inputs(torch, dev, b, s, h, kv, d, 20)
    dout = flash_inputs(torch, dev, b, s, h, h, d, 21)[0]
    o, lse = fkern.flash_attention_fwd_cuda(q, k, v, *mask_args)
    dq, delta = fkern.flash_attention_bwd_dq_cuda(q, k, v, o, lse, dout,
                                                  *mask_args)
    dk_p, dv_p = fkern.flash_attention_bwd_dkv_cuda(q, k, v, lse, delta,
                                                    dout, *mask_args)
    dk, dv = fkern.flash_attention_bwd_sum_cuda(dk_p, dv_p, kv)
    torch.cuda.synchronize()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_o = fref.flash_attention_ref(*leaves, *mask_args)
    ref_o.backward(dout)
    row = {"shape": label, "b": b, "s": s, "h": h, "kv": kv, "d": d,
           "window": win, "prefix": pre}
    err = {"flash_attention_fwd": flash_gap(torch, o, ref_o.detach(),
                                            FLASH_RTOL, FLASH_ATOL, label)}
    row["grad_err"] = max(flash_grad_gap(torch, g, r.grad, f"{label} {n}")
                          for g, r, n in zip((dq, dk, dv), leaves, "qkv"))
    mask = flash_mask(torch, dev, s, causal, win, pre)
    lib_o = sdpa_call(torch, q, k, v, mask)
    row["sdpa_max_abs_gap"] = (lib_o - ref_o.detach()).abs().max().item()
    plain_o = ref_o.detach()
    del leaves, ref_o, lib_o
    fwd_name, dq_name, dkv_name = TC_PASSES
    want_dq, want_delta = fref.flash_attention_bwd_dq_ref(q, k, v, o, lse,
                                                          dout, *mask_args)
    err[dq_name] = max(
        flash_grad_gap(torch, dq, want_dq, f"{label} dQ pass"),
        flash_gap(torch, delta, want_delta, FLASH_DELTA_RTOL, FLASH_ATOL,
                  f"{label} delta"))
    want_dk, want_dv = fref.flash_attention_bwd_dkv_ref(
        q, k, v, lse, delta, dout, *mask_args)
    err[dkv_name] = max(
        flash_grad_gap(torch, dk_p, want_dk, f"{label} dK pass"),
        flash_grad_gap(torch, dv_p, want_dv, f"{label} dV pass"))
    # each tensor-core kernel beside the CUDA-core yardstick on the same
    # inputs (the yardstick against the plain version and the kernel
    # against the yardstick, each within the kernel's tolerance: the
    # forward's FLASH_RTOL and FLASH_ATOL, the backward's FLASH_BWD_REL),
    # and the three against float64: the kernel held within FLASH_F64_REL,
    # the others reported
    yard_dq, yard_delta = dq_simt(torch, fkern, q, k, v, o, lse, dout,
                                  *mask_args)
    if not torch.equal(yard_delta, delta):
        raise AssertionError(f"{label}: the dQ pass's delta differs from "
                             "the CUDA-core kernel's")
    fwd_gap = lambda got, want, what: flash_gap(torch, got, want, FLASH_RTOL,
                                                FLASH_ATOL, what)
    bwd_gap = lambda got, want, what: flash_grad_gap(torch, got, want, what)
    passes = {
        fwd_name: ("forward", fwd_gap, (o, lse),
                   (plain_o, plain_lse(torch, fref, q, k, *mask_args)),
                   fwd_simt(torch, fkern, q, k, v, *mask_args),
                   fwd_float64(torch, q, k, v, *mask_args)),
        dq_name: ("dQ", bwd_gap, (dq,), (want_dq,), (yard_dq,),
                  dq_float64(torch, q, k, v, o, lse, dout, *mask_args)),
        dkv_name: ("dK/dV", bwd_gap, (dk_p, dv_p), (want_dk, want_dv),
                   dkv_simt(torch, fkern, q, k, v, lse, delta, dout,
                            *mask_args),
                   dkv_float64(torch, q, k, v, lse, delta, dout,
                               *mask_args)),
    }
    row["yardstick_err"], row["vs_yardstick"], row["float64_gap"] = \
        {}, {}, {}
    for name, (what, gap, got, plain, yard, truth) in passes.items():
        row["yardstick_err"][name] = max(
            gap(y, w, f"{label} {what} yardstick")
            for y, w in zip(yard, plain))
        row["vs_yardstick"][name] = max(
            gap(g, y, f"{label} {what} kernel against the yardstick")
            for g, y in zip(got, yard))
        gaps = {"pass": float64_gap(got, truth),
                "yardstick": float64_gap(yard, truth),
                "plain": float64_gap(plain, truth)}
        row["float64_gap"][name] = gaps
        if gaps["pass"] > FLASH_F64_REL:
            raise AssertionError(
                f"{label}: the {what} kernel lies {gaps['pass']:.3g} of its "
                f"largest output from float64, above {FLASH_F64_REL}")
    del want_dq, want_delta, want_dk, want_dv, yard_dq, yard_delta, passes, \
        plain_o
    sums = fref.flash_attention_bwd_sum_ref(dk_p, dv_p, kv)
    err["flash_attention_bwd_sum"] = max(
        flash_gap(torch, got, want, FLASH_SUM_REL,
                  FLASH_SUM_REL * want.abs().max().item(), f"{label} sum")
        for got, want in zip((dk, dv), sums))
    # the head sum's own arithmetic: float32 adds in head order from 0
    for got, want in zip((dk, dv), fref.flash_attention_bwd_sum_ordered(
            dk_p, dv_p, kv)):
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: the head sum differs from the "
                                 "head-order float32 adds")
    row["err"] = err
    del sums

    def plain_fwd_bwd():
        ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
        fref.flash_attention_ref(*ls, *mask_args).backward(dout)

    def sdpa_fwd_bwd():
        ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
        sdpa_call(torch, *ls, mask).backward(dout)

    calls = {
        "flash_attention_fwd": (
            lambda: fkern.flash_attention_fwd_cuda(q, k, v, *mask_args),
            lambda: fref.flash_attention_ref(q, k, v, *mask_args)),
        dq_name: (
            lambda: fkern.flash_attention_bwd_dq_cuda(q, k, v, o, lse, dout,
                                                      *mask_args),
            lambda: fref.flash_attention_bwd_dq_ref(q, k, v, o, lse, dout,
                                                    *mask_args)),
        dkv_name: (
            lambda: fkern.flash_attention_bwd_dkv_cuda(
                q, k, v, lse, delta, dout, *mask_args),
            lambda: fref.flash_attention_bwd_dkv_ref(
                q, k, v, lse, delta, dout, *mask_args)),
        "flash_attention_bwd_sum": (
            lambda: fkern.flash_attention_bwd_sum_cuda(dk_p, dv_p, kv),
            lambda: fref.flash_attention_bwd_sum_ref(dk_p, dv_p, kv)),
    }
    yardsticks = {
        fwd_name: lambda: fwd_simt(torch, fkern, q, k, v, *mask_args),
        dq_name: lambda: dq_simt(torch, fkern, q, k, v, o, lse, dout,
                                 *mask_args),
        dkv_name: lambda: dkv_simt(torch, fkern, q, k, v, lse, delta, dout,
                                   *mask_args)}
    pairs = int(mask.sum())
    row["pairs_per_head"] = pairs
    for key in ("ms", "plain_ms", "bound_ms", "bound_by", "turns_ms",
                "yardstick_ms", "bound_cuda_core_ms"):
        row[key] = {}
    for name, (kernel_call, plain_call) in calls.items():
        if name == "flash_attention_bwd_sum":
            # a streaming pass of tens of microseconds: device time (queued
            # behind a spin kernel) for the kernel and for its plain
            # version, torch.sum, which is also the library call
            row["ms"][name] = device_ms(torch, lambda i: kernel_call())
            row["plain_ms"][name] = device_ms(torch, lambda i: plain_call())
            row["bound_ms"][name], row["bound_by"][name] = flash_bound(
                b, s, h, kv, d, pairs, name)
            continue
        row["plain_ms"][name] = time_ms(torch, plain_call)
        if name not in TC_PASSES:
            row["ms"][name] = time_ms(torch, kernel_call)
            row["bound_ms"][name], row["bound_by"][name] = flash_bound(
                b, s, h, kv, d, pairs, name)
            continue
        # a tensor-core kernel and its CUDA-core yardstick in turns
        # (yardstick, kernel, kernel, yardstick), and both bounds; bound_ms
        # is that of what the kernel runs (3xTF32)
        turns = [time_ms(torch, fn) for fn in (
            yardsticks[name], kernel_call, kernel_call, yardsticks[name])]
        row["turns_ms"][name] = turns
        row["ms"][name] = (turns[1] + turns[2]) / 2
        row["yardstick_ms"][name] = (turns[0] + turns[3]) / 2
        (row["bound_cuda_core_ms"][name], _), (row["bound_ms"][name],
                                               row["bound_by"][name]) = \
            tensor_core_bounds(name, b, s, h, kv, d, pairs)
    row["plain_fwd_bwd_ms"] = time_ms(torch, plain_fwd_bwd)
    row["sdpa_fwd_ms"] = time_ms(torch, lambda: sdpa_call(torch, q, k, v,
                                                          mask))
    row["sdpa_fwd_bwd_ms"] = time_ms(torch, sdpa_fwd_bwd)
    # the backward's three passes against SDPA's backward (its forward +
    # backward minus its forward)
    row["bwd_ms"] = sum(row["ms"][name] for name in FLASH_KERNELS[1:])
    row["sdpa_bwd_ms"] = row["sdpa_fwd_bwd_ms"] - row["sdpa_fwd_ms"]
    row["visited_fwd"] = flash_visited(s, causal, win, pre, 64, 32)
    row["visited_bwd"] = flash_visited(s, causal, win, pre, 32, 32)
    log(f"flash {label} b={b} s={s} h={h} kv={kv} d={d} window={win}: "
        + "; ".join(
            f"{name} {row['ms'][name]:.4f} ms (bound "
            f"{row['bound_ms'][name]:.4f} ms by {row['bound_by'][name]}, "
            f"plain {row['plain_ms'][name]:.4f} ms, max |diff| "
            f"{err[name]:.3g})" for name in FLASH_KERNELS))
    for name, symbol in TC_PASSES.items():
        gaps = row["float64_gap"][name]
        log(f"flash {label} {name} against the CUDA-core yardstick "
            f"{symbol} in turns (yardstick, kernel, kernel, yardstick): "
            + ", ".join(f"{t:.4f}" for t in row["turns_ms"][name])
            + f" ms, bounds {row['bound_ms'][name]:.4f} ms (3xTF32 at "
            f"{TF32_OPS_PER_S / 3e12:.0f} TFLOP/s) and "
            f"{row['bound_cuda_core_ms'][name]:.4f} ms (CUDA-core float32),"
            f" max |diff| to the yardstick {row['vs_yardstick'][name]:.3g},"
            f" the yardstick's to the plain version "
            f"{row['yardstick_err'][name]:.3g}; against float64 on the same"
            f" inputs, relative to each output's largest magnitude: the "
            f"kernel {gaps['pass']:.3g} (held within {FLASH_F64_REL}), the "
            f"yardstick {gaps['yardstick']:.3g}, the plain version "
            f"{gaps['plain']:.3g}")
    log(f"flash {label} head sum (device time): "
        f"{row['ms']['flash_attention_bwd_sum']:.4f} ms against torch.sum's "
        f"{row['plain_ms']['flash_attention_bwd_sum']:.4f} ms, bound "
        f"{row['bound_ms']['flash_attention_bwd_sum']:.4f} ms by "
        f"{row['bound_by']['flash_attention_bwd_sum']}; equal to the "
        "head-order float32 adds bit for bit")
    log(f"flash {label}: the backward's three passes {row['bwd_ms']:.4f} ms"
        f" against SDPA's backward {row['sdpa_bwd_ms']:.4f} ms (SDPA "
        f"forward {row['sdpa_fwd_ms']:.4f} ms, forward+backward "
        f"{row['sdpa_fwd_bwd_ms']:.4f} ms); the plain version's autograd "
        f"forward+backward {row['plain_fwd_bwd_ms']:.4f} ms; the backward "
        f"kernels' gradients against that autograd: max |diff| "
        f"{row['grad_err']:.3g}; unmasked pairs per head {pairs}, visited "
        f"by the forward's 64x32 tiles {row['visited_fwd']} "
        f"({row['visited_fwd'] / pairs:.3f}x), by the backward passes' "
        f"32x32 tiles {row['visited_bwd']} "
        f"({row['visited_bwd'] / pairs:.3f}x); SDPA's gap to the plain "
        f"version {row['sdpa_max_abs_gap']:.3g} (reported)")
    del q, k, v, dout, o, lse, dq, delta, dk_p, dv_p, dk, dv
    torch.cuda.empty_cache()
    return row


def flash_kernel_phase(torch, dev, fkern, fref):
    """The flash kernels against their plain versions: forward on
    FLASH_CASES in float32 and bfloat16, then all four kernels at
    gemma3-1b's training shapes with their times."""
    err = dict.fromkeys(FLASH_KERNELS, 0.0)
    for i, (b, s, h, kv, d, causal, win, pre) in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(torch, dev, b, s, h, kv, d, 10 + i)
        args = (causal, win, pre)
        got, _ = fkern.flash_attention_fwd_cuda(q, k, v, *args)
        what = f"b={b} s={s} h={h} kv={kv} d={d} causal={causal} " \
            f"window={win} prefix={pre}"
        gap = flash_gap(torch, got, fref.flash_attention_ref(q, k, v, *args),
                        FLASH_RTOL, FLASH_ATOL, what)
        err["flash_attention_fwd"] = max(err["flash_attention_fwd"], gap)
        qb, kb, vb = (t.bfloat16() for t in (q, k, v))
        got_b, _ = fkern.flash_attention_fwd_cuda(qb, kb, vb, *args)
        gap_b = flash_gap(torch, got_b.float(), fref.flash_attention_ref(
            qb, kb, vb, *args).float(), FLASH_BF16_TOL, FLASH_BF16_TOL,
            what + " bf16")
        log(f"flash check {what}: float32 within rtol {FLASH_RTOL}, atol "
            f"{FLASH_ATOL} (max |diff| {gap:.3g}), bfloat16 within "
            f"{FLASH_BF16_TOL} (max |diff| {gap_b:.3g})")
    rows = {label: flash_shape_row(torch, dev, fkern, fref, label, shape)
            for label, shape in GEMMA_FLASH.items()}
    for row in rows.values():
        for name in FLASH_KERNELS:
            err[name] = max(err[name], row["err"][name])
    return err, rows


TRAIN_PROFILED = (  # (module, attribute, range name) wrapped while profiling
    ("lm", "unembed", "logits (unembed GEMM, forward)"),
    ("train", "cross_entropy", "loss (forward)"),
    ("train", "adamw_update", "optimizer"),
)
TRAIN_KERNELS = {"flash fwd": ("flash_fwd_kernel",),
                 "flash bwd dQ": ("flash_bwd_dq_kernel",),
                 "flash bwd dK/dV": ("flash_bwd_dkv_kernel",),
                 "flash bwd head sum": ("flash_bwd_sum_heads",),
                 "GEMMs": ("gemm",)}   # cuBLAS's sm80_xmma_gemm_*, sgemm


def train_path(torch, dev, mods, counters):
    """gemma3-1b at full width (26 layers, d_model 1152, vocab 262144),
    float32 parameters from seed 0, attn_backend="cuda": the loss and
    gradient norm against the "jnp" route on one state, then AdamW steps
    through make_train_step (one warm-up, TRAIN_STEPS timed, launch counts
    set to 0 just before and read just after), one step with int8 gradient
    compression, and a profiled step."""
    import dataclasses
    from repro_torch.data.pipeline import DataConfig, LMDataIterator
    from repro_torch.optim.adamw import AdamWConfig, global_norm
    from repro_torch.optim.compression import init_error_state
    train, lm, fkern = mods["train"], mods["lm"], mods["flash_kern"]
    cfg = dataclasses.replace(mods["configs"].get_config("gemma3-1b"),
                              attn_backend="cuda")
    layers = cfg.num_layers
    it = LMDataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH), cfg)
    batches = [train.batch_to_device(next(it), dev)
               for _ in range(TRAIN_STEPS + 4)]
    out = {"config": {"arch": cfg.name, "layers": layers,
                      "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                      "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                      "windows": dict(Counter(cfg.layer_window(i)
                                              for i in range(layers)))}}

    params = lm.init_lm(cfg, 0, device=dev)
    out["parameters"] = sum(p.numel() for p in mods["tree"].leaves(params))
    leaves = mods["tree"].leaves
    loss_j, _, grads_j = train.loss_and_grads(
        params, dataclasses.replace(cfg, attn_backend="jnp"), batches[0])
    gnorm_j = global_norm(grads_j).item()

    def against_jnp(run_cfg):
        """Loss, gradient norm and the largest per-leaf gradient gap (over
        that leaf's largest gradient) of ``run_cfg`` against "jnp"."""
        loss, _, grads = train.loss_and_grads(params, run_cfg, batches[0])
        gap = max((g - gj).abs().max().item()
                  / max(gj.abs().max().item(), 1e-30)
                  for g, gj in zip(leaves(grads), leaves(grads_j)))
        return loss.item(), global_norm(grads).item(), gap

    reset_counts(*counters)
    loss_c, gnorm_c, leaf_gap = against_jnp(cfg)
    once = read_counts(*counters)
    # the control: the same route with every layer global, as a kernel
    # wired without its window would run
    control = against_jnp(dataclasses.replace(cfg, sliding_window=0))
    del grads_j, params
    torch.cuda.empty_cache()
    loss_j = loss_j.item()
    out["cuda_vs_jnp"] = {"loss_cuda": loss_c, "loss_jnp": loss_j,
                          "grad_norm_cuda": gnorm_c, "grad_norm_jnp": gnorm_j,
                          "max_leaf_grad_gap_rel": leaf_gap,
                          "launches": once,
                          "control_all_global": dict(zip(
                              ("loss", "grad_norm", "max_leaf_grad_gap_rel"),
                              control))}
    log(f"gemma3-1b, one state: loss cuda {loss_c:.7f} vs jnp {loss_j:.7f} "
        f"(rel {abs(loss_c - loss_j) / abs(loss_j):.3g}), gradient norm "
        f"cuda {gnorm_c:.7g} vs jnp {gnorm_j:.7g} (rel "
        f"{abs(gnorm_c - gnorm_j) / gnorm_j:.3g}), largest per-leaf "
        f"gradient gap {leaf_gap:.3g} of the leaf's largest gradient "
        f"(limit {TRAIN_LEAF_GAP_REL}); launches {once}; control (cuda, "
        f"every layer global): loss {control[0]:.7f}, gradient norm "
        f"{control[1]:.7g}, largest per-leaf gap {control[2]:.3g}")
    if abs(loss_c - loss_j) > TRAIN_LOSS_REL * abs(loss_j) or \
            abs(gnorm_c - gnorm_j) > TRAIN_GNORM_REL * gnorm_j or \
            leaf_gap > TRAIN_LEAF_GAP_REL or \
            any(once[name] != layers for name in FLASH_KERNELS):
        raise AssertionError(f"the cuda route differs from jnp: {out}")
    if not control[2] > TRAIN_LEAF_GAP_REL:
        raise AssertionError(f"the per-leaf check does not see a lost "
                             f"window: control gap {control[2]}")

    state = train.init_state(cfg, 0, device=dev)
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=100, warmup_steps=5)
    step_fn = train.make_train_step(cfg, opt_cfg)
    state, _ = step_fn(state, batches[0])                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters)
    step_ms, losses = [], []
    for batch in batches[1:1 + TRAIN_STEPS]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step_fn(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(metrics["loss"].item())
    launches = read_counts(*counters)
    want = dict.fromkeys(FLASH_KERNELS, layers * TRAIN_STEPS)
    if any(launches[k] != v for k, v in want.items()) or any(
            launches[k] for k in launches if k not in want) or \
            not all(map(math.isfinite, losses)):
        raise AssertionError(f"training launches {launches} (expected "
                             f"{want} and no other kernel), losses {losses}")
    med = statistics.median(step_ms)
    out.update({"step_ms": step_ms, "step_ms_median": med,
                "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (med / 1e3),
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "losses": losses, "launches": launches,
                "launches_per_step": {k: v // TRAIN_STEPS
                                      for k, v in want.items()}})
    log(f"gemma3-1b training (batch {TRAIN_BATCH} x {TRAIN_SEQ}, AdamW, "
        f"attn cuda): step median {med:.3f} ms ("
        + ", ".join(f"{t:.3f}" for t in step_ms)
        + f"), {out['tokens_per_s']:.1f} tokens/s, peak device memory "
        f"{out['peak_bytes'] / 2 ** 30:.3f} GiB, losses "
        + ", ".join(f"{x:.5f}" for x in losses)
        + f"; launches per step: {layers} of each of " + ", ".join(want))

    state["grad_err"] = init_error_state(state["params"])
    reset_counts(*counters)
    state, metrics = train.make_train_step(cfg, opt_cfg, compress_bits=8)(
        state, batches[1 + TRAIN_STEPS])
    comp = read_counts(*counters)
    out["compressed_step"] = {"loss": metrics["loss"].item(),
                              "grad_norm": metrics["grad_norm"].item(),
                              "launches": comp}
    if any(comp[name] != layers for name in FLASH_KERNELS) or \
            not bool(torch.isfinite(metrics["loss"])):
        raise AssertionError(f"compressed step: {out['compressed_step']}")
    log(f"gemma3-1b step with int8 gradient compression: loss "
        f"{out['compressed_step']['loss']:.5f}, gradient norm "
        f"{out['compressed_step']['grad_norm']:.5g}, launches {comp}")
    del state["grad_err"]
    torch.cuda.empty_cache()

    run = lambda: step_fn(state, batches[2 + TRAIN_STEPS])
    out["profile"] = profile_request(
        torch, mods, run, TRAIN_KERNELS, "gemma3-1b training step",
        profiled=TRAIN_PROFILED,
        nested={"GEMMs": ("logits (unembed GEMM, forward)",)})
    del state
    torch.cuda.empty_cache()
    return out


def restart_phase(train):
    """Checkpoint and restart on the card at a reduced gemma3-1b (2
    layers, d_model 256, vocab 512, attn cuda): an unbroken run of 10
    steps writes a checkpoint at step 6; a second run resumes from it
    (state, step and data position) and runs steps 6-9 under the same
    schedule. The two last losses must agree within RESTART_TOL: the
    resumed run repeats the same arithmetic, and only the card's
    atomics (the embedding gradient's scatter-add) may reorder sums."""
    import shutil
    ck = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    kw = dict(steps=10, batch=2, seq=128, layers=2, d_model=256,
              log_every=1, device="cuda", attn_backend="cuda")
    straight = train.train_loop("gemma3-1b", ckpt_dir=str(ck), ckpt_every=6,
                                **kw)
    resumed = train.train_loop("gemma3-1b", ckpt_dir=str(ck),
                               ckpt_every=100, **kw)
    shutil.rmtree(ck, ignore_errors=True)
    gap = abs(resumed["last_loss"] - straight["last_loss"])
    log(f"restart: the run resumed at step 6 ends at loss "
        f"{resumed['last_loss']:.7f}, the unbroken run at "
        f"{straight['last_loss']:.7f}, gap {gap:.3g}")
    if gap > RESTART_TOL:
        raise AssertionError(f"resumed training differs: gap {gap}")
    return {"resumed": resumed, "straight": straight, "gap": gap}


def flash_entries(rows, windows, launches, err):
    """The four flash kernels' lines: one training step's launches (each
    kernel once per layer), each priced at its window's shape, with the
    time of one launch at each shape; the three tensor-core kernels (the
    forward, dQ, dK/dV) also with their CUDA-core float32 bound and the
    CUDA-core kernel each replaced, timed in turns with it."""
    count = {"local": sum(n for w, n in windows.items() if w),
             "global": windows.get(0, 0)}
    tot = lambda key, name: sum(rows[lb][key][name] * n
                                for lb, n in count.items())
    per = (f"one gemma3-1b training step (batch {TRAIN_BATCH}, seq "
           f"{TRAIN_SEQ}): {count['local']} layers at window 512 and "
           f"{count['global']} global, each shape timed alone on random "
           f"inputs; launches counts the main path's {TRAIN_STEPS} timed "
           "steps")
    library = {
        "flash_attention_fwd": (
            sum(rows[lb]["sdpa_fwd_ms"] * n for lb, n in count.items()),
            "library_ms is scaled_dot_product_attention with the same "
            "boolean mask"),
        "flash_attention_bwd_dq": (None, "no single PyTorch call computes "
                                   "the dQ pass alone"),
        "flash_attention_bwd_dkv": (None, "no single PyTorch call computes "
                                    "the dK/dV pass alone"),
        "flash_attention_bwd_sum": (
            tot("plain_ms", "flash_attention_bwd_sum"),
            "the plain version is torch.sum over each kv head's query "
            "heads, which is also the library call; kernel and torch.sum "
            "timed as device time queued behind a spin kernel"),
    }
    sdpa_bwd = sum((rows[lb]["sdpa_fwd_bwd_ms"] - rows[lb]["sdpa_fwd_ms"])
                   * n for lb, n in count.items())
    entries = []
    for name in FLASH_KERNELS:
        bound_by = Counter({rows[lb]["bound_by"][name]:
                            rows[lb]["bound_ms"][name] * n
                            for lb, n in count.items()}).most_common(1)[0][0]
        lib_ms, lib_note = library[name]
        note = per + "; " + lib_note
        if name != "flash_attention_fwd":
            note += (f"; for scale, SDPA's whole backward (forward+backward "
                     f"minus forward) takes {sdpa_bwd:.4f} ms per step")
        entry = {
            "name": name, "path": "gemma3-1b training", "route": "cuda",
            "source": FLASH_SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err[name],
            "ms": tot("ms", name), "plain_ms": tot("plain_ms", name),
            "bound_ms": tot("bound_ms", name), "bound_by": bound_by,
            "library_ms": lib_ms, "per": note,
            "per_launch_ms": {lb: rows[lb]["ms"][name] for lb in count}}
        if name in TC_PASSES:
            # the kernel runs 3xTF32 on the tensor cores: bound_ms is at a
            # third of the dense TF32 peak; beside it the CUDA-core float32
            # bound and the CUDA-core kernel it replaced (the yardstick
            # symbol), timed in turns with the kernel on the same inputs
            entry["bound_cuda_core_ms"] = tot("bound_cuda_core_ms", name)
            entry["yardstick_ms"] = tot("yardstick_ms", name)
            entry["yardstick_per_launch_ms"] = {
                lb: rows[lb]["yardstick_ms"][name] for lb in count}
            entry["per"] += (
                "; bound_ms counts 3 TF32 tensor-core products per float32 "
                "product at the dense TF32 peak, bound_cuda_core_ms the "
                "float32 products at the CUDA cores' peak; yardstick_ms is "
                f"the CUDA-core kernel it replaced ({TC_PASSES[name]})")
        entries.append(entry)
    return entries


def study_phase(table2):
    """The ADC ablation and Table II on the card; each row printed."""
    out = {}
    for name, fn in (("adc_ablation", table2.run_adc_ablation),
                     ("table2", table2.run_table2)):
        t0 = time.perf_counter()
        rows = fn()
        out[name] = {"rows": rows, "seconds": time.perf_counter() - t0}
        for key, value, note in rows:
            log(f"{key}: {value:.4f} {note}".rstrip())
        log(f"{name}: {out[name]['seconds']:.1f} s")
    return out


def log_latency(what, path):
    log(f"{what} request latency: median {path['latency_ms_median']:.3f} ms"
        f" (each of {REQUESTS}: "
        + ", ".join(f"{t:.3f}" for t in path["latency_ms"])
        + f"), {path['images_per_s']:.1f} images/s"
        + (f", programming {path['program_s']:.3f} s" if "program_s" in path
           else "")
        + f", peak device memory {path['peak_bytes'] / 2 ** 30:.3f} GiB")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", type=Path, default=None,
                        help="also write the run's numbers to this file")
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on "
              "an NVIDIA GPU only", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.benchmarks_impl import table2
    from repro_torch.core import pim, workloads
    from repro_torch.data import pipeline
    from repro_torch.kernels import runtime
    from repro_torch.kernels.analog_readout import analog_readout as akern
    from repro_torch.kernels.analog_readout import ops as aops
    from repro_torch import tree
    from repro_torch.kernels.analog_readout import ref as aref
    from repro_torch.kernels.flash_attention import flash_attention as fkern
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.pim_matmul import ops as pops
    from repro_torch.kernels.pim_matmul import pim_matmul as kern
    from repro_torch.kernels.pim_matmul import ref
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.kernels.ssd_scan import ssd_scan as skern
    from repro_torch import engine, serving
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train
    from repro_torch.models import attention, cnn, lm, moe, ssm

    # every plain version that runs on the card here (the SSD scan's
    # chunked form, the LM's float matmuls) runs in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    runtime.build_all()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.1f} s (nvcc, sm_90a, one process per "
        "source)")
    sass = sass_check(runtime)

    err = kernel_phase(torch, dev, kern, ref)
    analog_err, noisy, adc_rows = analog_kernel_phase(torch, dev, akern,
                                                      aref)
    err.update(analog_err)
    ssd_err, ssd_rows = ssd_kernel_phase(torch, dev, skern, sref)
    flash_err, flash_rows = flash_kernel_phase(torch, dev, fkern, fref)
    counters = (kern, akern, skern, fkern)
    model = build_model(torch, dev, cnn, workloads, pipeline)
    path, run_request, exact_logits = main_path(torch, model, cnn, pim,
                                                counters)
    log_latency("exact", path)
    profile = profile_request(torch, {"cnn": cnn, "pim": pim}, run_request,
                              PIM_KERNELS, "exact")
    rows = shape_numbers(torch, dev, kern, ref, path["shapes"])
    kernels = [kernel_entry("pim_matmul_fused", "fused", rows,
                            path["launches"], err,
                            routes=path["launches_by_route"]),
               kernel_entry("pim_matmul_int", "int", rows,
                            path["launches"], err)]

    apath, run_analog = analog_path(torch, model, cnn, pim, counters,
                                    exact_logits)
    log_latency("analog", apath)
    aprofile = profile_request(torch, {"cnn": cnn, "pim": pim}, run_analog,
                               ANALOG_KERNELS, "analog")
    arows = analog_shape_numbers(torch, akern, aref, apath["shapes"],
                                 capture_analog_inputs(aops, run_analog))
    kernels += analog_entries(arows, apath, err)
    studies = study_phase(table2)

    mods = {"lm": lm, "serve": serve_mod, "pim": pim, "configs": configs,
            "attention": attention, "ssm": ssm, "ssd_kern": sops,
            "ssd_wrap": skern, "ssd_ref": sref, "pim_ops": pops,
            "pim_kern": kern,
            "pim_ref": ref}
    hymba = hymba_path(torch, dev, mods, counters)
    lm_err = lm_kernel_checks(torch, dev, kern, ref, hymba["shapes"])
    lm_rows = shape_numbers(torch, dev, kern, ref, hymba["shapes"],
                            with_bias=False)
    hymba["b1_by_phase"] = b1_by_phase(lm_rows)
    hymba["b1_threshold"] = threshold_rows(torch, dev, kern)
    b1 = hymba["b1_by_phase"]
    kernels.append(kernel_entry(
        "pim_matmul_fused", "fused", lm_rows, hymba["launches"],
        {"pim_matmul_fused": lm_err}, path="hymba-1.5b pim",
        routes=hymba["launches_by_route"],
        per=(f"one hymba-1.5b request (batch {LM_BATCH}, prompt "
             f"{LM_PROMPT}, {LM_GEN} new tokens, w4a4): sum over the "
             f"prefill's launches (wgmma route, device time: "
             f"{b1['prefill_ms']:.4f} ms, the mma.sync yardstick "
             f"{b1['prefill_mma_sync_ms']:.4f} ms, bound "
             f"{b1['prefill_bound_ms']:.4f} ms) and the decode steps' "
             "(small-M route, device time with cold weights: "
             f"{b1['decode_ms']:.4f} ms; the tiled yardstick at the same "
             f"shapes takes {b1['decode_tiled_ms']:.4f} ms); library_ms "
             "and library_kmajor_ms cover the prefill shapes "
             "(torch._int_mm takes M > 16); yardstick_ms sums the "
             "mma.sync yardstick over the prefill shapes only")))
    kernels.append(ssd_entry(hymba, ssd_err))
    entry = serve_entry_phase(torch, serve_mod, configs, counters)
    mamba2 = mamba2_path(torch, dev, mods, counters)
    mods["moe"] = moe
    moonshot = moonshot_path(torch, dev, mods, counters)
    moe_err = lm_kernel_checks(torch, dev, kern, ref, moonshot["shapes"])
    moe_rows = shape_numbers(torch, dev, kern, ref, moonshot["shapes"],
                             with_bias=False)
    moonshot["b1_by_phase"] = b1_by_phase(moe_rows, "moonshot")
    b1 = moonshot["b1_by_phase"]
    kernels.append(kernel_entry(
        "pim_matmul_fused", "fused", moe_rows, moonshot["launches"],
        {"pim_matmul_fused": moe_err}, path="moonshot-v1-16b-a3b pim",
        routes=moonshot["launches_by_route"],
        per=(f"one moonshot-v1-16b-a3b request (batch {LM_BATCH}, prompt "
             f"{LM_PROMPT}, {LM_GEN} new tokens, w4a4; "
             f"{moe_layer_launches(configs.get_config(MOONSHOT))} launches "
             "per layer and step, 48 layers): sum over the prefill's "
             f"launches (wgmma route, device time: {b1['prefill_ms']:.3f} "
             f"ms, the mma.sync yardstick {b1['prefill_mma_sync_ms']:.3f} "
             f"ms, bound {b1['prefill_bound_ms']:.3f} ms) and the decode "
             "steps' (small-M route, device time with cold weights: "
             f"{b1['decode_ms']:.3f} ms, the tiled yardstick "
             f"{b1['decode_tiled_ms']:.3f} ms, bound "
             f"{b1['decode_bound_ms']:.3f} ms); library_ms covers the "
             "prefill shapes (torch._int_mm takes M > 16)")))
    mods.update({"serving": serving, "engine": engine, "ckpt": ckpt})
    qwen3, qwen3_cont = qwen3_phases(torch, dev, mods, counters)
    q_err = lm_kernel_checks(torch, dev, kern, ref, qwen3_cont["shapes"])
    q_rows = shape_numbers(torch, dev, kern, ref, qwen3_cont["shapes"],
                           with_bias=False)
    qwen3_cont["b1_by_phase"] = b1_by_phase(q_rows, "qwen3 continuous")
    b1 = qwen3_cont["b1_by_phase"]
    kernels.append(kernel_entry(
        "pim_matmul_fused", "fused", q_rows, qwen3_cont["launches"],
        {"pim_matmul_fused": q_err}, path="qwen3-4b continuous pim",
        routes=qwen3_cont["launches_by_route"],
        per=(f"one continuous qwen3-4b run ({CONT_REQUESTS} Poisson "
             f"requests at {CONT_RATE}/step through {CONT_SLOTS} slots, "
             f"prompts {LM_PROMPT // 4}-{LM_PROMPT}, {LM_GEN // 4}-{LM_GEN} "
             "new tokens, w4a4; launches include the warm-up's prefill and "
             "decode step): sum over the whole prefills' launches (wgmma "
             f"route at M = {LM_PROMPT}, device time "
             f"{b1['prefill_ms']:.3f} ms, bound {b1['prefill_bound_ms']:.3f}"
             f" ms) and the decode steps' (small-M route at M = "
             f"{CONT_SLOTS}, device time with cold weights "
             f"{b1['decode_ms']:.3f} ms, bound {b1['decode_bound_ms']:.3f} "
             "ms); library_ms covers the prefill shapes (torch._int_mm "
             "takes M > 16)")))
    mods.update({"train": train, "flash_kern": fkern, "tree": tree})
    training = train_path(torch, dev, mods, counters)
    kernels += flash_entries(flash_rows, training["config"]["windows"],
                             training["launches"], flash_err)
    restart = restart_phase(train)
    log(f"command time after the card query: "
        f"{time.perf_counter() - t_start:.1f} s")

    if opts.json is not None:
        opts.json.parent.mkdir(parents=True, exist_ok=True)
        listed = lambda p: dict(p, shapes=[list(s) + [c] for s, c in
                                           p["shapes"].items()])
        opts.json.write_text(json.dumps(
            {"card": smi, "build_s": build_s, "sass": sass,
             "main_path": listed(path),
             "profile": profile, "shapes": rows,
             "analog_path": listed(apath), "analog_profile": aprofile,
             "analog_shapes": arows, "analog_noisy_checks": noisy,
             "adc_checks": adc_rows,
             "studies": studies, "ssd_shapes": ssd_rows,
             "hymba": listed(hymba), "hymba_shapes": lm_rows,
             "serve_entry": entry, "mamba2": mamba2,
             "moonshot": listed(moonshot), "moonshot_shapes": moe_rows,
             "qwen3_persist": qwen3, "qwen3_continuous": listed(qwen3_cont),
             "qwen3_shapes": q_rows,
             "flash_shapes": flash_rows, "train": training,
             "restart": restart, "kernels": kernels},
            indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
