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
12. the MoE path: moonshot-v1-16b-a3b at full width (d_model 2048, 64
    experts top-6 of d_ff 1408, 2 shared experts, vocab 163840, random
    weights from seed 0): first at 2 layers, its prefill and 16 decode
    steps' logits on ``exact-cuda`` bit-identical to ``exact-torch``;
    then ``repro_torch.launch.serve``'s programming, which programs each
    layer at w4a4 on ``exact-cuda`` as it is drawn (the float32 expert
    stacks never exist at once), of ``MOE_SERVE_LAYERS`` (6) of its 48
    layers, and the static loop (batch 8, prompt 512, 16 new tokens): 199
    PIM launches per layer
    and forward step (4 attention, 3 shared, 3 x 64 expert), all on the
    wgmma route in prefill and on the small-M route in decode, no other
    kernel; prefill and decode times, tokens/s, programming time, peak
    memory, the weight planes one decode step reads and their bytes
    bound, a profile of one request by stage (B1 by route, quantize +
    nibbles, plane padding, the (E, T, ·) glue, the combine, attention,
    the router); then the PIM kernel at the path's ten shapes (M = 4096
    and 8) bit for bit and timed as for hymba;
12b. the encoder-decoder and the VLM prefix served: whisper-medium (24
    encoder + 24 decoder layers, d_model 1024, 16 heads, d_ff 4096, vocab
    51865) and paligemma-3b (18 layers, d_model 2048, 8 heads on 1 KV
    head, head_dim 256, d_ff 16384, vocab 257216, 256 stub patches of dim
    1152) at full width, random weights from seed 0: first at
    ``FAMILY_EXACT_LAYERS`` (2) layers of each stack, the prefill logits
    and 16 decode steps' logits on ``exact-cuda`` bit-identical to
    ``exact-torch``; then serving's set-up (each layer of both stacks
    programmed at w4a4 on ``exact-cuda`` as it is drawn) at full depth and
    the static loop with ``request_inputs``'s stub frames or patches
    (batch 8, prompt 512, 16 new tokens; a warm-up and ``LM_REQUESTS``
    (2) timed): B1 launches per prefill and per decode
    step as ``family_b1_launches`` gives them (whisper 384 and 192,
    paligemma 126 and 126), no other kernel; prefill and decode times,
    tokens/s, resident and peak memory, and one request's device idle
    share;
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
    load's sha256 share timed) with 8 slots and 4 Poisson requests at
    0.5 per step (seed 0), prompts 128-512, 4-16 new tokens: launches by
    route (whole prefill on the wgmma route, decode at M = 8 on the
    small-M route, none other), tokens/s, TTFT and latency percentiles
    (virtual steps and wall), prefill ms per admitted request, decode ms
    per step; the restored plans' static request equal to phase 13's bit
    for bit (prefill logits and tokens); on the restored plans
    ``sync_every`` 4 = 1, chunked prefill (64) = whole and a prefix-cache
    hit = a miss (shared prefix 128) on the trace's 4 requests,
    two requests' streams = ``static_generate`` at the slots' shapes,
    and at 2 layers ``exact-cuda`` = ``exact-torch`` for the whole trace
    (token streams and stop reasons); one fused decode window profiled
    (idle share); then the PIM kernel at the path's ten shapes (M = 512
    and 8) bit for bit and timed as for hymba; the directory is deleted;
15. ABFT-verified continuous serving (the reliability slice): phase 14's
    restored plans programmed once more with ``verify="always"`` from
    their codes (``pim.plan_from_qtensor``; planes unchanged, each plan
    tagged with its layer stack's path), then phase 14's trace through
    ``ContinuousScheduler(..., reliability=ReliabilityManager(...))``:
    verify off, ``sample`` and ``always`` on clean plans (0 violations,
    checks = verified dispatches x armed tags, every B1 launch with its
    row-sum epilogue), ``always`` under ``REL_FAULTS`` (bit-flips, a
    stuck plane with a dark WDM chunk, ADC drift) with the chaos check
    (``serve.chaos_verdict``: tokens equal the verify-off run's,
    detections, replays, repairs, degraded mode as the policy implies),
    and ``sync_every`` 4 on the trace's first 4 requests with a transient
    fault and no repair, so that fused windows are replayed from the
    restored cache; every run's token streams and stop reasons equal the
    verify-off run's; prefill ms per admitted request and decode ms per
    step at off / sample / always, recovery latencies, B1's row-sum
    launches by route, each beside the card's name and power limit; then
    B1 with and without its row-sum epilogue at the verified run's
    shapes (M = 512 and 8), bit for bit, timed in turns with cold
    weights;
15b. the sanitizers and the lint (A13), on phase 14's restored plans:
    the trace's first 4 requests through 8 slots in CUDA's sync debug
    mode "warn" (the synchronizing calls per decode dispatch and per
    decode step call, with their source lines), then unarmed and armed
    in turns (``Sanitizer``: mode "error" around every decode step, the
    compile counter: prefill, insert and decode once each), streams
    equal, decode ms per step each beside the card's name and power
    limit; beside it, in subprocesses, the serve CLI's ``--continuous
    --sanitize`` on a reduced qwen3 with ``--compile-cache-dir`` at this
    run's kernel build directory (0 ``nvcc`` builds, every library
    loaded from there) and ``python -m repro_torch.analysis`` (0
    findings);
16. ABFT on expert stacks and on the analog route, at full width and 2
    layers: moonshot-v1-16b-a3b with ``REL_MOE_FAULT`` in one expert
    stack, ``exact-cuda`` and ``exact-torch`` equal in per-tag violation
    counts and logits, and the golden plans' fallback logits equal; and
    qwen3-4b on ``analog-cuda`` with ``verify="always"``: a prefill and
    4 decode steps with no violation, a stuck plane caught by the plane
    audit;
17. the mesh (after every kernel library is built and the earlier
    phases' plans are freed): two ranks spawned on the one card, over
    gloo (``repro_torch.launch.mesh``), each serving qwen3-4b at full width
    through ``serve_continuous(..., mesh="1,2")`` on phase 14's trace and
    slots: each rank's 36 x 7 projections split 5 by columns (B1 on each
    rank's half of N) and 2 by rows (B2 on each rank's half of K, the
    int32 partials all-reduced before the dequant), 180 B1 and 72 B2
    launches per prefill and per decode step, the trace's token streams
    equal phase 14's bit for bit; prefill ms per request, decode ms per step
    and tokens/s beside single-device and each rank's resident and peak
    memory from that run; then a second, instrumented run of the trace's
    first ``MESH_TRACED`` (1) request for the collectives' time and the
    row split's K-block copies; then, on the same ranks, whisper-medium
    and paligemma-3b at full width and depth through serving's set-up on
    the mesh (both stacks' plans and the cross-attention's placed by leaf
    name, the patch projector whole) and one timed static request of
    phase 12b's (batch 8, prompt 512, stub frames or patches, 16 new
    tokens; no warm-up of its own): tokens equal phase 12b's bit for bit,
    B1 and B2 launches by route as the placed plans give them (whisper
    264 and 120 per prefill, 120 and 72 per decode step; paligemma 90 and
    36 each), no other kernel, prefill and decode times, collectives,
    resident and peak memory, the plans left whole; each split at kernel
    level at qwen3-4b's, whisper's and paligemma's shapes (M = 512 and 8)
    equal to the unsplit plan and B2 to its plain version;
    moonshot-v1-16b-a3b at ``MESH_EXACT_LAYERS`` (1) layer with its 64
    experts split 32 a rank, on ``exact-cuda`` and ``analog-cuda``,
    prefill and decode logits equal the whole plans'; a stamped plan
    directory (qwen3-4b, ``MESH_EXACT_LAYERS`` layer) saved on the mesh and
    restored with ``load_plans(mesh=)``, equal logits; then B2 and B1 at
    the mesh path's shapes, bit for bit and timed as for hymba, and at
    whisper's and paligemma's split shapes bit for bit and timed beside
    their bound;
18. the flash-attention kernels against their plain versions: the
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
19. the training path: gemma3-1b at full width (26 layers, d_model 1152,
    vocab 262144, float32, random weights from seed 0) through
    ``repro_torch.launch.train``, ``attn_backend="cuda"``: the loss,
    gradient norm and every gradient leaf against the ``"jnp"`` route on
    one state (within ``TRAIN_LOSS_REL``, ``TRAIN_GNORM_REL`` and
    ``TRAIN_LEAF_GAP_REL``, with a control that the leaf check sees a lost
    window), then AdamW steps of batch 2 x 2048 tokens (a warm-up and
    ``TRAIN_STEPS`` timed: 26 launches of each flash kernel per step, no
    other kernel), one step with int8 gradient compression, and a profile
    of one step by stage;
20. checkpoint and restart on the card at a reduced gemma3-1b: a run
    resumed from a step-6 checkpoint against the unbroken run;
20b. the encoder-decoder and the VLM prefix trained with
    ``attn_backend="cuda"``, float32, random weights from seed 0:
    paligemma-3b at full width and depth (batch 2 x 512 text tokens after
    its 256-patch prefix: the flash kernels' prefix-LM branch) and
    whisper-medium at full width on ``WHISPER_TRAIN_LAYERS`` (2) layers
    of each stack (batch 2 x 1024 tokens and 1024 frames: the encoder's
    non-causal branch, the decoder's causal one): the loss and gradient
    norm against the ``"jnp"`` route on one state within
    ``TRAIN_LOSS_REL`` / ``TRAIN_GNORM_REL``, every gradient leaf within
    ``FAMILY_LEAF_GAP_REL``, the flash launches by pass and mask branch
    (``flash_attention.BRANCH_LAUNCHES``), then a warm-up and
    ``TRAIN_STEPS`` timed AdamW steps with their launches, step time,
    tokens/s and peak memory; the "cuda" route's numbers are phase 21's
    references for the two families;
21. sharded training (after the single-device references, freed): two
    ranks spawned on the one card over gloo, each training gemma3-1b at
    full width on a 1x2 mesh at ``TRAIN_MESH_GEMMA_LAYERS`` (6) of its 26
    layers (``make_train_step(..., mesh=)``: each rank's 2 query heads on
    the 1 KV head, the FFN hidden and the vocab split) and at 2 layers on
    a 2x1 data-parallel mesh, then on the 1x2 mesh paligemma-3b at full
    width and depth (4 query heads a rank on its 1 KV head, the patch
    projector split) and whisper-medium at 2 + 2 layers (8 heads a rank
    on 8 KV heads, the encoder and the cross-attention split), held to
    phase 20b's steps: the sharded loss and gradient norm on one state
    within ``TRAIN_LOSS_REL`` / ``TRAIN_GNORM_REL`` of the single-device
    ones, the gathered gradient's largest leaf gap within
    ``TRAIN_LEAF_GAP_REL`` (with the control that the check sees a lost
    half-block; the families' stacked leaves at their first and last
    layer), a warm-up and ``TRAIN_STEPS`` steps held likewise step by
    step, the parameters after them within ``TRAIN_PARAM_ATOL``, the
    replicated leaves equal across the ranks, each flash kernel once per
    attention layer, rank and step (the families' also by mask branch) at
    the rank's query and KV heads; per rank the step time, the
    collectives per step by kind and their share of a synced step, peak
    and resident memory;
22. the front doors: the four examples of ``examples/torch/`` that serve
    (``quickstart``, ``cnn_pim_inference``, ``serve_pim_lm``,
    ``continuous_serving``), each in-process at its own default sizes on
    the card, with each one's B1, B3 and B4 launches and wall time
    (quickstart and the CNN example reach B3 and B4 through
    ``analog-cuda``); ``train_lm`` at its real-hardware size (12 layers,
    d_model 768, batch 32 x 1024, ``attn_backend="cuda"``) for 50 steps,
    which writes its step-50 checkpoint, then for 60 from the same
    directory: it must resume from step 50, and its first loss must equal
    (within ``FRONT_RESUME_REL``) the step-50 checkpoint's loss on the
    data's step-50 batch, with each run's B5 launches; and the dry-run
    (``repro_torch.launch.dryrun``), which ran in a process of its own
    beside the other phases, on the CPU only (no card visible to it):
    every config of ``DRYRUN_ARCHS`` x each applicable shape on the 16x16
    ``pod`` mesh ``ok`` or ``skipped``, never ``FAILED``, and the
    ``train_4k`` cell of paligemma-3b on the ``1,2`` mesh, whose per-rank
    float32 state bytes must equal, as integers, the real local state of
    each rank of phase 21's paligemma-3b run.

Each path's launch counts are set to 0 just before its requests and read
just after (B1's also by route, held to what the route chooser gives the
path's shapes). The fused activation quantizer's launches are counted
with them and held equal to the path's quantize calls on the card (every
call takes the kernel); each shape a path quantizes is checked bit for bit
against the eager path on the path's own rows and timed beside its bytes
bound, an ``act_quant`` entry per path (the mesh's ranks count it only).
It prints a ``{"kernels": [...]}`` line (one entry per
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
L2_BYTES = 50 * 2 ** 20          # H100 SXM L2 cache
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
QUANT_SOURCE = "src/repro_torch/csrc/act_quant.cu"
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
    # XLA fuses the JAX package's quantizer; eager PyTorch cannot
    "act_quant": "no TPU kernel: XLA fused it "
                 "(src/repro/core/pim.py _quantize_activations)",
}
# The fused activation quantizer's counts: its launches, and the calls of
# pim._quantize_activations on rows on the card (QuantCalls), which
# read_counts holds equal; the launch checks of the other kernels leave
# both out. Each shape a path quantizes is checked and timed on the first
# QUANT_SAMPLE_ROWS rows the path gave it, tiled to the shape's M.
QUANT_COUNTS = ("act_quant", "quantize_calls")
QUANT_SAMPLE_ROWS = 256
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
# The LM paths: static serving of batch 8, prompt 512, 16 new tokens; a
# warm-up, then LM_REQUESTS timed requests (3 until whisper-medium and
# paligemma-3b were served too: each path's requests are host-bound)
LM_BATCH, LM_PROMPT, LM_GEN, LM_REQUESTS = 8, 512, 16, 2
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
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 2
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
    (the ctypes wrappers take tens of microseconds a call) does not show.
    The spin lasts several times a first pass's host time; where the
    enqueue still outran it (the host slowed), the timing is repeated
    behind a spin four times longer, and raises after the third try."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for factor in (4, 16, 64):
        torch.cuda._sleep(int((factor * host_s + 5e-3) * 2e9))  # ~2 GHz
        start.record()
        for i in range(reps):
            fn(i)
        end.record()
        outran = start.query()
        end.synchronize()
        if not outran:
            return start.elapsed_time(end) / reps
    raise AssertionError("the calls' enqueue outran the spin kernel")


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
    """Launches since the last reset by kernel; where the fused quantizer
    is counted, its launches must equal the quantize calls on the card:
    every call took the kernel (it has no eager route there)."""
    counts = {}
    for mod in kernel_modules:
        counts.update(mod.LAUNCHES)
    if counts.get("act_quant", 0) != counts.get("quantize_calls", 0):
        raise AssertionError(
            f"{counts.get('quantize_calls', 0)} quantize calls on the card "
            f"but {counts.get('act_quant', 0)} act_quant launches")
    return counts


def other_kernels(launches, *names):
    """Launches of kernels other than ``names`` and the quantizer."""
    return {k: v for k, v in launches.items()
            if v and k not in names and k not in QUANT_COUNTS}


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
    the cold time; the wrapper's enqueue time per call stays beside it.
    ``int_ms`` is the int32 entry point's (B2's) cold device time."""
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
    row["int_ms"] = device_ms(
        torch, lambda i: kern.pim_matmul_cuda(a, ws[i % len(ws)]))


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
# The fused activation quantizer (act_quant) on every main path
# ---------------------------------------------------------------------------
class QuantCalls:
    """The calls of ``pim._quantize_activations`` on rows on the card since
    the last reset, counted as a kernel module counts its launches (each
    must be one act_quant launch: :func:`read_counts`). Installed over the
    module attribute, which every caller goes through. It also keeps, per
    (M, K, width, bits, dtype) since the last :meth:`take`, the calls and
    the first ``QUANT_SAMPLE_ROWS`` rows of the first call."""

    def __init__(self, pim):
        self.LAUNCHES = {"quantize_calls": 0}
        self.seen = {}
        self.inner = pim._quantize_activations
        pim._quantize_activations = self

    def reset_launches(self):
        self.LAUNCHES["quantize_calls"] = 0

    def __call__(self, x2, cfg, width=None):
        if x2.is_cuda and x2.shape[0]:
            self.LAUNCHES["quantize_calls"] += 1
            key = (*x2.shape, width, cfg.act_bits, x2.dtype)
            if key not in self.seen:
                self.seen[key] = [x2[:QUANT_SAMPLE_ROWS].clone(), 0]
            self.seen[key][1] += 1
        return self.inner(x2, cfg, width)

    def take(self):
        """The shapes seen since the last take, and a fresh start."""
        seen, self.seen = self.seen, {}
        return seen


def quant_bound(m, k, width, bits, dtype_bytes):
    """Least time (ms) of one quantize call: the rows read once, each
    plane written once at the padded width, the codes once more for two
    planes, a float32 scale a row."""
    pa = 1 if bits <= 4 else 2
    moved = m * k * dtype_bytes + pa * m * (width or k) + \
        (m * k if pa == 2 else 0) + 4 * m
    return moved / HBM_BYTES_PER_S * 1e3


def quant_rows(torch, qkern, pim, seen, what):
    """Per shape a path quantized: the kernel against the eager path
    (``pim._quantize_plain`` and the padding) on the card, bit for bit, on
    the path's sampled rows tiled to the shape's M; the kernel's device
    time, the eager path's, and the bytes bound."""
    import torch.nn.functional as F
    rows = []
    for (m, k, width, bits, dtype), (sample, calls) in seen.items():
        x = sample.repeat(-(-m // sample.shape[0]), 1)[:m].contiguous()

        def plain():
            a_q, planes = pim._quantize_plain(x, bits)
            if width is not None:
                planes = F.pad(planes, (0, width - k))
            return a_q.values, a_q.scale, planes

        got, want = qkern.act_quant_cuda(x, bits, width), plain()
        err = max(max_err(torch, g, w) for g, w in zip(got, want))
        row = {"m": m, "k": k, "width": width, "bits": bits,
               "dtype": str(dtype).split(".")[-1], "calls": calls,
               "max_abs_err": err,
               "ms": device_ms(torch, lambda i: qkern.act_quant_cuda(
                   x, bits, width)),
               "plain_ms": time_ms(torch, plain),
               "bound_ms": quant_bound(m, k, width, bits,
                                       x.element_size())}
        rows.append(row)
        del x
    rows.sort(key=lambda r: -r["calls"] * r["ms"])
    total = lambda key: sum(r[key] * r["calls"] for r in rows)
    log(f"act_quant on {what}: {len(rows)} shapes, "
        f"{sum(r['calls'] for r in rows)} calls, bit-identical to the "
        f"eager path; over the calls {total('ms'):.3f} ms (eager "
        f"{total('plain_ms'):.3f} ms, bytes bound {total('bound_ms'):.3f} "
        "ms); by shape " + ", ".join(
            f"{r['m']}x{r['k']}->{r['width'] or r['k']} {r['bits']}b "
            f"{r['dtype']} x{r['calls']} {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f}, eager {r['plain_ms']:.4f})"
            for r in rows[:8]))
    return rows


def quant_entry(rows, launches, path):
    """The quantizer's line for one path: its launches in the path's own
    counted run, and times summed over every quantize call the path made
    (its counted runs, warm-ups and checks)."""
    total = lambda key: sum(r[key] * r["calls"] for r in rows)
    return {
        "name": "act_quant", "path": path, "route": "cuda",
        "source": QUANT_SOURCE, "replaces": REPLACES["act_quant"],
        "launches": launches["act_quant"],
        "calls": sum(r["calls"] for r in rows),
        "max_abs_err": max((r["max_abs_err"] for r in rows), default=0.0),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"), "bound_by": "bytes",
        "library_ms": None,
        "per": ("every quantize call of the path (counted runs, warm-ups "
                "and checks), device time per shape on the path's rows "
                "tiled to its M; plain_ms is the eager path it replaced "
                "(quantize, nibble planes, pad) on the same rows; bound_ms "
                "reads each row once and writes each plane at the padded "
                "width (and the codes for two planes) once; library_ms is "
                "null: no single PyTorch call quantizes rows"),
    }


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


def lm_serve_requests(torch, serve_mod, params, cfg, tokens, counters,
                      inputs=None):
    """A warm-up, then LM_REQUESTS requests through the static serving
    loop (``inputs``: the request's stub patches or frames), launch counts
    set to 0 just before and read just after; per-request prefill and
    decode times (CUDA events)."""
    serve_mod.static_loop(params, cfg, tokens, LM_GEN, inputs=inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters)
    outs = [serve_mod.static_loop(params, cfg, tokens, LM_GEN, inputs=inputs)
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


def phase_counts(torch, lm, params, cfg, tokens, counters, inputs=None):
    """Launch counts of one prefill and of one decode step alone (a VLM's
    prefix takes the cache positions before the prompt's)."""
    start = LM_PROMPT + (cfg.vision_tokens if inputs and "patches" in inputs
                         else 0)
    reset_counts(*counters)
    logits, cache = lm.prefill(params, cfg, dict(inputs or {}, tokens=tokens),
                               start + LM_GEN)
    torch.cuda.synchronize()
    pre = read_counts(*counters)
    reset_counts(*counters)
    lm.decode_step(params, cfg, cache, logits.argmax(-1)[:, None], start)
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
    if any(got[k] != v for k, v in want.items()) or \
            other_kernels(got, *want):
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
# the served request's depth (of 48): each layer is identical in shape, so
# B1's per-launch rows and the launches per layer do not depend on it; the
# cut keeps the run within its time limit beside the mesh and the
# sharded-training phases (12 until the latter came; the 48-layer fit,
# 60.4 GB resident, is in PERF.md)
MOE_SERVE_LAYERS = 6
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


def exact_steps(torch, lm, planned, cfg, batch, start, what):
    """``planned`` (on exact-cuda) against the same plans re-stamped to
    exact-torch: the prefill logits and LM_GEN decode steps' logits (at
    positions ``start`` on), bit for bit, on the tokens the kernel route
    generates. Returns the seconds both routes took."""
    plain = with_substrate(planned, "exact-torch")
    t0 = time.perf_counter()
    logits, cache = lm.prefill(planned, cfg, batch, start + LM_GEN)
    want, ref_cache = lm.prefill(plain, cfg, batch, start + LM_GEN)
    if not torch.equal(logits, want):
        raise AssertionError(f"{what} exact-cuda prefill logits differ "
                             "from exact-torch")
    tok = logits.argmax(-1)[:, None]
    for g in range(LM_GEN):
        logits, cache = lm.decode_step(planned, cfg, cache, tok, start + g)
        want, ref_cache = lm.decode_step(plain, cfg, ref_cache, tok,
                                         start + g)
        if not torch.equal(logits, want):
            raise AssertionError(f"{what} decode step {g}: exact-cuda "
                                 "logits differ from exact-torch")
        tok = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        raise AssertionError(f"{what} logits not finite")
    return time.perf_counter() - t0


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
    seconds = exact_steps(torch, lm, planned, short, {"tokens": tokens},
                          LM_PROMPT, "moonshot")
    del planned
    torch.cuda.empty_cache()
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
    """One whole request profiled on the device alone (after a warm-up):
    :func:`request_idle_share`'s numbers and B1's device time and
    launches by route."""
    run()
    torch.cuda.synchronize()
    result, device = request_idle_share(torch, run)
    b1 = {label: [e.time_range.elapsed_us() for e in device
                  if fragment in e.name]
          for label, fragment in MOE_KERNELS.items()}
    result.update({"b1_ms": {k: sum(v) / 1e3 for k, v in b1.items()},
                   "b1_kernels": {k: len(v) for k, v in b1.items()}})
    log(f"device-only profile of one moonshot request: busy "
        f"{result['device_busy_ms']:.3f} ms of a {result['window_ms']:.3f} "
        "ms window (first to last device activity), idle share "
        f"{result['device_idle_share']:.4f}, {len(device)} device events; "
        "B1 " + ", ".join(f"{k} {result['b1_ms'][k]:.3f} ms over "
                          f"{result['b1_kernels'][k]} kernels" for k in b1))
    return result


def request_idle_share(torch, run):
    """One whole request profiled on the device alone: busy time and the
    idle share over the window from its first device activity to its
    last; returns them and the device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device = device_events(torch, prof)
    busy, window = busy_and_window(device, device)
    return {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / window,
            "device_events": len(device)}, device


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
    others = other_kernels(read_counts(*counters), "pim_matmul_fused")
    reset_counts(*counters)
    lm.decode_step(planned, cfg, cache, logits.argmax(-1)[:, None],
                   LM_PROMPT)
    torch.cuda.synchronize()
    out["decode_step"] = route_counts(kern, "pim_matmul_fused")
    others.update(other_kernels(read_counts(*counters),
                                "pim_matmul_fused"))
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
    """(e) moonshot-v1-16b-a3b at full width (d_model 2048, 64 experts
    top-6 of d_ff 1408, 2 shared experts, vocab 163840), random weights
    from seed 0: exact-cuda against exact-torch at 2 layers, then serving's
    programming (each layer programmed at w4a4 on exact-cuda as it is
    drawn) of MOE_SERVE_LAYERS of its 48 layers and the static loop at
    batch 8, prompt 512, 16 new tokens: launches by route, times, memory,
    a profile by stage."""
    import dataclasses
    serve_mod, kern = mods["serve"], mods["pim_kern"]
    cfg = dataclasses.replace(mods["configs"].get_config(MOONSHOT),
                              num_layers=MOE_SERVE_LAYERS)
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
    substrate = "exact-cuda"
    planned = serve_mod._program(cfg, mods["pim"].PimConfig(
        weight_bits=4, act_bits=4, substrate=substrate), dev)
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
    if any(got[k] != v for k, v in want.items()) or \
            other_kernels(got, *want):
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
# The encoder-decoder and the VLM prefix: whisper-medium and paligemma-3b
# ---------------------------------------------------------------------------
FAMILIES = ("whisper-medium", "paligemma-3b")
# exact-cuda against exact-torch at full width on this many layers of each
# stack (the plain substrate's products at full depth cost more than the
# served requests)
FAMILY_EXACT_LAYERS = 2
# whisper-medium trains at full width on this many layers of each stack
# (depth changes no kernel shape); paligemma-3b at full depth
WHISPER_TRAIN_LAYERS = 2
WHISPER_TRAIN_SEQ = 1024   # decoder tokens; the stub frames are as long
# a gradient leaf of the "cuda" route within this share of the "jnp"
# route's largest entry of that leaf (the flash backward's bound,
# FLASH_BWD_REL: float32 sums in another order through the recomputed
# probabilities)
FAMILY_LEAF_GAP_REL = 1e-3


def family_b1_launches(cfg):
    """B1 launches of one prefill and of one decode step: per decoder
    layer q, k, v, o and the MLP's (up, down; gate too when gated); an
    encoder's layers the same in prefill only; a decoder's
    cross-attention q, k, v, o in prefill and q, o in a decode step (its
    K/V are cached)."""
    layer = 4 + (3 if cfg.gated_mlp else 2)
    prefill = (cfg.encoder_layers + cfg.num_layers) * layer
    step = cfg.num_layers * layer
    if cfg.encoder_layers:
        prefill += cfg.num_layers * 4
        step += cfg.num_layers * 2
    return prefill, step


def family_cfg(mods, arch, layers=None):
    """``arch``'s config, with ``layers`` layers in each stack if given."""
    import dataclasses
    cfg = mods["configs"].get_config(arch)
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, num_layers=layers,
                               encoder_layers=min(cfg.encoder_layers, layers))


def family_exactness(torch, dev, mods, cfg, smi):
    """exact-cuda against exact-torch at full width and FAMILY_EXACT_LAYERS
    layers of each stack (:func:`exact_steps`), the request's stub frames
    or patches included."""
    serve_mod = mods["serve"]
    short = family_cfg(mods, cfg.name, FAMILY_EXACT_LAYERS)
    planned = serve_mod._program(short, mods["pim"].PimConfig(
        weight_bits=4, act_bits=4, substrate="exact-cuda"), dev)
    tokens, inputs = serve_mod.request_inputs(short, LM_BATCH, LM_PROMPT, dev)
    seconds = exact_steps(torch, mods["lm"], planned, short,
                          dict(inputs, tokens=tokens),
                          LM_PROMPT + short.vision_tokens, cfg.name)
    del planned
    torch.cuda.empty_cache()
    log(f"{cfg.name} at full width and {FAMILY_EXACT_LAYERS} layers of each "
        f"stack: prefill logits and all {LM_GEN} decode steps' logits on "
        f"exact-cuda bit-identical to exact-torch ({seconds:.1f} s for both "
        f"routes) [{smi}]")
    return {"layers": FAMILY_EXACT_LAYERS, "decode_steps": LM_GEN,
            "bit_identical": True, "seconds": seconds}


def family_serve_path(torch, dev, mods, counters, arch, smi):
    """``arch`` at full width and depth, random weights from seed 0:
    exact-cuda against exact-torch at FAMILY_EXACT_LAYERS, then serving's
    set-up (each layer of both stacks programmed at w4a4 on exact-cuda as
    it is drawn) and the static loop at batch 8, prompt 512 (whisper: 512
    stub frames; paligemma: 256 stub patches before the prompt), 16 new
    tokens: B1 launches per prefill and per decode step, no other kernel,
    times, tokens/s, peak memory and the device's idle share."""
    serve_mod, lm = mods["serve"], mods["lm"]
    cfg = family_cfg(mods, arch)
    out = {"config": {"arch": arch, "layers": cfg.num_layers,
                      "encoder_layers": cfg.encoder_layers,
                      "d_model": cfg.d_model, "heads": cfg.num_heads,
                      "kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff,
                      "vocab": cfg.vocab_size,
                      "vision_tokens": cfg.vision_tokens,
                      "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
                      "bits": "w4a4"}, "card": smi}
    out["exactness"] = family_exactness(torch, dev, mods, cfg, smi)

    t0 = time.perf_counter()
    planned = serve_mod._program(cfg, mods["pim"].PimConfig(
        weight_bits=4, act_bits=4, substrate="exact-cuda"), dev)
    torch.cuda.synchronize()
    out["program_s"] = time.perf_counter() - t0
    out["resident_bytes"] = torch.cuda.memory_allocated()
    tokens, inputs = serve_mod.request_inputs(cfg, LM_BATCH, LM_PROMPT, dev)
    first, numbers = lm_serve_requests(torch, serve_mod, planned, cfg, tokens,
                                       counters, inputs)
    out.update(numbers)
    out["tokens"] = first[0].cpu().tolist()     # the mesh phase's reference
    pre, step = family_b1_launches(cfg)
    want = {"pim_matmul_fused": (pre + LM_GEN * step) * LM_REQUESTS}
    got = numbers["launches"]
    if any(got[k] != v for k, v in want.items()) or \
            other_kernels(got, *want):
        raise AssertionError(f"{arch} launches {got}, expected {want} and "
                             "no other kernel")
    got_pre, got_step = phase_counts(torch, lm, planned, cfg, tokens,
                                     counters, inputs)
    if got_pre["pim_matmul_fused"] != pre or \
            got_step["pim_matmul_fused"] != step or \
            other_kernels(got_pre, "pim_matmul_fused") or \
            other_kernels(got_step, "pim_matmul_fused"):
        raise AssertionError(f"{arch} launches per prefill {got_pre}, per "
                             f"decode step {got_step}; expected {pre} and "
                             f"{step} pim_matmul_fused, no other kernel")
    out["b1_per_prefill"], out["b1_per_decode_step"] = pre, step
    out["profile"], _ = request_idle_share(
        torch, lambda: serve_mod.static_loop(planned, cfg, tokens, LM_GEN,
                                             inputs=inputs))
    log(f"{arch} served at full width ({cfg.encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}; batch {LM_BATCH}, prompt {LM_PROMPT}"
        + (f" + {cfg.vision_tokens} patches" if cfg.vision_tokens else "")
        + (f", {LM_PROMPT} frames" if cfg.encoder_layers else "")
        + f", {LM_GEN} new tokens, w4a4 on exact-cuda): B1 {pre} launches "
        f"per prefill and {step} per decode step, no other kernel; prefill "
        f"{', '.join(f'{t:.3f}' for t in out['prefill_ms'])} ms, decode "
        f"{', '.join(f'{t:.3f}' for t in out['decode_ms_per_token'])} "
        f"ms/token, {out['tokens_per_s']:.2f} tokens/s, set-up "
        f"{out['program_s']:.1f} s, resident "
        f"{out['resident_bytes'] / 2 ** 30:.3f} GiB, peak "
        f"{out['peak_bytes'] / 2 ** 30:.3f} GiB; one request on the device: "
        f"busy {out['profile']['device_busy_ms']:.3f} ms of "
        f"{out['profile']['window_ms']:.3f} ms, idle share "
        f"{out['profile']['device_idle_share']:.4f} [{smi}]")
    del planned
    torch.cuda.empty_cache()
    return out


def family_train_cfg(mods, arch):
    """The family's training config: attn_backend "cuda", whisper-medium
    at WHISPER_TRAIN_LAYERS layers of each stack, paligemma-3b whole."""
    import dataclasses
    whisper = arch == "whisper-medium"
    return dataclasses.replace(
        family_cfg(mods, arch, WHISPER_TRAIN_LAYERS if whisper else None),
        attn_backend="cuda")


def family_train_seq(cfg):
    return WHISPER_TRAIN_SEQ if cfg.encoder_layers else LM_PROMPT


def family_flash_launches(cfg):
    """Flash launches per training step of a family: each masked kernel
    once per attention layer (an encoder's non-causal, a decoder's causal
    or, after a VLM prefix, prefix-LM), the head sum once per decoder
    layer where query heads share a KV head; and the same by (kernel,
    mask branch)."""
    n = cfg.num_layers
    per_pass = {"non_causal": cfg.encoder_layers, "causal": n} \
        if cfg.encoder_layers else {"prefix_lm": n}
    masked = ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv")
    want = dict.fromkeys(masked, n + cfg.encoder_layers)
    want["flash_attention_bwd_sum"] = \
        n if cfg.num_heads > cfg.num_kv_heads else 0
    return want, {(p, b): c for p in masked for b, c in per_pass.items()}


def leaf_ends(tree_mod, tree, ends=True):
    """Leaf name -> the leaf on the host; with ``ends``, a stacked leaf's
    first and last layer only (what a mesh run's gathered leaves are held
    to where the whole tree would cost too much)."""
    return {"/".join(path): (t[[0, -1]] if ends and path[0] in STACKS
                             else t).detach().cpu()
            for path, t in tree_mod.flatten_with_path(tree)}


def family_train_path(torch, dev, mods, counters, arch, smi, ref_dir):
    """``arch`` trained with attn_backend="cuda", float32 parameters from
    seed 0: paligemma-3b at full width and depth (batch 2 x 512 text
    tokens after its 256-patch prefix: B5's prefix-LM branch),
    whisper-medium at full width on WHISPER_TRAIN_LAYERS layers of each
    stack (batch 2 x WHISPER_TRAIN_SEQ tokens and as many frames: the
    encoder's non-causal branch, the decoder's causal one). The loss and
    gradient norm against the "jnp" route on one state (TRAIN_LOSS_REL,
    TRAIN_GNORM_REL), every gradient leaf within FAMILY_LEAF_GAP_REL, the
    flash launches by pass and mask branch; then AdamW steps (a warm-up
    and TRAIN_STEPS timed). The "cuda" route's
    loss, gradient norm, gradient and steps are the sharded-training
    phase's reference (``out["reference"]``; the gradient's and the last
    parameters' :func:`leaf_ends` saved under ``ref_dir``)."""
    import dataclasses
    from repro_torch.optim.adamw import AdamWConfig, global_norm
    train, lm, fkern = mods["train"], mods["lm"], mods["flash_kern"]
    cfg = family_train_cfg(mods, arch)
    seq = family_train_seq(cfg)
    batches = train_batches(mods, cfg, seq, dev, TRAIN_STEPS + 2)
    out = {"config": {"arch": arch, "layers": cfg.num_layers,
                      "encoder_layers": cfg.encoder_layers,
                      "d_model": cfg.d_model, "vocab": cfg.vocab_size,
                      "batch": TRAIN_BATCH, "seq": seq,
                      "prefix": cfg.vision_tokens}, "card": smi}
    params = lm.init_lm(cfg, 0, device=dev)
    leaves = mods["tree"].leaves
    out["parameters"] = sum(p.numel() for p in leaves(params))
    loss_j, _, grads_j = train.loss_and_grads(
        params, dataclasses.replace(cfg, attn_backend="jnp"), batches[0])
    reset_counts(*counters)
    loss_c, _, grads = train.loss_and_grads(params, cfg, batches[0])
    torch.cuda.synchronize()
    once = read_counts(*counters)
    branches = dict(fkern.BRANCH_LAUNCHES)
    gnorm_j, gnorm_c = global_norm(grads_j).item(), global_norm(grads).item()
    leaf_gap = max((g - gj).abs().max().item()
                   / max(gj.abs().max().item(), 1e-30)
                   for g, gj in zip(leaves(grads), leaves(grads_j)))
    loss_j, loss_c = loss_j.item(), loss_c.item()
    reference = {"loss": loss_c, "grad_norm": gnorm_c,
                 "grads": str(ref_dir / f"grads_{arch}.pt"),
                 "params": str(ref_dir / f"params_{arch}.pt"),
                 "ends": True}
    torch.save(leaf_ends(mods["tree"], grads), reference["grads"])
    del params, grads, grads_j
    torch.cuda.empty_cache()
    n = cfg.num_layers
    want, want_branches = family_flash_launches(cfg)
    out["cuda_vs_jnp"] = {"loss_cuda": loss_c, "loss_jnp": loss_j,
                          "grad_norm_cuda": gnorm_c, "grad_norm_jnp": gnorm_j,
                          "max_leaf_grad_gap_rel": leaf_gap,
                          "launches": once,
                          "launches_by_branch": {
                              f"{p}/{b}": c for (p, b), c in
                              sorted(branches.items())}}
    log(f"{arch} training, one state ({out['parameters']} float32 "
        f"parameters, {cfg.encoder_layers} encoder + {n} decoder layers, "
        f"batch {TRAIN_BATCH} x {seq}"
        + (f" after {cfg.vision_tokens} patches" if cfg.vision_tokens
           else f" and {seq} frames")
        + f"): loss cuda {loss_c:.7f} vs jnp {loss_j:.7f} (rel "
        f"{abs(loss_c - loss_j) / abs(loss_j):.3g}), gradient norm cuda "
        f"{gnorm_c:.7g} vs jnp {gnorm_j:.7g} (rel "
        f"{abs(gnorm_c - gnorm_j) / gnorm_j:.3g}), largest per-leaf "
        f"gradient gap {leaf_gap:.3g} (limit {FAMILY_LEAF_GAP_REL}); flash "
        f"launches {once}, by branch "
        f"{out['cuda_vs_jnp']['launches_by_branch']} [{smi}]")
    if abs(loss_c - loss_j) > TRAIN_LOSS_REL * abs(loss_j) or \
            abs(gnorm_c - gnorm_j) > TRAIN_GNORM_REL * gnorm_j or \
            leaf_gap > FAMILY_LEAF_GAP_REL or branches != want_branches or \
            any(once[k] != v for k, v in want.items()) or \
            not math.isfinite(loss_c):
        raise AssertionError(f"{arch}: the cuda route differs from jnp or "
                             f"launched other kernels: {out}; expected "
                             f"{want}, by branch {want_branches}")

    state = train.init_state(cfg, 0, device=dev)
    step_fn = train.make_train_step(cfg, AdamWConfig(**TRAIN_OPT))
    state, metrics = step_fn(state, batches[0])           # warm-up
    reference["steps"] = [[metrics["loss"].item(),
                           metrics["grad_norm"].item()]]
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
        reference["steps"].append([losses[-1], metrics["grad_norm"].item()])
    launches = read_counts(*counters)
    if any(launches[k] != v * TRAIN_STEPS for k, v in want.items()) or any(
            launches[k] for k in launches if k not in want) or \
            not all(map(math.isfinite, losses)):
        raise AssertionError(f"{arch} training launches {launches} "
                             f"(expected {want} per step and no other "
                             f"kernel), losses {losses}")
    med = statistics.median(step_ms)
    out.update({"step_ms": step_ms, "step_ms_median": med,
                "tokens_per_s": TRAIN_BATCH * seq / (med / 1e3),
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "losses": losses, "launches": launches,
                "launches_per_step": want})
    log(f"{arch} training (AdamW, attn cuda): step "
        + ", ".join(f"{t:.3f}" for t in step_ms)
        + f" ms, {out['tokens_per_s']:.1f} text tokens/s, peak device "
        f"memory {out['peak_bytes'] / 2 ** 30:.3f} GiB, losses "
        + ", ".join(f"{x:.5f}" for x in losses)
        + f"; flash launches per step {want} [{smi}]")
    torch.save(leaf_ends(mods["tree"], state["params"]),
               reference["params"])
    out["reference"] = reference
    del state, batches
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Plan persistence and continuous batching: qwen3-4b at full width
# ---------------------------------------------------------------------------
QWEN3 = "qwen3-4b"
# the continuous path: slots, a Poisson trace (prompts 128-512, 4-16 new
# tokens: serve_continuous's quarter-to-full ranges) and its variants
# (4 requests since the front-doors phase came, 6 since whisper-medium
# and paligemma-3b were served too, 8 since the sharded-training phase
# came, 32 before: the continuous, ABFT and mesh runs each serve the whole
# trace, host-bound)
CONT_SLOTS, CONT_REQUESTS, CONT_RATE = 8, 4, 0.5
CONT_CHUNK, CONT_PREFIX_CACHE, CONT_SHARED_PREFIX = 64, 16, 128
CONT_WINDOW = 4            # sync_every of the fused-window variant
CONT_VARIANT_REQUESTS = 4  # the trace's first requests, for variants
CONT_STATIC_CHECKS = 2     # requests held to their static streams (4
#                            before the sanitize phase was added)
CONT_EXACT_LAYERS = 2      # exact-cuda against exact-torch at this depth
SAN_REQUESTS = 4           # the trace's first requests, served armed
# the serve CLI's sanitized run on a reduced qwen3 (with the kernel
# build directory this run filled as its compile cache)
SAN_CLI = ("--arch", QWEN3, "--layers", "2", "--d-model", "64", "--pim",
           "--continuous", "--num-slots", "4", "--requests", "8",
           "--prompt-len", "16", "--gen", "4", "--sync-every", "2",
           "--prefill-chunk", "8", "--sanitize")
SYNC_WARNING = "called a synchronizing CUDA operation"


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
    if launches["pim_matmul_fused"] != want or \
            other_kernels(launches, "pim_matmul_fused"):
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


def qwen3_phases(torch, dev, mods, counters, smi):
    """(f) and (g) over one fresh plan directory, deleted afterwards, then
    (h) and the sanitizers on (g)'s restored plans."""
    plan_dir = tempfile.mkdtemp(prefix="qwen3_plans_")
    try:
        program, logits, generated, cfg = qwen3_program_phase(
            torch, dev, mods, counters, plan_dir)
        cont, params, base = qwen3_continuous_phase(
            torch, dev, mods, counters, plan_dir, cfg, (logits, generated))
    finally:
        shutil.rmtree(plan_dir, ignore_errors=True)
    rel = qwen3_reliability_phase(torch, dev, mods, counters, cfg, params,
                                  base, cont, smi)
    san = sanitize_phase(torch, mods, counters, cfg, params, base, smi)
    del params
    torch.cuda.empty_cache()
    return program, cont, rel, san


def sync_census(torch, serving, params, cfg, reqs, **geometry):
    """Serve ``reqs`` once with CUDA's sync debug mode at "warn" and count
    the synchronizing calls it reports (as the reliability tests' ``_syncs``
    does): per ``generate`` call (the whole decode dispatch, with its
    placement of the step inputs and its one copy of the results) and per
    decode step call inside it (``_decode_fn`` / ``_window_fn``, the
    window a sanitizer guards), with the source line of each of the
    latter. Uses only ``ContinuousScheduler`` and the engine's
    ``generate`` / ``_decode_fn`` / ``_window_fn``, so it runs on an older
    checkout of the port too. Returns the counts and the streams."""
    import warnings
    Engine = serving.ServingEngine
    sched = serving.ContinuousScheduler(params, cfg, **geometry)
    sched.warmup()
    spans = {"generate": [], "step": []}
    caught = []

    def spanned(key, fn):
        def wrapper(*args, **kwargs):
            start = len(caught)
            try:
                return fn(*args, **kwargs)
            finally:
                spans[key].append((start, len(caught)))
        return wrapper

    with warnings.catch_warnings(record=True) as caught, patched(
            (Engine, "generate", spanned("generate", Engine.generate)),
            (Engine, "_decode_fn", spanned("step", Engine._decode_fn)),
            (Engine, "_window_fn", spanned("step", Engine._window_fn))):
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run = sched.run(reqs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    is_sync = [SYNC_WARNING in str(w.message) for w in caught]

    def count(key):
        return sum(sum(is_sync[a:b]) for a, b in spans[key])

    sites = Counter()
    for a, b in spans["step"]:
        for w, s in zip(caught[a:b], is_sync[a:b]):
            if s:
                path = Path(w.filename)
                parts = path.parts
                name = "/".join(parts[parts.index("src") + 1:]) \
                    if "src" in parts else path.name
                sites[f"{name}:{w.lineno}"] += 1
    calls = {k: len(v) for k, v in spans.items()}
    return {"generate_calls": calls["generate"],
            "step_calls": calls["step"],
            "syncs_per_generate": count("generate") / max(1,
                                                         calls["generate"]),
            "syncs_per_step": count("step") / max(1, calls["step"]),
            "step_sites": dict(sites), "streams": streams(run.completions),
            "decode_steps": run.metrics["decode_steps"]}


def start_serve_cli(args, out_json):
    """``python -m repro_torch.launch.serve`` in a subprocess (the
    checkout's own ``src``), writing ``--metrics-json`` to ``out_json``."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *args,
         "--metrics-json", str(out_json)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def start_lint():
    """``python -m repro_torch.analysis`` over its defaults
    (``src/repro_torch``, ``examples/torch``) in a subprocess."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--no-ruff"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def finish(job, what, timeout=300):
    out, _ = job.communicate(timeout=timeout)
    if job.returncode != 0:
        raise AssertionError(f"{what} exited {job.returncode}:\n"
                             f"{out[-4000:]}")
    return out


def sanitize_phase(torch, mods, counters, cfg, params, base, smi):
    """(h2) The runtime sanitizers and the lint on the card. qwen3-4b at
    full width on (g)'s restored plans (B1 on exact-cuda), the trace's
    first SAN_REQUESTS requests through 8 slots: the synchronizing calls
    per decode dispatch and per decode step in sync debug mode "warn"
    (:func:`sync_census`), then the same requests unarmed and armed in
    turns, twice each (``Sanitizer``: sync debug mode "error" around every
    decode step, the compile counter over warm-up and run), timed on the
    host clock around ``generate``. The armed streams equal the unarmed
    ones and (g)'s;
    the counter sees prefill, insert and decode once each; no decode step
    synchronizes. Beside it, in subprocesses: the serve CLI's
    ``--continuous --sanitize`` on a reduced qwen3 with
    ``--compile-cache-dir`` at this run's kernel build directory (0
    ``nvcc`` builds, every library loaded from there), and
    ``python -m repro_torch.analysis`` (0 findings)."""
    from repro_torch.analysis.sanitize import Sanitizer
    from repro_torch.kernels import runtime
    serving = mods["serving"]
    Engine = serving.ServingEngine
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="sanitize_"))
    cli_json = tmp / "serve.json"
    cli = start_serve_cli(SAN_CLI + ("--compile-cache-dir",
                                     str(runtime.build_dir())), cli_json)
    lint = start_lint()
    geometry = dict(num_slots=CONT_SLOTS, prompt_pad=LM_PROMPT,
                    max_len=LM_PROMPT + LM_GEN)
    reqs = qwen3_trace(serving, cfg)[:SAN_REQUESTS]
    try:
        census = sync_census(torch, serving, params, cfg, reqs, **geometry)
        cli_log = finish(cli, "serve --continuous --sanitize")
        lint_log = finish(lint, "python -m repro_torch.analysis")
    finally:
        for job in (cli, lint):
            if job.poll() is None:
                job.kill()
                job.wait()
    cli_res = json.loads(cli_json.read_text())
    shutil.rmtree(tmp, ignore_errors=True)

    def serve_once(sanitizer):
        sched = serving.ContinuousScheduler(params, cfg, sanitizer=sanitizer,
                                            **geometry)
        v = {}
        names = ("prefill", "insert", "decode", "decode_window", "nvcc:")
        with patched((Engine, "generate", timed(v, "decode_s",
                                                Engine.generate))), \
                Sanitizer().compile_counter(names) as counter:
            torch.cuda.synchronize()
            reset_counts(*counters)
            sched.warmup()
            run = sched.run(reqs)
            launches = read_counts(*counters)
        return run, v["decode_s"] * 1e3 / run.metrics["decode_steps"], \
            counter, launches

    turns = [serve_once(s) for s in (None, Sanitizer(), None, Sanitizer())]
    plain, armed, counter, launches = (turns[0][0], turns[1][0],
                                       turns[1][2], turns[1][3])
    plain_ms = [t[1] for t in turns[0::2]]
    armed_ms = [t[1] for t in turns[1::2]]
    failures = []
    got, want = streams(armed.completions), streams(plain.completions)
    if got != want or any(streams(t[0].completions) != want
                          for t in turns[2:]):
        failures.append("armed streams differ from the unarmed run's")
    if any(base[k] != want[k] for k in want):
        failures.append("unarmed streams differ from the continuous "
                        "phase's")
    if census["streams"] != want:
        failures.append("the census run's streams differ")
    for t in turns[1::2]:
        try:
            t[2].expect(prefill=1, insert=1, decode=1)
        except AssertionError as e:
            failures.append(str(e))
    m = armed.metrics
    want_b1 = qwen3_launches(cfg) * (m["prefills"] + m["decode_steps"] + 2)
    if launches["pim_matmul_fused"] != want_b1:
        failures.append(f"armed run: B1 launches {launches}, expected "
                        f"{want_b1}")
    if census["syncs_per_step"] != 0:
        failures.append(f"decode steps synchronize: {census['step_sites']}")
    cli_san = cli_res.get("sanitize", {})
    cc = cli_res.get("compile_cache", {})
    nvcc = {k: v for k, v in cli_san.get("compiles", {}).items()
            if k.startswith("nvcc:")}
    libs = cc.get("libraries", {})
    if nvcc or not libs or any(
            Path(p).parent != Path(cc["dir"]) for p in libs.values()):
        failures.append(f"serve --compile-cache-dir: builds {nvcc}, "
                        f"libraries {libs} (dir {cc.get('dir')})")
    if "repro-lint: 0 finding(s)" not in lint_log:
        failures.append(f"lint: {lint_log[-2000:]}")
    seconds = time.perf_counter() - t_phase
    out = {"census": {k: v for k, v in census.items() if k != "streams"},
           "decode_ms_per_step": {"unarmed": plain_ms, "armed": armed_ms,
                                  "order": "unarmed, armed, unarmed, armed"},
           "compiles": dict(counter.counts), "launches": launches,
           "requests": SAN_REQUESTS, "decode_steps": m["decode_steps"],
           "cli": {"args": list(SAN_CLI), "sanitize": cli_san,
                   "compile_cache": cc,
                   "tokens": cli_res.get("generated_tokens")},
           "lint": lint_log.strip().splitlines()[-2:], "card": smi,
           "seconds": seconds, "failures": failures}
    log(f"sanitize ({smi}): qwen3-4b, {SAN_REQUESTS} requests through "
        f"{CONT_SLOTS} slots, {m['decode_steps']} decode steps; sync debug "
        f"mode 'warn': {census['syncs_per_generate']:.2f} synchronizing "
        f"calls per decode dispatch ({census['generate_calls']} dispatches:"
        f" the inputs' placement and the one copy of the results), "
        f"{census['syncs_per_step']:.2f} per decode step call "
        f"{census['step_sites'] or ''}; decode ms per step in turns: "
        f"unarmed {plain_ms[0]:.2f}, armed {armed_ms[0]:.2f}, unarmed "
        f"{plain_ms[1]:.2f}, armed {armed_ms[1]:.2f} ('error' in every "
        f"decode step); "
        f"compiles {dict(counter.counts)}; B1 {launches['pim_matmul_fused']}"
        f" launches; streams armed = unarmed = the continuous phase's: "
        f"{got == want}; serve CLI --sanitize --compile-cache-dir: "
        f"compiles {cli_san.get('compiles')}, libraries {libs}; lint: "
        f"{out['lint'][-1]}; {seconds:.1f} s")
    if failures:
        raise AssertionError("sanitize phase: " + "; ".join(failures))
    return out


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
    load's reader threads), then serves 8 slots with CONT_REQUESTS (4)
    Poisson requests at 0.5 per step (seed 0), prompts 128-512, 4-16 new
    tokens: B1 launches by
    route (whole prefill on the wgmma route, decode at M = 8 on the
    small-M route), tokens/s, TTFT and latency percentiles, prefill ms
    per admitted request, decode ms per step. The restored plans' static
    request (batch 8 x prompt 512, 16 tokens) equals (f)'s bit for bit.
    Then, on the restored plans, the identities: sync_every 4 = 1,
    chunked prefill (64) = whole, a prefix-cache hit = a miss (shared
    prefix 128, chunks of 64), each on the trace's first
    CONT_VARIANT_REQUESTS requests (a request's tokens never depend on
    the others), CONT_STATIC_CHECKS (2) requests' streams = their static
    streams at the slots' shapes, and at 2 layers exact-cuda = exact-torch for the whole
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
            expect.values()) or other_kernels(launches, "pim_matmul_fused"):
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
    del planned
    out["checks"] = checks
    out["failures"] = failures
    out["streams"] = base
    if failures:
        raise AssertionError("qwen3 continuous identities: "
                             + "; ".join(failures))
    return out, params, base


# the reliability phase's faults (serve --inject-faults's format): a
# transient bit-flip pair, a sticky stuck plane with a dark WDM chunk and
# a sticky ADC gain drift, on three of qwen3-4b's layer stacks
REL_FAULTS = (
    {"target": "layers/attn/wq_dh", "seed": 1, "bitflips": 2,
     "sticky": False},
    {"target": "layers/mlp/wo_hd", "seed": 2, "stuck_planes": 1,
     "stuck_value": 15, "dropped_chunks": 1, "sticky": True},
    {"target": "layers/attn/wo_hd", "seed": 3, "adc_gain": 1.1,
     "sticky": True})


REL_WINDOW_REQUESTS = 4   # the trace's first requests, every dispatch replayed


def arm_plans(torch, pim, params, verify):
    """The restored plans programmed once more with ABFT verification:
    each plan's codes (the drawn weights, quantized once) planned again
    by ``pim.plan_from_qtensor`` with ``verify`` on and its layer stack's
    path as tag, as serve's programming stamps them. The planes must come
    out as they were. Returns the tree and the programming seconds."""
    import dataclasses
    from repro_torch.quant.quantize import QTensor
    t0 = time.perf_counter()

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + [k]) for k, v in tree.items()}
        if isinstance(tree, list):
            tag = "/".join(keys)
            out = []
            for p in tree:
                armed = pim.plan_from_qtensor(
                    QTensor(values=p.values, scale=p.scale, bits=p.bits),
                    dataclasses.replace(p.cfg, verify=verify, abft_tag=tag))
                if not torch.equal(armed.planes, p.planes):
                    raise AssertionError(f"{tag}: planes programmed again "
                                         "differ from the restored ones")
                out.append(armed)
            return out
        return tree

    armed = {k: walk(v, [k]) if k == "layers" else v
             for k, v in params.items()}
    torch.cuda.synchronize()
    return armed, time.perf_counter() - t0


def qwen3_reliability_phase(torch, dev, mods, counters, cfg, params, base,
                            cont, smi):
    """(h) ABFT-verified continuous serving at full width: the restored
    plans (g) programmed once more with ``verify="always"``, then the
    continuous trace of (g) (8 slots, CONT_REQUESTS Poisson requests at
    0.5 per step, seed 0) through
    ``ContinuousScheduler(..., reliability=)``: verify off,
    ``sample`` and ``always`` on clean plans, then ``always`` under
    REL_FAULTS (the default policy: repair after one strike, degrade
    after three repairs) with the chaos check against the verify-off
    run's streams; then ``sync_every`` 4 on the trace's first
    REL_WINDOW_REQUESTS requests with the transient fault alone and no
    repair, so that windows are replayed. The clean runs go in turns:
    (g)'s verify-off run (``cont``'s timings), always, sample, and verify
    off once more. Every run's token streams and
    stop reasons equal (g)'s verify-off run's. B1's launches with
    row-sums by route, the checks against the verified dispatches,
    prefill ms per admitted request and decode ms per step at off /
    sample / always, recovery latencies."""
    import numpy as np
    serving, serve_mod, kern = mods["serving"], mods["serve"], \
        mods["pim_kern"]
    pim, relmod = mods["pim"], mods["reliability"]
    Engine = serving.ServingEngine
    geometry = dict(num_slots=CONT_SLOTS, prompt_pad=LM_PROMPT,
                    max_len=LM_PROMPT + LM_GEN)
    trace = qwen3_trace(serving, cfg)
    armed, program_s = arm_plans(torch, pim, params, "always")
    tags = relmod.degrade.armed_tags(armed)
    record_bytes = sum(t.numel() * t.element_size()
                       for p in layer_plans(armed["layers"])
                       for t in p.abft.values())
    log(f"qwen3 ABFT programming: {program_s:.3f} s for "
        f"{len(layer_plans(armed['layers']))} plans ({len(tags)} armed "
        f"tags), checksum records {record_bytes / 1e6:.2f} MB")
    runs, failures = {}, []

    def run(label, p, reqs, manager=None, sync_every=1):
        sched = serving.ContinuousScheduler(p, cfg, reliability=manager,
                                            sync_every=sync_every,
                                            **geometry)
        sched.warmup()
        relmod.FAULT_LOG.clear()      # the warm-up's drain and checks
        v, windows = {}, []

        def generate(self, state, max_steps=None):
            before = manager.retries if manager is not None else 0
            state, res = v_generate(self, state, max_steps)
            if manager is not None and manager.retries > before \
                    and res.steps > 1:
                windows.append(res.steps)
            return state, res
        v_generate = timed(v, "decode_s", Engine.generate)
        torch.cuda.synchronize()
        reset_counts(*counters)
        with patched((Engine, "prefill_step", timed(v, "prefill_s",
                                                    Engine.prefill_step)),
                     (Engine, "generate", generate)):
            r = sched.run(reqs)
        torch.cuda.synchronize()
        m = r.metrics
        got = streams(r.completions)
        want = {k: base[k] for k in got}
        diff = sorted(k for k in want if got[k] != want[k])
        if diff or len(got) != len(reqs):
            failures.append(f"{label}: {len(diff)} of {len(want)} requests "
                            f"differ from the verify-off run ({diff[:5]})")
        out = {"requests": len(reqs), "sync_every": sync_every,
               "tokens_per_s": m["tokens_per_s"], "wall_s": m["wall_s"],
               "host_syncs": m["host_syncs"],
               "decode_steps": m["decode_steps"],
               "prefills": m["prefills"],
               "prefill_units": m["prefill_units"],
               "prefill_ms_per_request": v["prefill_s"] * 1e3
               / m["prefills"],
               "decode_ms_per_step": v["decode_s"] * 1e3 / m["decode_steps"],
               "launches": read_counts(*counters),
               "launches_by_route": route_counts(kern, "pim_matmul_fused"),
               "rowsum_launches_by_route": {
                   k: n for k, n in kern.ROWSUM_LAUNCHES.items() if n},
               "fallback_traces": m["fallback_traces"],
               "reliability": m["reliability"],
               "mismatched_requests": diff, "replayed_windows": windows}
        runs[label] = out
        rel = m["reliability"] or {}
        log(f"qwen3 ABFT run {label}: {len(got) - len(diff)} of {len(got)} "
            f"requests' streams equal the verify-off run's; prefill "
            f"{out['prefill_ms_per_request']:.2f} ms per admitted request, "
            f"decode {out['decode_ms_per_step']:.2f} ms per step, "
            f"{out['tokens_per_s']:.1f} tokens/s; B1 row-sum launches "
            f"{out['rowsum_launches_by_route']}; reliability {rel} [{smi}]")
        return r, out

    # in turns: off ((g)'s run), always, sample, off (the host's speed
    # drifts between runs)
    runs["verify off, (g)"] = {key: cont[key] for key in (
        "prefill_ms_per_request", "decode_ms_per_step")}
    for mode, plans in (("always", armed),
                        ("sample", relmod.retarget_plans(armed, "exact-cuda",
                                                         "sample"))):
        man = relmod.ReliabilityManager(plans)
        _, out = run(f"abft {mode}", plans, trace, man)
        dispatches = out["prefill_units"] + out["host_syncs"]
        rel = out["reliability"]
        if rel["checks"] != dispatches * len(tags) or rel["violations"] \
                or rel["detections"] or rel["retries"]:
            failures.append(f"abft {mode}: {rel} for {dispatches} verified "
                            f"dispatches x {len(tags)} armed tags")
        if sum(out["rowsum_launches_by_route"].values()) != \
                out["launches"]["pim_matmul_fused"]:
            failures.append(f"abft {mode}: B1 launches without row-sums")
    run("verify off, again", params, trace)
    models = [relmod.FaultModel(**f) for f in REL_FAULTS]
    t0 = time.perf_counter()
    man = relmod.ReliabilityManager(armed, models)
    inject_s = time.perf_counter() - t0
    log(f"qwen3 fault injection: {len(man.injection_report)} faults in "
        f"{inject_s:.2f} s ({relmod.summarize(man.injection_report)})")
    faulty_run, out = run("abft always, faults", armed, trace, man)
    golden = {k: np.asarray(t) for k, (t, _) in base.items()}
    try:
        out["chaos_check"] = serve_mod.chaos_verdict(golden, faulty_run,
                                                     man)
    except AssertionError as e:
        failures.append(str(e))
    rel = out["reliability"]
    sticky = any(m.sticky for m in models)
    if not (rel["detections"] and rel["retries"] and rel["repairs"]) \
            or rel["degraded"] != sticky:
        failures.append(f"faults: {rel}, degraded expected {sticky}")
    out["injection_report"] = man.injection_report
    out["inject_s"] = inject_s
    few = trace[:REL_WINDOW_REQUESTS]
    wman = relmod.ReliabilityManager(
        armed, models[:1], relmod.ReliabilityPolicy(repair_after=10 ** 6))
    _, wout = run(f"abft always, transient fault, sync_every {CONT_WINDOW}",
                  armed, few, wman, sync_every=CONT_WINDOW)
    if not wout["replayed_windows"]:
        failures.append("no fused window was replayed")
    del armed, man, wman, faulty_run
    torch.cuda.empty_cache()
    on, sample = runs["abft always"], runs["abft sample"]
    off = {key: (runs["verify off, (g)"][key]
                 + runs["verify off, again"][key]) / 2
           for key in ("prefill_ms_per_request", "decode_ms_per_step")}
    overhead = {
        mode: {"prefill": r["prefill_ms_per_request"]
               / off["prefill_ms_per_request"] - 1.0,
               "decode": r["decode_ms_per_step"]
               / off["decode_ms_per_step"] - 1.0}
        for mode, r in (("sample", sample), ("always", on))}
    lat = runs["abft always, faults"]["reliability"]["recovery_latency_s"]
    log(f"qwen3 ABFT overhead against verify off (host clock; off the mean "
        f"of its two runs, {off['prefill_ms_per_request']:.2f} ms per "
        f"admitted request and {off['decode_ms_per_step']:.2f} ms per "
        f"step): sample "
        f"prefill {overhead['sample']['prefill']:+.3%}, decode "
        f"{overhead['sample']['decode']:+.3%}; always prefill "
        f"{overhead['always']['prefill']:+.3%}, decode "
        f"{overhead['always']['decode']:+.3%}; recovery latency mean "
        f"{lat['mean'] * 1e3:.1f} ms, max {lat['max'] * 1e3:.1f} ms over "
        f"{lat['count']} replays [{smi}]")
    shapes = Counter()     # the always run's launches (no warm-up)
    for plan in layer_plans(params["layers"]):
        k, n = plan.planes.shape[1:]
        shapes[(LM_PROMPT, k, n)] += on["prefill_units"]
        shapes[(CONT_SLOTS, k, n)] += on["host_syncs"]
    if on["launches"]["pim_matmul_fused"] != sum(shapes.values()):
        failures.append(f"abft always: {on['launches']} B1 launches, "
                        f"{sum(shapes.values())} expected")
    result = {"program_s": program_s, "armed_tags": tags,
              "record_bytes": record_bytes, "runs": runs,
              "overhead": overhead, "shapes": shapes, "card": smi,
              "launches": {"pim_matmul_fused": sum(shapes.values())},
              "rowsum_launches_by_route":
                  runs["abft always"]["rowsum_launches_by_route"],
              "failures": failures}
    if failures:
        raise AssertionError("qwen3 ABFT: " + "; ".join(failures))
    return result


def rowsum_rows(torch, dev, kern, ref, shapes):
    """B1 with and without its ABFT row-sum epilogue at each (M, K, N) of
    the verified path, w4a4: both bit for bit against the plain version,
    then device time in turns (without, with, with, without), the weight
    planes rotated over enough copies to leave L2 cold, beside the plain
    version's time (with row-sums), the bound of the function with
    row-sums and torch._int_mm + epilogue + an int64 row-sum (M > 16)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for (m, k, n), count in sorted(shapes.items(), key=lambda s: -s[0][0]):
        a = planes(torch, gen, 1, m, k, dev)
        copies = max(1, math.ceil(2 * L2_BYTES / (k * n)))
        ws = [planes(torch, gen, 1, k, n, dev) for _ in range(copies)]
        a_s, w_s, _ = scales(torch, gen, m, n, dev)
        want, want_rs = ref.pim_matmul_fused_ref(a, ws[0], a_s, w_s,
                                                 want_rowsum=True)
        out, rs = kern.pim_matmul_fused_cuda(a, ws[0], a_s, w_s,
                                             want_rowsum=True)
        err = max(max_err(torch, out, want), max_err(torch, rs, want_rs),
                  max_err(torch, kern.pim_matmul_fused_cuda(
                      a, ws[0], a_s, w_s), want))
        on = lambda i: kern.pim_matmul_fused_cuda(
            a, ws[i % copies], a_s, w_s, want_rowsum=True)
        off = lambda i: kern.pim_matmul_fused_cuda(a, ws[i % copies], a_s,
                                                   w_s)
        turns = [device_ms(torch, fn) for fn in (off, on, on, off)]
        row = {"M": m, "K": k, "N": n, "launches_per_request": count,
               "route": kern.small_m_grid(m, k, n)[0],
               "weight_copies": copies, "turns_ms": turns,
               "rowsum_ms": (turns[1] + turns[2]) / 2,
               "no_rowsum_ms": (turns[0] + turns[3]) / 2,
               "max_abs_err": err}
        row["rowsum_share"] = row["rowsum_ms"] / row["no_rowsum_ms"] - 1.0
        row["plain_ms"] = time_ms(torch, lambda: ref.pim_matmul_fused_ref(
            a, ws[0], a_s, w_s, want_rowsum=True))
        row["bound_ms"], row["bound_by"] = bound(1, 1, m, k, n, 4, 12 * m
                                                 + 4 * n)
        row["library_ms"] = None
        if m > 16:
            def lib(w=ws[0][0]):
                acc = torch._int_mm(a[0], w)
                return acc.float() * a_s * w_s, acc.sum(1)
            row["library_ms"] = time_ms(torch, lib)
        rows.append(row)
        log(f"B1 row-sums at M={m} K={k} N={n} ({row['route']}, "
            f"x{count}): with {row['rowsum_ms']:.4f} ms, without "
            f"{row['no_rowsum_ms']:.4f} ms ({row['rowsum_share']:+.2%}; "
            "turns without, with, with, without: "
            + ", ".join(f"{t:.4f}" for t in turns)
            + f"); plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']}, "
            f"torch._int_mm + epilogue + row-sum {row['library_ms']}")
        del a, ws
        torch.cuda.empty_cache()
    return rows


def rowsum_entry(rows, rel, smi):
    """B1's line for the ABFT-verified path: the always run's launches
    (every one with row-sums), its per-shape times summed over them."""
    tot = lambda key: sum(r[key] * r["launches_per_request"] for r in rows)
    lib = [r for r in rows if r["library_ms"] is not None]
    by = Counter()
    for r in rows:
        by[r["bound_by"]] += r["bound_ms"] * r["launches_per_request"]
    return {
        "name": "pim_matmul_fused", "path": "qwen3-4b continuous pim, "
        "abft always (want_rowsum)", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES["pim_matmul_fused"],
        "launches": rel["launches"]["pim_matmul_fused"],
        "launches_by_route": rel["rowsum_launches_by_route"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": tot("rowsum_ms"), "no_rowsum_ms": tot("no_rowsum_ms"),
        "plain_ms": tot("plain_ms"), "bound_ms": tot("bound_ms"),
        "bound_by": by.most_common(1)[0][0],
        "library_ms": sum(r["library_ms"] * r["launches_per_request"]
                          for r in lib) if lib else None,
        "per": (f"one ABFT-verified continuous qwen3-4b run (the trace of "
                f"the continuous line, verify always; {smi}): sum over the "
                f"whole prefills' launches (M = {LM_PROMPT}) and the decode "
                f"steps' (M = {CONT_SLOTS}) of B1 with its row-sum epilogue"
                ", device time with cold weights; no_rowsum_ms the same "
                "launches without it; library_ms covers the prefill shapes "
                "(torch._int_mm + epilogue + row-sum, M > 16)")}


REL_MOE_FAULT = {"target": "layers/moe/wi_edf", "seed": 4, "bitflips": 3,
                 "stuck_planes": 2, "stuck_value": 15, "dropped_chunks": 1}
REL_ANALOG_LAYERS = 2
REL_ANALOG_STEPS = 4


def reliability_checks(torch, dev, mods):
    """(i) ABFT on expert stacks and on the analog route, at full width
    and 2 layers: moonshot-v1-16b-a3b (64 experts) programmed with
    ``verify="always"`` and REL_MOE_FAULT injected into one expert stack:
    one prefill (batch 1, 64 tokens) on ``exact-cuda`` and on
    ``exact-torch`` (the plain version on the card) gives equal per-tag
    violation counts and equal logits, and the golden plans on the
    fallback (each exact substrate, verify off) give equal logits; then
    qwen3-4b programmed on ``analog-cuda`` with ``verify="always"``: a
    prefill (batch 8 x prompt 512) and REL_ANALOG_STEPS decode steps with
    no violation, then a stuck plane in ``layers/attn/wq_dh`` caught by
    the plane audit on the next prefill."""
    import dataclasses
    lm, serve_mod, pim, relmod = (mods["lm"], mods["serve"], mods["pim"],
                                  mods["reliability"])
    log_ = relmod.FAULT_LOG
    out = {}
    cfg = dataclasses.replace(mods["configs"].get_config(MOONSHOT),
                              num_layers=MOE_EXACT_LAYERS)
    planned = serve_mod.plan_params_for_pim(
        lm.init_lm(cfg, 0, device=dev),
        pim.PimConfig(weight_bits=4, act_bits=4, verify="always"))
    bad, report = relmod.inject_tree(planned,
                                     [relmod.FaultModel(**REL_MOE_FAULT)])
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                           device=dev)
    seen = {}
    for substrate in ("exact-cuda", "exact-torch"):
        log_.clear()
        logits, _ = lm.prefill(with_substrate(bad, substrate), cfg,
                               {"tokens": tokens}, 64)
        snap = log_.snapshot()
        fb, _ = lm.prefill(relmod.retarget_plans(planned, substrate), cfg,
                           {"tokens": tokens}, 64)
        seen[substrate] = (snap["violation_rows"], snap["total_violations"],
                           snap["total_checks"], logits, fb)
    c, t = seen["exact-cuda"], seen["exact-torch"]
    if c[:3] != t[:3] or not c[1] or not torch.equal(c[3], t[3]) or \
            not torch.equal(c[4], t[4]):
        raise AssertionError(f"moonshot ABFT: exact-cuda {c[:3]} vs "
                             f"exact-torch {t[:3]}, or their logits differ")
    out["moonshot"] = {"layers": MOE_EXACT_LAYERS, "injected": len(report),
                       "violation_rows": c[0], "violations": c[1],
                       "checks": c[2]}
    log(f"moonshot at full width and {MOE_EXACT_LAYERS} layers, verify "
        f"always, {len(report)} faults in layers/moe/wi_edf: exact-cuda "
        f"and exact-torch {c[1]} violations of {c[2]} checks, rows {c[0]},"
        " logits equal; the golden plans on each fallback substrate give "
        "equal logits")
    del planned, bad, seen, c, t
    torch.cuda.empty_cache()

    qcfg = dataclasses.replace(mods["configs"].get_config(QWEN3),
                               num_layers=REL_ANALOG_LAYERS)
    planned = serve_mod.plan_params_for_pim(
        lm.init_lm(qcfg, 0, device=dev),
        pim.PimConfig(weight_bits=4, act_bits=4, substrate="analog-cuda",
                      verify="always"))
    toks = lm_tokens(torch, dev, qcfg.vocab_size)
    akern = mods["analog_kern"]
    log_.clear()
    akern.reset_launches()
    logits, cache = lm.prefill(planned, qcfg, {"tokens": toks},
                               LM_PROMPT + REL_ANALOG_STEPS)
    tok = logits.argmax(-1)[:, None]
    for g in range(REL_ANALOG_STEPS):
        logits, cache = lm.decode_step(planned, qcfg, cache, tok,
                                       LM_PROMPT + g)
        tok = logits.argmax(-1)[:, None]
    clean = log_.snapshot()
    launches = dict(akern.LAUNCHES)
    bad, report = relmod.inject_tree(planned, [relmod.FaultModel(
        target="layers/attn/wq_dh", seed=5, stuck_planes=1,
        stuck_value=15)])
    log_.clear()
    lm.prefill(bad, qcfg, {"tokens": toks}, LM_PROMPT)
    faulty = log_.snapshot()
    want_checks = 7 * REL_ANALOG_LAYERS * (1 + REL_ANALOG_STEPS)
    if clean["total_violations"] or clean["total_checks"] != want_checks \
            or faulty["violation_rows"].get("layers/attn/wq_dh", 0) < 1 \
            or set(faulty["violation_rows"]) != {"layers/attn/wq_dh"} \
            or not all(launches.values()):
        raise AssertionError(f"qwen3 analog ABFT: clean {clean}, launches "
                             f"{launches}, faulty {faulty}")
    out["analog"] = {"layers": REL_ANALOG_LAYERS,
                     "decode_steps": REL_ANALOG_STEPS, "clean": clean,
                     "launches": launches, "stuck_plane": report,
                     "faulty": faulty}
    log(f"qwen3 at full width and {REL_ANALOG_LAYERS} layers on analog-cuda,"
        f" verify always: a prefill and {REL_ANALOG_STEPS} decode steps, "
        f"{clean['total_checks']} checks, no violation (analog launches "
        f"{launches}); a stuck plane in layers/attn/wq_dh: violation rows "
        f"{faulty['violation_rows']}")
    del planned, bad, cache
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The mesh: qwen3-4b on a 1x2 mesh of two ranks sharing the card
# ---------------------------------------------------------------------------
MESH_SPEC, MESH_RANKS = "1,2", 2
# moonshot's expert split and the stamped directory (2 until whisper-medium
# and paligemma-3b were served on the mesh; cut for the time limit)
MESH_EXACT_LAYERS = 1
MESH_TIMEOUT_S = 900      # both ranks' whole run, set-up included
MESH_TRACED = 1           # requests of the instrumented second run (8
                          # until the sharded-training phase came, 4 until
                          # the front-doors phase, 2 until whisper-medium
                          # and paligemma-3b were served on the mesh)
# per layer and forward step: q, k, v, gate, up split by columns (B1), o and
# down by rows (B2)
MESH_COL, MESH_ROW = 5, 2
# (K, N, kind) of the projections checked at kernel level: qwen3-4b's, then
# whisper-medium's (q/k/v of both attentions, the MLP's up; o and down) and
# paligemma-3b's (q, k/v of its one KV head, gate/up; o and down); and one
# moonshot expert stack's up projection (experts, K, N)
MESH_CHECKS = ((2560, 4096, "col"), (2560, 1024, "col"), (2560, 9728, "col"),
               (4096, 2560, "row"), (9728, 2560, "row"),
               (1024, 1024, "col"), (1024, 4096, "col"),
               (1024, 1024, "row"), (4096, 1024, "row"),
               (2048, 2048, "col"), (2048, 256, "col"), (2048, 16384, "col"),
               (2048, 2048, "row"), (16384, 2048, "row"))
MESH_EXPERT_CHECK = (4, 2048, 1408)
# the cross-attention's k and v run in prefill only (decode reads them from
# the cache)
CROSS_KV = (("xattn", "wk_dh"), ("xattn", "wv_dh"))
# (B1, B2) launches per rank per prefill and per decode step of the families
# on the 1x2 mesh with every plan split: q, k, v and the MLP's up (and gate)
# by columns, o and down by rows, in every layer of both stacks; whisper's
# cross-attention k and v in prefill only
FAMILY_MESH_LAUNCHES = {
    "whisper-medium": {"prefill": (24 * 4 + 24 * 7, 24 * 2 + 24 * 3),
                       "decode": (24 * 5, 24 * 3)},
    "paligemma-3b": {"prefill": (18 * 5, 18 * 2), "decode": (18 * 5, 18 * 2)}}


def mesh_rank(rank, world, init_file, task_file, out_file):
    """One rank of the mesh phase (the target of a spawned process): joins
    the gloo group on the shared card, runs the mesh's checks and its
    served trace, and writes its numbers to ``out_file``; a failure
    raises (the process exits non-zero)."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs, engine, serving
    from repro_torch.core import pim
    from repro_torch.engine import mesh as mesh_mod
    from repro_torch.kernels.act_quant import act_quant as qkern
    from repro_torch.kernels.analog_readout import analog_readout as akern
    from repro_torch.kernels.pim_matmul import pim_matmul as kern
    from repro_torch.kernels.pim_matmul import ref
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm
    # as in the parent: the float matmuls in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {"configs": configs, "engine": engine, "serving": serving,
            "pim": pim, "mesh": mesh_mod, "kern": kern, "akern": akern,
            "ref": ref, "serve": serve_mod, "lm": lm,
            "counters": (kern, akern, qkern, QuantCalls(pim))}
    task = json.loads(Path(task_file).read_text())
    backend = launch_mesh.init_distributed("cuda", f"file://{init_file}",
                                           rank, world)
    try:
        mesh = launch_mesh.make_serve_mesh(MESH_SPEC)
        out = {"rank": rank, "device": str(mesh.device), "backend": backend}
        out["kernel_checks"] = mesh_kernel_checks(torch, mods, mesh)
        out["serve"] = mesh_serve(torch, mods, task)
        out["moonshot"] = mesh_moonshot(torch, mods, mesh)
        out["persist"] = mesh_persist(torch, mods, mesh, task["plan_dir"])
        out["families"] = {arch: mesh_family_serve(torch, mods, arch, want)
                           for arch, want in task["families"].items()}
        Path(out_file).write_text(json.dumps(out, default=str))
    finally:
        dist.destroy_process_group()


def mesh_kernel_checks(torch, mods, mesh):
    """Each split at kernel level, at qwen3-4b's projection shapes and M =
    512 and 8: col and row ``engine.matmul`` on the mesh equal the unsplit
    plan on exact-cuda bit for bit, B2's int32 accumulator on each rank's
    K block equals its plain version, and an expert split of a moonshot
    stack (broadcast and paired) equals the unsplit stack. Launches here
    are not the main path's."""
    engine, pim, kern, ref = (mods["engine"], mods["pim"], mods["kern"],
                              mods["ref"])
    mesh_mod = mods["mesh"]
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(5)
    cfg = pim.PimConfig(weight_bits=4, act_bits=4, substrate="exact-cuda")
    out = {}
    for k, n, kind in MESH_CHECKS:
        w = torch.randn((k, n), generator=gen, device=dev)
        full = engine.program(w, cfg)
        split = engine.program(w, cfg, mesh=mesh, spec=kind)
        for m in (LM_PROMPT, CONT_SLOTS):
            x = torch.randn((m, k), generator=gen, device=dev)
            label = f"{kind} M={m} K={k} N={n}"
            if not torch.equal(engine.matmul(x, split),
                               engine.matmul(x, full)):
                raise AssertionError(f"mesh {label}: the split differs from "
                                     "the unsplit plan")
            if kind == "row":
                _, a_planes = pim._quantize_activations(x, cfg)
                width = split.planes.shape[-2]
                blk = mesh_mod.act_block(a_planes, split.shard.index * width,
                                         width)
                got = kern.pim_matmul_cuda(blk, split.planes)
                max_err(torch, got, ref.pim_matmul_ref(blk, split.planes))
            out[label] = True
    e, k, n = MESH_EXPERT_CHECK
    w = torch.randn((e, k, n), generator=gen, device=dev)
    full = engine.program(w, cfg, kind="experts")
    split = engine.program(w, cfg, kind="experts", mesh=mesh)
    for m in (LM_PROMPT, CONT_SLOTS):
        for paired in (False, True):
            x = torch.randn((e, m, k) if paired else (m, k), generator=gen,
                            device=dev)
            if not torch.equal(engine.matmul(x, split, paired=paired),
                               engine.matmul(x, full, paired=paired)):
                raise AssertionError(f"mesh expert split (M={m}, paired="
                                     f"{paired}) differs from the unsplit")
            out[f"expert M={m} paired={paired}"] = True
    torch.cuda.synchronize()
    return out


def mesh_calls(kern, forward_shapes, prefills, decode_steps):
    """(entry point, M, K, N) -> launches over a served run of the mesh:
    each forward shape once per prefill of LM_PROMPT rows and once per
    decode step of CONT_SLOTS rows, the warm-up's prefill and decode step
    included."""
    calls = Counter()
    for name, k, n, c in forward_shapes:
        calls[(name, LM_PROMPT, k, n)] += c * (prefills + 1)
        calls[(name, CONT_SLOTS, k, n)] += c * (decode_steps + 1)
    return calls


def event_timed(torch, store, fn):
    """``fn`` with CUDA events around each call (device time, summed by
    :func:`event_ms`; no sync)."""
    def wrapper(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        store.append((start, end))
        return out
    return wrapper


def event_ms(torch, pairs):
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs)


def synced(torch, store, key, fn):
    """``fn`` with the device synchronized before and after, its host
    seconds added to ``store[key]`` and its calls counted: a collective's
    own time, without the queued work it would otherwise wait for."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        store[key] = store.get(key, 0.0) + time.perf_counter() - t0
        store[key + "_calls"] = store.get(key + "_calls", 0) + 1
        return out
    return wrapper


def mesh_serve(torch, mods, task):
    """The main path on the mesh: ``serve_continuous(qwen3-4b, ...,
    mesh="1,2")`` on the qwen3 continuous phase's trace and slots, its
    launch counts set to 0 just before and read just after, its 32 token
    streams held to the single-device run's; prefill and decode times
    (host clock around the engine's verbs, as single-device, and nothing
    else timed in this run), resident and peak memory. Then
    :func:`mesh_collectives`' instrumented run."""
    serve_mod, serving, kern = mods["serve"], mods["serving"], mods["kern"]
    mesh_mod = mods["mesh"]
    Engine = serving.ServingEngine
    t, mem = {}, {}
    real_setup = serve_mod._setup

    def setup(*args, **kwargs):
        res = real_setup(*args, **kwargs)
        torch.cuda.synchronize()
        mem["resident_bytes"] = torch.cuda.memory_allocated()
        mem["setup_peak_bytes"] = torch.cuda.max_memory_allocated()
        plans = layer_plans(res[1]["layers"])
        mem["kinds"] = dict(Counter(
            "whole" if p.shard is None else p.shard.kind for p in plans))
        mem["plan_bytes"] = sum(p.planes.numel() + p.values.numel()
                                for p in plans)
        # (entry point, K, N) as the kernel sees each rank's slice -> its
        # launches per forward step: B1 on the column blocks, B2 on the
        # row blocks
        mem["forward_shapes"] = [
            [name, k, n, c] for (name, k, n), c in Counter(
                ("pim_matmul_int" if p.shard.kind == "row"
                 else "pim_matmul_fused", *p.planes.shape[-2:])
                for p in plans).items()]
        return res

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*mods["counters"])
    mesh_mod.reset_collectives()
    t0 = time.perf_counter()
    with patched((serve_mod, "_setup", setup),
                 (Engine, "prefill_step", timed(t, "prefill_s",
                                                Engine.prefill_step)),
                 (Engine, "generate", timed(t, "decode_s", Engine.generate))):
        res = serve_mod.serve_continuous(
            QWEN3, num_slots=CONT_SLOTS, num_requests=CONT_REQUESTS,
            prompt_len=LM_PROMPT, gen=LM_GEN, pim=True,
            arrival_rate=CONT_RATE, seed=0, mesh=MESH_SPEC)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts(*mods["counters"])
    b1 = route_counts(kern, "pim_matmul_fused")
    b2 = route_counts(kern, "pim_matmul_int")
    got = {str(k): v for k, v in entry_streams(res).items()}
    want = {k: tuple(v) for k, v in task["streams"].items()}
    diff = sorted(k for k in want if tuple(got.get(k, ())) != want[k])
    if diff or len(got) != len(want):
        raise AssertionError(f"mesh: {len(diff)} of {len(want)} token "
                             f"streams differ from single-device ({diff[:5]})")
    layers = mods["configs"].get_config(QWEN3).num_layers
    calls = mesh_calls(kern, mem["forward_shapes"], res["prefills"],
                       res["decode_steps"])
    want = {name: Counter() for name in ("pim_matmul_fused",
                                         "pim_matmul_int")}
    for (name, m, k, n), c in calls.items():
        want[name][kern.small_m_grid(m, k, n)[0]] += c
    want_b1, want_b2 = (dict(want["pim_matmul_fused"]),
                        dict(want["pim_matmul_int"]))
    per_step = {name: sum(c for nm, _, _, c in mem["forward_shapes"]
                          if nm == name) for name in want}
    if b1 != want_b1 or b2 != want_b2 or per_step != {
            "pim_matmul_fused": MESH_COL * layers,
            "pim_matmul_int": MESH_ROW * layers} or other_kernels(
                launches, "pim_matmul_fused", "pim_matmul_int"):
        raise AssertionError(f"mesh launches {launches}: B1 by route {b1} "
                             f"(expected {want_b1}), B2 by route {b2} "
                             f"(expected {want_b2}); per forward step "
                             f"{per_step}")
    if (res["mesh"], res["mesh_ranks"], res["mesh_backend"]) != \
            (MESH_SPEC, MESH_RANKS, "gloo"):
        raise AssertionError(f"mesh fields {res.get('mesh')}")
    out = {"entry_s": seconds, "launches": launches, "b1_by_route": b1,
           "b2_by_route": b2,
           "collective_counts": dict(mesh_mod.COLLECTIVES),
           "prefills": res["prefills"], "decode_steps": res["decode_steps"],
           "prefill_ms_per_request": t["prefill_s"] * 1e3 / res["prefills"],
           "decode_ms_per_step": t["decode_s"] * 1e3 / res["decode_steps"],
           "tokens_per_s": res["tokens_per_s"], "wall_s": res["wall_s"],
           "peak_bytes": torch.cuda.max_memory_allocated(), **mem}
    out["instrumented"] = mesh_collectives(torch, mods)
    return out


def mesh_collectives(torch, mods):
    """A second, shorter served run on the mesh (the first MESH_TRACED
    requests of a trace drawn as the main run's), instrumented: the device
    synchronized before and after every collective (its own host time,
    without the queued work it would otherwise wait for) and CUDA events
    around every K-block copy of the row splits. Its share of collectives
    is read against its own wall time; its prefill and decode times show
    what the instrumentation costs."""
    serve_mod, serving = mods["serve"], mods["serving"]
    mesh_mod = mods["mesh"]
    Engine = serving.ServingEngine
    t, coll, blocks = {}, {}, []
    mesh_mod.reset_collectives()
    with patched((Engine, "prefill_step", timed(t, "prefill_s",
                                                Engine.prefill_step)),
                 (Engine, "generate", timed(t, "decode_s", Engine.generate)),
                 (mesh_mod, "all_gather_list",
                  synced(torch, coll, "all_gather_s",
                         mesh_mod.all_gather_list)),
                 (mesh_mod, "all_reduce",
                  synced(torch, coll, "all_reduce_s", mesh_mod.all_reduce)),
                 (mesh_mod, "act_block",
                  event_timed(torch, blocks, mesh_mod.act_block))):
        res = serve_mod.serve_continuous(
            QWEN3, num_slots=CONT_SLOTS, num_requests=MESH_TRACED,
            prompt_len=LM_PROMPT, gen=LM_GEN, pim=True,
            arrival_rate=CONT_RATE, seed=0, mesh=MESH_SPEC)
        torch.cuda.synchronize()
    return {"requests": MESH_TRACED, "collectives": dict(coll),
            "collective_counts": dict(mesh_mod.COLLECTIVES),
            "k_block_copies": len(blocks),
            "k_block_ms": event_ms(torch, blocks),
            "prefills": res["prefills"], "decode_steps": res["decode_steps"],
            "prefill_ms_per_request": t["prefill_s"] * 1e3 / res["prefills"],
            "decode_ms_per_step": t["decode_s"] * 1e3 / res["decode_steps"],
            "tokens_per_s": res["tokens_per_s"], "wall_s": res["wall_s"]}


def mesh_moonshot(torch, mods, mesh):
    """The expert split at full width: moonshot-v1-16b-a3b at 2 layers (64
    experts, 32 a rank), programmed whole and split on exact-cuda and on
    analog-cuda (whose dense plans the walk replicates); the prefill's
    logits (batch 8 x 512: the layer's experts in chunks of 16, each from
    one rank) and one decode step's (one chunk of all 64) equal the whole
    plans' bit for bit."""
    import dataclasses
    serve_mod, lm, pim, engine = (mods["serve"], mods["lm"], mods["pim"],
                                  mods["engine"])
    dev = mesh.device
    cfg = dataclasses.replace(mods["configs"].get_config(MOONSHOT),
                              num_layers=MESH_EXACT_LAYERS)
    tokens = lm_tokens(torch, dev, cfg.vocab_size)
    out = {}
    for substrate in ("exact-cuda", "analog-cuda"):
        whole = serve_mod._program(cfg, pim.PimConfig(
            weight_bits=4, act_bits=4, substrate=substrate), dev)
        split = engine.shard_plan_tree(whole, mesh)
        kinds = Counter("whole" if p.shard is None else p.shard.kind
                        for p in layer_plans(split["layers"]))
        logits = []
        for planned in (whole, split):
            pre, cache = lm.prefill(planned, cfg, {"tokens": tokens},
                                    LM_PROMPT + 1)
            step, _ = lm.decode_step(planned, cfg, cache,
                                     torch.argmax(pre, -1)[:, None],
                                     LM_PROMPT)
            logits.append((pre, step))
            del cache
        if not (torch.equal(logits[0][0], logits[1][0]) and
                torch.equal(logits[0][1], logits[1][1])):
            raise AssertionError(f"mesh moonshot {substrate}: the expert "
                                 "split's logits differ from the whole "
                                 "plans'")
        out[substrate] = {"kinds": dict(kinds), "equal": True}
        del whole, split, logits
        torch.cuda.empty_cache()
    return out


def mesh_persist(torch, mods, mesh, plan_dir):
    """A stamped plan directory: qwen3-4b at 2 layers (full width)
    programmed on the mesh, saved (rank 0 writes the whole leaves),
    restored with ``load_plans(mesh=)``: the same kinds and prefill logits
    bit for bit."""
    import dataclasses
    serve_mod, lm, pim, engine = (mods["serve"], mods["lm"], mods["pim"],
                                  mods["engine"])
    dev = mesh.device
    cfg = dataclasses.replace(mods["configs"].get_config(QWEN3),
                              num_layers=MESH_EXACT_LAYERS)
    tokens = lm_tokens(torch, dev, cfg.vocab_size)
    pim_cfg = pim.PimConfig(weight_bits=4, act_bits=4, substrate="exact-cuda")
    split = serve_mod._program(cfg, pim_cfg, dev, mesh)
    want = lm.prefill(split, cfg, {"tokens": tokens}, LM_PROMPT + 1)[0]
    t0 = time.perf_counter()
    engine.save_plans(plan_dir, split, extras={"mesh": MESH_SPEC})
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, _, extras = engine.load_plans(plan_dir, mesh=mesh)
    load_s = time.perf_counter() - t0
    kinds = lambda tree: [None if p.shard is None else p.shard.kind
                          for p in layer_plans(tree["layers"])]
    got = lm.prefill(restored, cfg, {"tokens": tokens}, LM_PROMPT + 1)[0]
    if kinds(restored) != kinds(split) or not torch.equal(got, want) or \
            extras != {"mesh": MESH_SPEC}:
        raise AssertionError("mesh: the restored stamped directory differs "
                             "from the plans saved")
    size = sum(f.stat().st_size for f in Path(plan_dir).rglob("*")
               if f.is_file())
    restored_kinds = Counter(str(k) for k in kinds(restored))
    del split, restored
    torch.cuda.empty_cache()
    return {"save_s": save_s, "load_s": load_s, "directory_bytes": size,
            "kinds": dict(restored_kinds), "equal": True}


def stack_plans(tree, keys=()):
    """(keys below the layer, plan) of every plan of one layer stack (its
    per-layer lists)."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in stack_plans(v, keys + (k,))]
    return [(keys, p) for p in tree] if isinstance(tree, list) else []


def family_mesh_plan(params):
    """What a family's placed plans launch: B2 (``pim_matmul_int``) for a
    row split, B1 (``pim_matmul_fused``) for a column split or a plan the
    walk left whole. Returns (entry point, K, N) as each rank's kernel
    sees them -> launches per prefill (every plan of both stacks) and per
    decode step (the decoder's, but the cross-attention's k and v), and
    the names of the plans left whole."""
    per = {"prefill": Counter(), "decode": Counter()}
    whole = []
    for stack in ("enc_layers", "layers"):
        for keys, plan in stack_plans(params.get(stack, {})):
            row = plan.shard is not None and plan.shard.kind == "row"
            if plan.shard is None:
                whole.append("/".join((stack,) + keys))
            key = ("pim_matmul_int" if row else "pim_matmul_fused",
                   *plan.planes.shape[-2:])
            per["prefill"][key] += 1
            if stack == "layers" and keys not in CROSS_KV:
                per["decode"][key] += 1
    return per, whole


def coll_text(c):
    """Seconds, calls and bytes of each collective kind in ``c``."""
    return ", ".join(
        f"{kind} {c.get(kind + '_s', 0.0):.3f} s in "
        f"{c.get(kind + '_s_calls', 0)} calls, "
        f"{c.get(kind + '_bytes', 0) / 1e9:.3f} GB"
        for kind in ("all_gather", "all_reduce"))


def mesh_family_serve(torch, mods, arch, want):
    """whisper-medium or paligemma-3b served on the mesh at full width and
    depth: serving's set-up (``serve._setup(..., mesh_spec=)``: each layer
    of both stacks programmed at w4a4 on exact-cuda and placed as it is
    drawn), then one timed static request of ``family_serve_path`` (batch
    8, prompt 512, its stub frames or patches, 16 new tokens) with no
    warm-up of its own (cut for the time limit: the ranks are warm from
    qwen3-4b's run, and a family's gloo-bound prefill takes seconds), its
    launch counts and collectives set to 0 just before and read just
    after: the tokens equal the single-device
    ``want`` bit for bit, no plan is left whole, B1 and B2 launches per
    prefill and decode step as ``FAMILY_MESH_LAUNCHES`` and by route as the
    route chooser gives them, no other kernel; prefill and decode times
    (CUDA events; the device synchronized around every collective, whose
    own host seconds and bytes are read for prefill and decode apart),
    resident and peak memory."""
    serve_mod, kern, mesh_mod = mods["serve"], mods["kern"], mods["mesh"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, _, _, mesh = serve_mod._setup(
        arch, None, None, True, 4, False, "exact-cuda", None,
        mesh_spec=MESH_SPEC)
    torch.cuda.synchronize()
    out = {"setup_s": time.perf_counter() - t0,
           "resident_bytes": torch.cuda.memory_allocated(),
           "setup_peak_bytes": torch.cuda.max_memory_allocated()}
    per, whole = family_mesh_plan(params)
    if whole:
        raise AssertionError(f"mesh {arch}: plans left whole {whole}")
    tokens, inputs = serve_mod.request_inputs(cfg, LM_BATCH, LM_PROMPT,
                                              mesh.device)
    coll, at_prefill = {}, {}

    def prefill(*args, **kwargs):
        res = prefill_fn(*args, **kwargs)
        at_prefill.update(coll)
        return res

    def moved(kind, gathers):
        """The collective, synced, with the bytes it delivers to this rank
        (a gather's whole output, a reduce's sum)."""
        fn = getattr(mesh_mod, "all_gather_list" if gathers else kind)
        timed_fn = synced(torch, coll, kind + "_s", fn)

        def wrapper(t, mesh, axes):
            if mesh.group(axes) is None:
                return fn(t, mesh, axes)
            coll[kind + "_bytes"] = coll.get(kind + "_bytes", 0) + (
                t.numel() * t.element_size() * (
                    mesh.size(axes) if gathers else 1))
            return timed_fn(t, mesh, axes)
        return wrapper

    prefill_fn = serve_mod.prefill
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*mods["counters"])
    mesh_mod.reset_collectives()
    t0 = time.perf_counter()
    with patched((serve_mod, "prefill", prefill),
                 (mesh_mod, "all_gather_list", moved("all_gather", True)),
                 (mesh_mod, "all_reduce", moved("all_reduce", False))):
        generated, pre_s, dec_s, logits = serve_mod.static_loop(
            params, cfg, tokens, LM_GEN, inputs=inputs)
        torch.cuda.synchronize()
    out["request_s"] = time.perf_counter() - t0
    out["collective_prefill"] = dict(at_prefill)
    out["collective_decode"] = {k: v - at_prefill.get(k, 0)
                                for k, v in coll.items()}
    launches = read_counts(*mods["counters"])
    b1, b2 = (route_counts(kern, "pim_matmul_fused"),
              route_counts(kern, "pim_matmul_int"))
    collectives = dict(mesh_mod.COLLECTIVES)
    if generated.cpu().tolist() != want or not bool(
            torch.isfinite(logits[:, :cfg.vocab_size]).all()):
        raise AssertionError(f"mesh {arch}: the tokens differ from the "
                             "single-device run's")
    rows = LM_BATCH * (LM_PROMPT + cfg.vision_tokens)
    want_routes = {"pim_matmul_fused": Counter(), "pim_matmul_int": Counter()}
    for phase, m, times in (("prefill", rows, 1),
                            ("decode", LM_BATCH, LM_GEN)):
        for (name, k, n), c in per[phase].items():
            want_routes[name][kern.small_m_grid(m, k, n)[0]] += c * times
    want_routes = {k: dict(v) for k, v in want_routes.items()}
    if b1 != want_routes["pim_matmul_fused"] or \
            b2 != want_routes["pim_matmul_int"] or other_kernels(
                launches, "pim_matmul_fused", "pim_matmul_int"):
        raise AssertionError(f"mesh {arch} launches {launches}: B1 by route "
                             f"{b1}, B2 by route {b2}, expected "
                             f"{want_routes}")
    count = lambda phase, name: sum(c for (nm, _, _), c in
                                    per[phase].items() if nm == name)
    for phase, (n1, n2) in FAMILY_MESH_LAUNCHES[arch].items():
        if (count(phase, "pim_matmul_fused"),
                count(phase, "pim_matmul_int")) != (n1, n2):
            raise AssertionError(f"mesh {arch}: B1/B2 per {phase} "
                                 f"{dict(per[phase])}, expected {n1}/{n2}")
    out.update({
        "prefill_ms": pre_s * 1e3,
        "decode_ms_per_token": dec_s * 1e3 / LM_GEN,
        "b1_by_route": b1, "b2_by_route": b2, "collectives": collectives,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "per_prefill": {n: count("prefill", n) for n in want_routes},
        "per_decode_step": {n: count("decode", n) for n in want_routes},
        "shapes": {phase: [[*key, c] for key, c in per[phase].items()]
                   for phase in per},
        "prefill_rows": rows})
    del params, logits
    torch.cuda.empty_cache()
    return out


def family_split_rows(torch, dev, kern, ref, arch, fam):
    """B1 and B2 at one family's per-rank split shapes (the prefill's M and
    the decode step's M = 8; w4a4, one plane pair, no bias): each bit for
    bit against its plain version, then its device time beside its bound;
    summed over one request's launches (a prefill and LM_GEN decode
    steps)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    rows, total = [], {}
    for phase, m, times in (("prefill", fam["prefill_rows"], 1),
                            ("decode", LM_BATCH, LM_GEN)):
        for name, k, n, count in fam["shapes"][phase]:
            a = planes(torch, gen, 1, m, k, dev)
            w = planes(torch, gen, 1, k, n, dev)
            if name == "pim_matmul_int":
                fn = lambda i: kern.pim_matmul_cuda(a, w)
                max_err(torch, fn(0), ref.pim_matmul_ref(a, w))
                least = bound(1, 1, m, k, n, 4, 0)
            else:
                a_s, w_s, _ = scales(torch, gen, m, n, dev)
                fn = lambda i: kern.pim_matmul_fused_cuda(a, w, a_s, w_s)
                max_err(torch, fn(0),
                        ref.pim_matmul_fused_ref(a, w, a_s, w_s))
                least = bound(1, 1, m, k, n, 4, 4 * m + 4 * n)
            ms = device_ms(torch, fn, reps=50)
            launches = count * times
            rows.append({"entry": name, "M": m, "K": k, "N": n,
                         "launches_per_request": launches,
                         "route": kern.small_m_grid(m, k, n)[0], "ms": ms,
                         "bound_ms": least[0], "bound_by": least[1]})
            t = total.setdefault(name, {"launches": 0, "ms": 0.0,
                                        "bound_ms": 0.0})
            t["launches"] += launches
            t["ms"] += ms * launches
            t["bound_ms"] += least[0] * launches
            del a, w
    for name, t in total.items():
        log(f"{arch} mesh {MESH_SPEC}, {name} at the rank's split shapes "
            f"(w4a4, device time, bit-exact against the plain version): "
            f"{t['launches']} launches per request, {t['ms']:.3f} ms against "
            f"a bound of {t['bound_ms']:.3f} ms; by shape " + ", ".join(
                f"M={r['M']} K={r['K']} N={r['N']} "
                f"x{r['launches_per_request']} {r['route']} {r['ms']:.4f} ms "
                f"(bound {r['bound_ms']:.4f} by {r['bound_by']})"
                for r in rows if r["entry"] == name))
    torch.cuda.empty_cache()
    return {"rows": rows, "per_request": total}


def mesh_phase(torch, dev, mods, single, families, smi):
    """(j) the mesh: two ranks spawned on the one card (gloo), after every
    kernel library is built here and the earlier phases' plans are freed;
    each rank serves qwen3-4b at full width on a 1x2 mesh, then
    whisper-medium and paligemma-3b, and runs the checks of
    :func:`mesh_rank`. ``single`` is the qwen3 continuous phase's result
    (its token streams, held to bit for bit, and its times), ``families``
    the families' served paths (their tokens, held likewise). Then B2 and
    B1 at the mesh paths' shapes, timed here."""
    import multiprocessing
    kern, ref = mods["pim_kern"], mods["pim_ref"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="mesh_"))
    task = {"streams": single["streams"], "plan_dir": str(work / "plans"),
            "families": {arch: fam["tokens"]
                         for arch, fam in families.items()}}
    (work / "task.json").write_text(json.dumps(task))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank, args=(
        r, MESH_RANKS, str(work / "init"), str(work / "task.json"),
        str(work / f"rank{r}.json"))) for r in range(MESH_RANKS)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + MESH_TIMEOUT_S
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    seconds = time.perf_counter() - t0
    try:
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"mesh ranks exited with {codes} (a rank "
                                 "that failed prints its traceback above)")
        ranks = [json.loads((work / f"rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"spec": MESH_SPEC, "ranks": ranks, "seconds": seconds,
           "card": smi}
    first = ranks[0]["serve"]
    layers = mods["configs"].get_config(QWEN3).num_layers
    shapes = {"pim_matmul_int": Counter(), "pim_matmul_fused": Counter()}
    for (name, m, k, n), c in mesh_calls(
            kern, first["forward_shapes"], first["prefills"],
            first["decode_steps"]).items():
        shapes[name][(m, k, n)] += c
    single_cont = {k: single[k] for k in ("prefill_ms_per_request",
                                          "decode_ms_per_step")}
    single_cont["tokens_per_s"] = single["metrics"]["tokens_per_s"]
    out["single_device"] = single_cont
    out["shapes"] = {name: [list(s) + [c] for s, c in sh.items()]
                     for name, sh in shapes.items()}
    for r in ranks:
        s = r["serve"]
        ins = s["instrumented"]
        coll = ins["collectives"]
        log(f"mesh rank {r['rank']} ({r['device']}, {r['backend']}): "
            f"resident {s['resident_bytes'] / 2 ** 30:.3f} GiB (plans "
            f"{s['plan_bytes'] / 2 ** 30:.3f} GiB, kinds {s['kinds']}), "
            f"peak {s['peak_bytes'] / 2 ** 30:.3f} GiB; B1 by route "
            f"{s['b1_by_route']}, B2 by route {s['b2_by_route']}, "
            f"collectives {s['collective_counts']} in the main run; "
            f"instrumented run ({ins['requests']} requests, "
            f"{ins['prefills']} prefills, {ins['decode_steps']} decode "
            f"steps): collectives {ins['collective_counts']}, all-gather "
            f"{coll.get('all_gather_s', 0.0):.3f} s, all-reduce "
            f"{coll.get('all_reduce_s', 0.0):.3f} s (host clock, synced) of "
            f"its {ins['wall_s']:.2f} s; prefill "
            f"{ins['prefill_ms_per_request']:.2f} ms per request, decode "
            f"{ins['decode_ms_per_step']:.2f} ms per step under the "
            f"instrumentation; {ins['k_block_copies']} row-split K-block "
            f"copies, {ins['k_block_ms']:.3f} ms of device time")
    log(f"qwen3 mesh {MESH_SPEC} ({MESH_RANKS} ranks on one card, gloo; "
        f"{smi}; main run, uninstrumented): the "
        f"{len(single['streams'])} token streams equal the "
        "single-device run's bit for bit; prefill "
        f"{first['prefill_ms_per_request']:.2f} ms per admitted request "
        f"(single device {single_cont['prefill_ms_per_request']:.2f}), "
        f"decode {first['decode_ms_per_step']:.2f} ms per step "
        f"({single_cont['decode_ms_per_step']:.2f}), "
        f"{first['tokens_per_s']:.2f} tokens/s "
        f"({single_cont['tokens_per_s']:.2f}); B2 per prefill and per "
        f"decode step {MESH_ROW * layers}, B1 {MESH_COL * layers}; "
        f"{seconds:.1f} s with both ranks' set-up and checks")
    for r in ranks:
        m = r["moonshot"]
        p = r["persist"]
        log(f"mesh rank {r['rank']}: moonshot-v1-16b-a3b at "
            f"{MESH_EXACT_LAYERS} layers, expert split on exact-cuda "
            f"{m['exact-cuda']['kinds']} and analog-cuda "
            f"{m['analog-cuda']['kinds']}: prefill and decode logits equal "
            f"the whole plans'; stamped directory ({QWEN3}, "
            f"{MESH_EXACT_LAYERS} layers, {p['directory_bytes'] / 1e9:.3f} "
            f"GB): saved {p['save_s']:.2f} s, restored on the mesh "
            f"{p['load_s']:.2f} s, kinds {p['kinds']}, logits equal; "
            f"{len(r['kernel_checks'])} kernel-level split checks equal")
    for arch, single_fam in families.items():
        for r in ranks:
            f = r["families"][arch]
            log(f"mesh rank {r['rank']}: {arch} served at full width on "
                f"{MESH_SPEC} ({smi}): tokens equal the single-device run's "
                f"bit for bit; prefill {f['prefill_ms']:.2f} ms (single "
                f"device {statistics.median(single_fam['prefill_ms']):.2f}), "
                f"decode {f['decode_ms_per_token']:.2f} ms per token "
                f"({statistics.median(single_fam['decode_ms_per_token']):.2f}"
                f"); per prefill {f['per_prefill']}, per decode step "
                f"{f['per_decode_step']}; B1 by route {f['b1_by_route']}, B2 "
                f"by route {f['b2_by_route']}; collectives "
                f"{f['collectives']} in the request (one request, no "
                f"warm-up of its own), synced on the host clock: "
                f"{coll_text(f['collective_prefill'])} in prefill, "
                f"{coll_text(f['collective_decode'])} in decode; resident "
                f"{f['resident_bytes'] / 2 ** 30:.3f} GiB, peak "
                f"{f['peak_bytes'] / 2 ** 30:.3f} GiB; set-up "
                f"{f['setup_s']:.1f} s; no plan left whole")
    out["max_abs_err"] = {
        "pim_matmul_fused": lm_kernel_checks(
            torch, dev, kern, ref, shapes["pim_matmul_fused"]),
        "pim_matmul_int": int_kernel_checks(
            torch, dev, kern, ref, shapes["pim_matmul_int"])}
    out["rows"] = {name: shape_numbers(torch, dev, kern, ref, sh,
                                       with_bias=False)
                   for name, sh in shapes.items()}
    out["families"] = {arch: family_split_rows(
        torch, dev, kern, ref, arch, ranks[0]["families"][arch])
        for arch in families}
    return out


def int_kernel_checks(torch, dev, kern, ref, shapes):
    """B2 at the mesh path's row-split shapes, bit for bit against its
    plain version."""
    err = 0.0
    gen = torch.Generator(device=dev).manual_seed(6)
    for m, k, n in sorted(shapes):
        a = planes(torch, gen, 1, m, k, dev)
        w = planes(torch, gen, 1, k, n, dev)
        err = max(err, max_err(torch, kern.pim_matmul_cuda(a, w),
                               ref.pim_matmul_ref(a, w)))
    log(f"kernel check at the {len(shapes)} row-split shapes (w4a4): B2 "
        "bit-exact")
    return err


def mesh_entries(mesh):
    """The mesh path's lines: B2 (the row splits) and B1 (the column
    splits), rank 0's launches, per run of the trace."""
    first = mesh["ranks"][0]["serve"]
    per = (f"one continuous qwen3-4b run on a {MESH_SPEC} mesh (2 ranks "
           f"sharing the card, gloo; {CONT_REQUESTS} Poisson requests, "
           f"{CONT_SLOTS} slots, w4a4; rank 0's launches, the warm-up "
           "included): device time summed over the run's launches, "
           f"{LM_PROMPT}-row prefills on the wgmma route and "
           f"{CONT_SLOTS}-row decode steps on the small-M route; "
           "library_ms is torch._int_mm on one plane pair over the prefill "
           "shapes (it takes M > 16)")
    b2 = kernel_entry("pim_matmul_int", "int", mesh["rows"]["pim_matmul_int"],
                      first["launches"], mesh["max_abs_err"],
                      path=f"qwen3-4b mesh {MESH_SPEC}"
                      " row splits", routes=first["b2_by_route"], per=per)
    b1 = kernel_entry("pim_matmul_fused", "fused",
                      mesh["rows"]["pim_matmul_fused"], first["launches"],
                      mesh["max_abs_err"], path=f"qwen3-4b mesh {MESH_SPEC} column splits",
                      routes=first["b1_by_route"], per=per)
    return [b2, b1]


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


# ---------------------------------------------------------------------------
# Sharded training: gemma3-1b, paligemma-3b and whisper-medium on meshes of
# two ranks sharing the card
# ---------------------------------------------------------------------------
# The runs, in order, as (arch, spec): gemma3-1b on the 1x2 tensor-parallel
# mesh and on the 2x1 data-parallel mesh, then paligemma-3b at full width
# and depth and whisper-medium at WHISPER_TRAIN_LAYERS layers of each stack
# on 1x2, each family held to family_train_path's steps
TRAIN_MESHES = (("gemma3-1b", "1,2"), ("gemma3-1b", "2,1"),
                ("paligemma-3b", "1,2"), ("whisper-medium", "1,2"))
# gemma3-1b's layers on each mesh: 6 of 26 on 1x2 (all 26 until
# paligemma-3b and whisper-medium were trained on the mesh; cut for the
# time limit, keeping five local layers and a global one), 2 on 2x1
TRAIN_MESH_GEMMA_LAYERS = {"1,2": 6, "2,1": 2}
TRAIN_MESH_TIMEOUT_S = 600    # both ranks' whole run, set-up included
TRAIN_OPT = dict(lr=3e-4, total_steps=100, warmup_steps=5)
# the parameters after the warm-up and TRAIN_STEPS steps against one
# device's, absolute: an element whose gradient is near zero moves by a
# different fraction of an Adam step when its gradient differs in the last
# bits (the JAX package's bound for its sharded step)
TRAIN_PARAM_ATOL = 5e-3
# the leaf whose gathered gradient the control cuts in half (a lost block)
TRAIN_MESH_CONTROL = "d:'layers'/d:'attn'/d:'wq_dh'"
# the layer stacks' keys in a flatten path
STACKS = ("d:'layers'", "d:'enc_layers'")


def gemma_train_cfg(mods, layers=None):
    import dataclasses
    cfg = dataclasses.replace(mods["configs"].get_config("gemma3-1b"),
                              attn_backend="cuda")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def train_mesh_cfg(mods, arch, spec):
    if arch == "gemma3-1b":
        return gemma_train_cfg(mods, TRAIN_MESH_GEMMA_LAYERS[spec])
    return family_train_cfg(mods, arch)


def train_seq(cfg):
    return TRAIN_SEQ if cfg.name == "gemma3-1b" else family_train_seq(cfg)


def train_batches(mods, cfg, seq, dev, n):
    from repro_torch.data.pipeline import DataConfig, LMDataIterator
    it = LMDataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=TRAIN_BATCH), cfg)
    return [mods["train"].batch_to_device(next(it), dev) for _ in range(n)]


def train_reference(torch, dev, mods, cfg, path):
    """The single-device numbers a gemma3-1b mesh run is held to: the loss,
    gradient norm and gradient (saved under ``path``, leaf by leaf on the
    host) of the state drawn from seed 0 on the first batch, then a warm-up
    step and TRAIN_STEPS steps (loss, gradient norm each) from that state,
    and the parameters after them (saved likewise)."""
    from repro_torch.optim.adamw import AdamWConfig, global_norm
    train, tree = mods["train"], mods["tree"]
    batches = train_batches(mods, cfg, TRAIN_SEQ, dev, 1 + TRAIN_STEPS)
    params = mods["lm"].init_lm(cfg, 0, device=dev)
    loss, _, grads = train.loss_and_grads(params, cfg, batches[0])
    ref = {"loss": loss.item(), "grad_norm": global_norm(grads).item(),
           "grads": str(path / "grads.pt"), "params": str(path / "params.pt"),
           "ends": False}
    torch.save(leaf_ends(tree, grads, ends=False), ref["grads"])
    del params, grads
    state = train.init_state(cfg, 0, device=dev)
    step_fn = train.make_train_step(cfg, AdamWConfig(**TRAIN_OPT))
    ref["steps"] = []
    for batch in batches:
        state, m = step_fn(state, batch)
        ref["steps"].append([m["loss"].item(), m["grad_norm"].item()])
    torch.save(leaf_ends(tree, state["params"], ends=False), ref["params"])
    del state
    torch.cuda.empty_cache()
    return ref


def train_mesh_rank(rank, world, init_file, task_file, out_file):
    """One rank of the sharded-training phase (the target of a spawned
    process): joins the gloo group on the shared card and trains each run
    of TRAIN_MESHES; writes its numbers to ``out_file``; a failure raises
    (the process exits non-zero)."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs, tree
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels.flash_attention import flash_attention as fkern
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train
    from repro_torch.models import lm
    # as in the parent: the float matmuls in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mods = {"configs": configs, "tree": tree, "coll": coll, "lm": lm,
            "fkern": fkern, "fops": fops, "train": train}
    task = json.loads(Path(task_file).read_text())
    backend = launch_mesh.init_distributed("cuda", f"file://{init_file}",
                                           rank, world)
    try:
        runs = {}
        for arch, spec in TRAIN_MESHES:
            mesh = launch_mesh.make_mesh(spec, "cuda",
                                         module="repro_torch.launch.train")
            label = f"{arch} {spec}"
            runs[label] = train_mesh_run(torch, mods, mesh,
                                         train_mesh_cfg(mods, arch, spec),
                                         task[label])
        Path(out_file).write_text(json.dumps(
            {"rank": rank, "device": str(mesh.device), "backend": backend,
             "runs": runs}))
    finally:
        dist.destroy_process_group()


def branch_counts(fkern):
    """The flash launches by (kernel, mask branch) since the last reset."""
    return {f"{p}/{b}": c for (p, b), c in sorted(
        fkern.BRANCH_LAUNCHES.items())}


def train_mesh_run(torch, mods, mesh, cfg, ref):
    """This rank's part of one mesh run: the sharded loss and gradient on
    the first batch (the gradient gathered, whole or as :func:`leaf_ends`
    as ``ref["ends"]`` says, and on rank 0 held leaf by leaf to the
    single-device one, with the control), then a warm-up step and
    TRAIN_STEPS timed steps through ``make_train_step(..., mesh=)`` (the
    last one with synced collectives, for their time), launch counts by
    kernel and mask branch and the query/KV heads of every flash launch,
    memory, the replicated leaves' digests, and the parameters after the
    steps gathered likewise and (rank 0) held to the single-device
    ones."""
    import hashlib
    from repro_torch.optim.adamw import AdamWConfig, global_norm
    train, tree, coll = mods["train"], mods["tree"], mods["coll"]
    fkern, fops = mods["fkern"], mods["fops"]
    dev = mesh.device
    batches = train_batches(mods, cfg, train_seq(cfg), dev, 1 + TRAIN_STEPS)
    state = train.init_state(cfg, 0, device=dev, mesh=mesh)
    state_bytes = sum(t.nbytes for t in tree.leaves(state))
    template = train.param_template(cfg)
    heads = Counter()
    real = fops.flash_attention_cuda

    def recorded(q, k, v, *args):
        heads[f"{q.shape[2]}x{k.shape[2]}"] += 1
        return real(q, k, v, *args)

    grads_fn = train.sharded_loss_and_grads(cfg, mesh)
    reset_counts(fkern)
    with patched((fops, "flash_attention_cuda", recorded)):
        loss, _, grads = grads_fn(state["params"], batches[0])
    out = {"loss": loss.item(),
           "grad_norm": global_norm(grads, grads_fn.splits).item(),
           "grad_launches": read_counts(fkern),
           "grad_branches": branch_counts(fkern), "grad_heads": dict(heads),
           "state_bytes": state_bytes}
    got = gather_leaves(mods, grads, mesh, template, ref["ends"])
    del grads
    if mesh.rank == 0:
        out.update(leaf_gaps(torch, got, ref["grads"], dev))
    del got
    torch.cuda.empty_cache()

    step_fn = train.make_train_step(cfg, AdamWConfig(**TRAIN_OPT), mesh=mesh)
    state, m = step_fn(state, batches[0])                 # warm-up
    steps = [[m["loss"].item(), m["grad_norm"].item()]]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(fkern)
    coll.reset_collectives()
    heads.clear()
    step_s, coll_s = [], Counter()
    real_run = coll._run

    def synced(kind, t, fn):
        """A collective bracketed by device syncs, its host time kept."""
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = real_run(kind, t, fn)
        torch.cuda.synchronize(dev)
        coll_s[kind] += time.perf_counter() - t0
        return out

    for i, batch in enumerate(batches[1:]):
        last = i == TRAIN_STEPS - 1     # the last step: synced collectives
        with patched((fops, "flash_attention_cuda", recorded),
                     *([(coll, "_run", synced)] if last else [])):
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        steps.append([m["loss"].item(), m["grad_norm"].item()])
    split = dict(zip(("/".join(p) for p, _ in
                      tree.flatten_with_path(template)),
                     grads_fn.splits.split))
    out.update({
        "steps": steps, "step_s": step_s, "launches": read_counts(fkern),
        "branches": branch_counts(fkern),
        "heads": dict(heads), "collectives": dict(coll.COLLECTIVES),
        "collective_s": dict(coll_s),
        "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "resident_bytes": torch.cuda.memory_allocated(dev),
        "split_leaves": sum(split.values()), "leaves": len(split),
        "replicated": {
            "/".join(p): hashlib.sha256(
                t.detach().cpu().contiguous().view(torch.uint8).numpy()
            ).hexdigest()
            for p, t in tree.flatten_with_path(state["params"])
            if not split["/".join(p)]}})
    got = gather_leaves(mods, state["params"], mesh, template, ref["ends"])
    del state
    if mesh.rank == 0:
        out.update(param_gap(torch, got, ref["params"], dev))
    del got
    torch.cuda.empty_cache()
    return out


def gather_leaves(mods, local, mesh, template, ends):
    """Leaf name -> the whole leaf of a sharded tree (collective: every
    rank calls it); with ``ends``, a stacked leaf's first and last layer
    only (:func:`leaf_ends`)."""
    tree = mods["tree"]
    if ends:
        local = tree.unflatten_like(local, [
            t[[0, -1]] if path[0] in STACKS else t
            for path, t in tree.flatten_with_path(local)])
    whole = mods["train"].gather_state(local, mesh, template)
    return {"/".join(path): t for path, t in tree.flatten_with_path(whole)}


def leaf_gaps(torch, got, ref_file, dev):
    """The largest per-leaf gap of the gathered gradient ``got`` (leaf name
    -> tensor) to the single-device one in ``ref_file`` (over that leaf's
    largest magnitude), its leaf, and the control: the gap when one leaf's
    last half-block is lost."""
    refs = torch.load(ref_file, mmap=True, weights_only=True)
    gaps, control = {}, None
    for name, g in got.items():
        want = refs[name].to(dev)
        top = want.abs().max().clamp_min(1e-30)
        gaps[name] = ((g - want).abs().max() / top).item()
        if name == TRAIN_MESH_CONTROL:
            lost = g.clone()
            lost[..., lost.shape[-1] // 2:] = 0
            control = ((lost - want).abs().max() / top).item()
    return {"max_leaf_gap": max(gaps.values()),
            "worst_leaf": max(gaps, key=gaps.get), "control_gap": control,
            "leaves_compared": len(gaps)}


def param_gap(torch, got, ref_file, dev):
    """The largest absolute gap of the gathered parameters ``got`` to the
    single-device ones in ``ref_file``, and its leaf."""
    refs = torch.load(ref_file, mmap=True, weights_only=True)
    gaps = {name: (p - refs[name].to(dev)).abs().max().item()
            for name, p in got.items()}
    return {"param_gap": max(gaps.values()),
            "param_worst_leaf": max(gaps, key=gaps.get)}


def train_mesh_phase(torch, dev, mods, smi, family_refs):
    """Sharded training on the card: the gemma3-1b single-device
    references first, freed (the families' come from
    :func:`family_train_path`, ``family_refs``), then two ranks spawned on
    the one card over gloo, each training every run of TRAIN_MESHES
    (:func:`train_mesh_rank`); their numbers held to the references."""
    import multiprocessing
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="train_mesh_"))
    t0 = time.perf_counter()
    try:
        task = {}
        for arch, spec in TRAIN_MESHES:
            label = f"{arch} {spec}"
            if arch in family_refs:
                task[label] = family_refs[arch]
                continue
            path = work / f"ref_{spec.replace(',', 'x')}"
            path.mkdir()
            task[label] = train_reference(torch, dev, mods,
                                          train_mesh_cfg(mods, arch, spec),
                                          path)
        ref_s = time.perf_counter() - t0
        (work / "task.json").write_text(json.dumps(task))
        torch.cuda.empty_cache()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=train_mesh_rank, args=(
            r, MESH_RANKS, str(work / "init"), str(work / "task.json"),
            str(work / f"rank{r}.json"))) for r in range(MESH_RANKS)]
        t1 = time.perf_counter()
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + TRAIN_MESH_TIMEOUT_S
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"training mesh ranks exited with {codes} "
                                 "(a rank that failed prints its traceback "
                                 "above)")
        ranks = [json.loads((work / f"rank{r}.json").read_text())
                 for r in range(MESH_RANKS)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"card": smi, "reference_s": ref_s,
           "ranks_s": time.perf_counter() - t1, "references": task,
           "ranks": ranks}
    for arch, spec in TRAIN_MESHES:
        label = f"{arch} {spec}"
        check_train_mesh(label, spec, train_mesh_cfg(mods, arch, spec),
                         task[label], [r["runs"][label] for r in ranks], smi)
    return out


def check_train_mesh(label, spec, cfg, ref, runs, smi):
    """Hold one mesh run's ranks to the single-device reference and log
    their numbers: loss and gradient norm (the gradient pass and every
    step), the gathered gradient's largest leaf gap (rank 0) with its
    control, the parameters after the steps, the replicated leaves equal
    across ranks, each flash kernel once per attention layer and pass (an
    encoder-decoder's and a VLM's also by mask branch) at the expected
    query/KV heads: a rank's block of query heads on its block of KV heads
    where they divide, else on the one KV head the block reads."""
    dp, tp = map(int, spec.split(","))
    attn_layers = cfg.num_layers + cfg.encoder_layers
    kv = cfg.num_kv_heads // tp if cfg.num_kv_heads % tp == 0 else 1
    want_heads = {f"{cfg.num_heads // tp}x{kv}": attn_layers}
    want, want_branches = family_flash_launches(cfg)
    branches = None if cfg.name == "gemma3-1b" else {
        f"{p}/{b}": c for (p, b), c in sorted(want_branches.items())}
    rel = lambda a, b: abs(a - b) / abs(b)
    for r, run in enumerate(runs):
        pairs = [(run["loss"], ref["loss"], TRAIN_LOSS_REL),
                 (run["grad_norm"], ref["grad_norm"], TRAIN_GNORM_REL)]
        for (loss, gnorm), (loss_1, gnorm_1) in zip(run["steps"],
                                                     ref["steps"]):
            pairs += [(loss, loss_1, TRAIN_LOSS_REL),
                      (gnorm, gnorm_1, TRAIN_GNORM_REL)]
        bad = [(a, b, lim) for a, b, lim in pairs if rel(a, b) > lim]
        if bad or len(run["steps"]) != len(ref["steps"]) or any(
                run["launches"][k] != v * TRAIN_STEPS or
                run["grad_launches"][k] != v for k, v in want.items()) or \
                run["grad_heads"] != want_heads or run["heads"] != {
                    k: v * TRAIN_STEPS for k, v in want_heads.items()} or (
                    branches is not None and (
                        run["grad_branches"] != branches or
                        run["branches"] != {k: v * TRAIN_STEPS
                                            for k, v in branches.items()})):
            raise AssertionError(
                f"mesh {label} rank {r}: {bad} beyond their limits, launches "
                f"{run['launches']} (grad pass {run['grad_launches']}; "
                f"expected {want} per step), by branch {run['branches']} "
                f"(expected {branches}), heads {run['heads']} (expected "
                f"{want_heads} per step)")
    first = runs[0]
    if not first["max_leaf_gap"] <= TRAIN_LEAF_GAP_REL or \
            not first["control_gap"] > TRAIN_LEAF_GAP_REL or \
            not first["param_gap"] <= TRAIN_PARAM_ATOL:
        raise AssertionError(
            f"mesh {label}: largest gathered-gradient leaf gap "
            f"{first['max_leaf_gap']} ({first['worst_leaf']}; limit "
            f"{TRAIN_LEAF_GAP_REL}), control {first['control_gap']}; "
            f"parameters after the steps {first['param_gap']} "
            f"({first['param_worst_leaf']}; limit {TRAIN_PARAM_ATOL})")
    if any(run["replicated"] != first["replicated"] for run in runs):
        raise AssertionError(f"mesh {label}: replicated leaves differ "
                             "across ranks")
    what = (f"{cfg.encoder_layers} + {cfg.num_layers} layers"
            if cfg.encoder_layers else f"{cfg.num_layers} layers")
    for r, run in enumerate(runs):
        per_step = {k: v // TRAIN_STEPS for k, v in run["collectives"].items()}
        synced = run["step_s"][-1]
        coll_s = sum(run["collective_s"].values())
        log(f"training mesh {label} rank {r} ({what}, batch {TRAIN_BATCH} x "
            f"{train_seq(cfg)}"
            + (f" after {cfg.vision_tokens} patches" if cfg.vision_tokens
               else "")
            + f", gloo on one card; {smi}): step "
            f"{', '.join(f'{t * 1e3:.1f}' for t in run['step_s'][:-1])}"
            f" ms, the last with synced collectives {synced * 1e3:.1f} ms "
            f"of which collectives {coll_s * 1e3:.1f} ms "
            f"({coll_s / synced:.1%}); collectives per step {per_step}; "
            f"peak {run['peak_bytes'] / 2 ** 30:.3f} GiB, resident "
            f"{run['resident_bytes'] / 2 ** 30:.3f} GiB; "
            f"{run['split_leaves']} of {run['leaves']} leaves split; "
            f"flash launches per step {want} at heads {run['grad_heads']}"
            + (f", by branch {run['grad_branches']}" if branches else ""))
    peaks = sum(run["peak_bytes"] for run in runs)
    log(f"training mesh {label}: loss {first['loss']:.7f} vs one device "
        f"{ref['loss']:.7f}, gradient norm {first['grad_norm']:.7g} vs "
        f"{ref['grad_norm']:.7g}, largest gathered-gradient leaf gap "
        f"{first['max_leaf_gap']:.3g} over {first['leaves_compared']} "
        + ("leaves (the stacked ones at their first and last layer)"
           if ref["ends"] else "leaves")
        + f" ({first['worst_leaf']}; control, a lost half-block: "
        f"{first['control_gap']:.3g}); parameters after the steps within "
        f"{first['param_gap']:.3g} ({first['param_worst_leaf']}); step "
        "losses " + ", ".join(f"{a[0]:.5f}/{b[0]:.5f}" for a, b in
                              zip(first["steps"], ref["steps"]))
        + f" (mesh/one device); replicated leaves equal across ranks; sum "
        f"of the ranks' peaks {peaks / 2 ** 30:.3f} GiB of the card's 80")


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


# ---------------------------------------------------------------------------
# The front doors: the examples, and the dry-run
# ---------------------------------------------------------------------------
EXAMPLES = ROOT / "examples" / "torch"
SERVING_EXAMPLES = ("quickstart", "cnn_pim_inference", "serve_pim_lm",
                    "continuous_serving")
# train_lm at the size its docstring names for real hardware, cut to 50
# steps (the hard-coded checkpoint's step), then resumed to 60
FRONT_TRAIN = {"layers": 12, "d_model": 768, "batch": 32, "seq": 1024}
FRONT_DEVICE = "cuda"
FRONT_RESUME_REL = 1e-5
# the configs chip_smoke drives, for the dry-run's pod sweep
DRYRUN_ARCHS = ("hymba-1.5b", "mamba2-370m", "moonshot-v1-16b-a3b",
                "whisper-medium", "paligemma-3b", "qwen3-4b", "gemma3-1b")
DRYRUN_TIMEOUT_S = 900
DRYRUN_JOB = r"""
import json, sys, time
from repro_torch.launch import dryrun
archs = sys.argv[2].split(",")
t0 = time.perf_counter()
cells = [dryrun.run_cell(a, s, "pod", save=False, verbose=False)
         for a in archs for s in dryrun.SHAPES]
sweep_s = time.perf_counter() - t0
t0 = time.perf_counter()
mesh = dryrun.run_cell("paligemma-3b", "train_4k", "1,2", save=False,
                       verbose=False)
json.dump({"cells": cells, "sweep_s": sweep_s, "mesh_cell": mesh,
           "mesh_cell_s": time.perf_counter() - t0},
          open(sys.argv[1], "w"), default=str)
"""


def start_dryrun_job():
    """Start the dry-run sweep in a process of its own, on the CPU only
    (no card visible to it, one thread): it runs beside the card's phases
    and :func:`front_doors_phase` collects it. Returns (process, result
    file, log file)."""
    import os
    work = Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out, err = work / "dryrun.json", work / "dryrun.log"
    with open(err, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_JOB, str(out),
             ",".join(DRYRUN_ARCHS)], cwd=ROOT, env=env, stdout=f,
            stderr=subprocess.STDOUT)
    return proc, out, err


def load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(torch, name, argv, counters):
    """One example's ``main(argv)`` on the card, in-process, its output
    kept (and echoed): (result, output lines, launches, wall s)."""
    import contextlib
    import io
    mod = load_example(name)
    reset_counts(*counters)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = mod.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts(*counters).items() if v}
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  [{name}] {line}")
    return res, lines, launches, wall


def front_train(torch, mods, counters, smi):
    """``train_lm`` for 50 steps, then for 60 from the same directory: it
    resumes from step 50 and its first loss is the step-50 checkpoint's
    loss on the data's step-50 batch."""
    import dataclasses
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    from repro_torch.data.pipeline import DataConfig, LMDataIterator
    train = mods["train"]
    size = FRONT_TRAIN
    ck = Path(tempfile.mkdtemp(prefix="train_lm_"))
    try:
        args = ["--layers", str(size["layers"]), "--d-model",
                str(size["d_model"]), "--batch", str(size["batch"]),
                "--seq", str(size["seq"]), "--attn-backend", "cuda",
                "--device", FRONT_DEVICE, "--ckpt-dir", str(ck)]
        first, _, l1, w1 = run_example(torch, "train_lm",
                                       ["--steps", "50"] + args, counters)
        second, lines, l2, w2 = run_example(torch, "train_lm",
                                            ["--steps", "60"] + args,
                                            counters)
        if "[train] resumed from step 50" not in lines:
            raise AssertionError(f"train_lm did not resume from step 50: "
                                 f"{lines[:3]}")
        cfg = mods["configs"].get_config("gemma3-1b").reduced(
            num_layers=size["layers"], d_model=size["d_model"], vocab=512)
        cfg = dataclasses.replace(cfg, attn_backend="cuda")
        blank = train.init_state(cfg, 0, device=FRONT_DEVICE)
        state, step, extras = restore_checkpoint(str(ck), blank)
        it = LMDataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=size["seq"],
                                       global_batch=size["batch"]), cfg)
        it.restore(extras["data_step"])
        with torch.no_grad():
            _, m = train.lm_loss(state["params"], cfg, train.batch_to_device(
                next(it), FRONT_DEVICE))
        want = m["loss"].item()
        del state, blank
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    gap = abs(second["first_loss"] - want) / abs(want)
    log(f"front doors, train_lm (gemma3-1b reduced to {size['layers']} "
        f"layers, d_model {size['d_model']}, batch {size['batch']} x "
        f"{size['seq']}, attn cuda; {smi}): 50 steps {w1:.1f} s, "
        f"loss {first['first_loss']:.4f} -> {first['last_loss']:.4f}, B5 "
        f"{l1}; resumed at step {step} to 60 in {w2:.1f} s, first loss "
        f"{second['first_loss']:.6f} against the checkpoint's "
        f"{want:.6f} (rel {gap:.2g}), last {second['last_loss']:.4f}, B5 "
        f"{l2}")
    if step != 50 or not gap <= FRONT_RESUME_REL or \
            not second["first_loss"] < first["first_loss"] or \
            not all(l1.get(k, 0) > 0 and l2.get(k, 0) > 0
                    for k in FLASH_KERNELS):
        raise AssertionError(f"train_lm resume: step {step}, gap {gap}, "
                             f"losses {first} / {second}, B5 {l1} / {l2}")
    return {"first": first, "second": second, "first_s": w1,
            "second_s": w2, "first_launches": l1, "second_launches": l2,
            "checkpoint_loss": want, "resume_rel": gap}


def front_dryrun(job, train_mesh, smi):
    """Collect the dry-run job: every sweep cell ``ok`` or ``skipped``,
    and the 1x2 paligemma-3b cell's float32 state bytes per rank equal to
    each rank's real local state in phase 21 (full width and depth)."""
    proc, out, err = job
    t0 = time.perf_counter()
    try:
        code = proc.wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("the dry-run job did not end in "
                             f"{DRYRUN_TIMEOUT_S} s")
    waited = time.perf_counter() - t0
    text = err.read_text()
    if code != 0:
        raise AssertionError(f"the dry-run job exited with {code}: "
                             f"{text[-3000:]}")
    res = json.loads(out.read_text())
    shutil.rmtree(out.parent, ignore_errors=True)
    cells = res["cells"]
    status = Counter(c["status"] for c in cells)
    bad = [(c["arch"], c["shape"], c.get("error")) for c in cells
           if c["status"] not in ("ok", "skipped")]
    mesh = res["mesh_cell"]
    real = [r["runs"]["paligemma-3b 1,2"]["state_bytes"]
            for r in train_mesh["ranks"]]
    want = mesh.get("bytes_per_rank", {}).get("state_f32")
    log(f"front doors, dry-run (CPU only, beside the card's phases): "
        f"{len(cells)} pod cells of {len(DRYRUN_ARCHS)} configs in "
        f"{res['sweep_s']:.1f} s, {dict(status)}; waited {waited:.1f} s "
        "for it after the card's phases")
    for c in cells:
        if c["status"] == "ok":
            r = c["roofline"]
            log(f"  dryrun {c['arch']} x {c['shape']} x pod: bytes/rank "
                f"{c['bytes_per_rank']['total'] / 2 ** 30:.3f} GiB, flops "
                f"{c['flops']:.4g} ({c['flops_route']}), collectives "
                f"{c['collective_total']:.4g} B, compute "
                f"{r['compute_s'] * 1e3:.3f} ms, memory "
                f"{r['memory_s'] * 1e3:.3f} ms, collective "
                f"{r['collective_s'] * 1e3:.3f} ms (H100 rates)"
                + (f", {c['assumed']}" if "assumed" in c else ""))
    log(f"front doors, dry-run paligemma-3b x train_4k x 1,2 "
        f"({mesh['status']}, {res['mesh_cell_s']:.1f} s): float32 state "
        f"{want} bytes a rank; phase 21's ranks hold {real} ({smi})")
    if bad or mesh["status"] != "ok" or any(r != want for r in real):
        raise AssertionError(f"dry-run: failed cells {bad}, mesh cell "
                             f"{mesh.get('error')}, state bytes {want} "
                             f"against the ranks' {real}")
    return {"sweep_s": res["sweep_s"], "status": dict(status),
            "cells": cells, "mesh_cell": mesh, "ranks_state_bytes": real,
            "waited_s": waited}


def front_doors_phase(torch, mods, counters, job, train_mesh, smi):
    """Phase 22: the four serving examples at their default sizes on the
    card, ``train_lm`` with its resume, and the dry-run's results."""
    out = {"examples": {}}
    for name in SERVING_EXAMPLES:
        res, lines, launches, wall = run_example(
            torch, name, ["--device", FRONT_DEVICE], counters)
        b1 = launches.get("pim_matmul_fused", 0)
        b3 = launches.get("analog_fullscale", 0)
        b4 = launches.get("analog_readout", 0)
        log(f"front doors, {name} on the card ({smi}): {wall:.2f} s, B1 "
            f"{b1}, B3 {b3}, B4 {b4} launches")
        analog = name in ("quickstart", "cnn_pim_inference")
        if b1 == 0 or analog and (b3 == 0 or b4 == 0):
            raise AssertionError(f"{name}: launches {launches}")
        if name == "quickstart" and not (res["exact"] and res["twin"]):
            raise AssertionError("quickstart: exact-cuda differs from the "
                                 "integer oracle or exact-torch")
        if name == "cnn_pim_inference" and not \
                res["acc_pim"] >= res["acc_fp"] - 0.1:
            raise AssertionError(f"cnn_pim_inference: accuracies {res}")
        out["examples"][name] = {"wall_s": wall, "launches": launches,
                                 "lines": lines}
    out["train_lm"] = front_train(torch, mods, counters, smi)
    out["dryrun"] = front_dryrun(job, train_mesh, smi)
    return out


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

    # every plain version that runs on the card here (the SSD scan's
    # chunked form, the LM's float matmuls) runs in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    log(f"torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    dryrun_job = start_dryrun_job()
    try:
        return run_phases(torch, opts, smi, t_start, dryrun_job)
    finally:
        if dryrun_job[0].poll() is None:
            dryrun_job[0].kill()
            dryrun_job[0].wait()
        shutil.rmtree(dryrun_job[1].parent, ignore_errors=True)


def run_phases(torch, opts, smi, t_start, dryrun_job) -> int:
    from repro_torch import configs
    from repro_torch.benchmarks_impl import table2
    from repro_torch.core import pim, workloads
    from repro_torch.data import pipeline
    from repro_torch.kernels import runtime
    from repro_torch.kernels.act_quant import act_quant as qkern
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
    from repro_torch import engine, reliability, serving
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train
    from repro_torch.models import attention, cnn, lm, moe, ssm
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    runtime.build_all()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.1f} s (nvcc, sm_90a, one process per "
        "source)")
    sass = sass_check(runtime)
    marks = [("build", time.perf_counter())]   # each phase's end

    def mark(name):
        marks.append((name, time.perf_counter()))

    err = kernel_phase(torch, dev, kern, ref)
    analog_err, noisy, adc_rows = analog_kernel_phase(torch, dev, akern,
                                                      aref)
    err.update(analog_err)
    ssd_err, ssd_rows = ssd_kernel_phase(torch, dev, skern, sref)
    flash_err, flash_rows = flash_kernel_phase(torch, dev, fkern, fref)
    mark("kernel phases")
    quant = QuantCalls(pim)
    counters = (kern, akern, skern, fkern, qkern, quant)
    quant_on = lambda what: quant_rows(torch, qkern, pim, quant.take(),
                                       what)
    model = build_model(torch, dev, cnn, workloads, pipeline)
    path, run_request, exact_logits = main_path(torch, model, cnn, pim,
                                                counters)
    quant_shapes = {"resnet18 exact": quant_on("resnet18 exact")}
    log_latency("exact", path)
    profile = profile_request(torch, {"cnn": cnn, "pim": pim}, run_request,
                              PIM_KERNELS, "exact")
    rows = shape_numbers(torch, dev, kern, ref, path["shapes"])
    kernels = [kernel_entry("pim_matmul_fused", "fused", rows,
                            path["launches"], err,
                            routes=path["launches_by_route"]),
               kernel_entry("pim_matmul_int", "int", rows,
                            path["launches"], err),
               quant_entry(quant_shapes["resnet18 exact"], path["launches"],
                           "resnet18 exact")]

    quant.take()
    apath, run_analog = analog_path(torch, model, cnn, pim, counters,
                                    exact_logits)
    quant_shapes["resnet18 analog"] = quant_on("resnet18 analog")
    kernels.append(quant_entry(quant_shapes["resnet18 analog"],
                               apath["launches"], "resnet18 analog"))
    log_latency("analog", apath)
    aprofile = profile_request(torch, {"cnn": cnn, "pim": pim}, run_analog,
                               ANALOG_KERNELS, "analog")
    arows = analog_shape_numbers(torch, akern, aref, apath["shapes"],
                                 capture_analog_inputs(aops, run_analog))
    kernels += analog_entries(arows, apath, err)
    studies = study_phase(table2)
    mark("cnn paths and studies")

    mods = {"lm": lm, "serve": serve_mod, "pim": pim, "configs": configs,
            "attention": attention, "ssm": ssm, "ssd_kern": sops,
            "ssd_wrap": skern, "ssd_ref": sref, "pim_ops": pops,
            "pim_kern": kern,
            "pim_ref": ref}
    quant.take()
    hymba = hymba_path(torch, dev, mods, counters)
    quant_shapes["hymba-1.5b pim"] = quant_on("hymba-1.5b pim")
    kernels.append(quant_entry(quant_shapes["hymba-1.5b pim"],
                               hymba["launches"], "hymba-1.5b pim"))
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
    mark("hymba")
    entry = serve_entry_phase(torch, serve_mod, configs, counters)
    mamba2 = mamba2_path(torch, dev, mods, counters)
    mark("serve entry and mamba2")
    mods["moe"] = moe
    quant.take()
    moonshot = moonshot_path(torch, dev, mods, counters)
    quant_shapes["moonshot-v1-16b-a3b pim"] = quant_on(
        "moonshot-v1-16b-a3b pim")
    kernels.append(quant_entry(quant_shapes["moonshot-v1-16b-a3b pim"],
                               moonshot["launches"],
                               "moonshot-v1-16b-a3b pim"))
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
             f"per layer and step, {MOE_SERVE_LAYERS} of its 48 layers): "
             "sum over the prefill's "
             f"launches (wgmma route, device time: {b1['prefill_ms']:.3f} "
             f"ms, the mma.sync yardstick {b1['prefill_mma_sync_ms']:.3f} "
             f"ms, bound {b1['prefill_bound_ms']:.3f} ms) and the decode "
             "steps' (small-M route, device time with cold weights: "
             f"{b1['decode_ms']:.3f} ms, the tiled yardstick "
             f"{b1['decode_tiled_ms']:.3f} ms, bound "
             f"{b1['decode_bound_ms']:.3f} ms); library_ms covers the "
             "prefill shapes (torch._int_mm takes M > 16)")))
    mark("moonshot")
    families = {}
    for arch in FAMILIES:
        quant.take()
        families[arch] = family_serve_path(torch, dev, mods, counters, arch,
                                           smi)
        quant_shapes[f"{arch} pim"] = quant_on(f"{arch} pim")
        kernels.append(quant_entry(quant_shapes[f"{arch} pim"],
                                   families[arch]["launches"], f"{arch} pim"))
    mark("whisper and paligemma served")
    mods.update({"serving": serving, "engine": engine, "ckpt": ckpt,
                 "reliability": reliability, "analog_kern": akern})
    quant.take()
    qwen3, qwen3_cont, qwen3_rel, sanitized = qwen3_phases(
        torch, dev, mods, counters, smi)
    quant_shapes["qwen3-4b pim"] = quant_on("qwen3-4b pim")
    kernels.append(quant_entry(quant_shapes["qwen3-4b pim"],
                               qwen3_cont["launches"], "qwen3-4b pim"))
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
    rel_rows = rowsum_rows(torch, dev, kern, ref, qwen3_rel["shapes"])
    kernels.append(rowsum_entry(rel_rows, qwen3_rel, smi))
    rel_checks = reliability_checks(torch, dev, mods)
    mark("qwen3 and reliability")
    quant.take()
    mesh = mesh_phase(torch, dev, mods, qwen3_cont, families, smi)
    kernels += mesh_entries(mesh)
    mark("mesh")
    mods.update({"train": train, "flash_kern": fkern, "tree": tree})
    training = train_path(torch, dev, mods, counters)
    kernels += flash_entries(flash_rows, training["config"]["windows"],
                             training["launches"], flash_err)
    restart = restart_phase(train)
    mark("training and restart")
    ref_dir = Path(tempfile.mkdtemp(prefix="train_refs_"))
    try:
        families_trained = {
            arch: family_train_path(torch, dev, mods, counters, arch, smi,
                                    ref_dir)
            for arch in FAMILIES}
        mark("whisper and paligemma trained")
        train_mesh = train_mesh_phase(
            torch, dev, mods, smi, {arch: fam["reference"] for arch, fam
                                    in families_trained.items()})
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    mark("training mesh")
    front = front_doors_phase(torch, mods, counters, dryrun_job, train_mesh,
                              smi)
    mark("front doors")
    phase_s = {name: round(t - prev, 1) for (name, t), (_, prev) in
               zip(marks, [("start", t_start)] + marks[:-1])}
    phase_s["sanitize (in qwen3)"] = round(sanitized["seconds"], 1)
    log(f"phase seconds: {phase_s}")
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
             "families_served": families,
             "families_trained": families_trained,
             "qwen3_persist": qwen3, "qwen3_continuous": listed(qwen3_cont),
             "qwen3_shapes": q_rows,
             "qwen3_reliability": listed(qwen3_rel),
             "rowsum_shapes": rel_rows, "reliability_checks": rel_checks,
             "sanitize": sanitized,
             "mesh": mesh,
             "flash_shapes": flash_rows, "train": training,
             "restart": restart, "train_mesh": train_mesh,
             "front_doors": front, "phase_s": phase_s,
             "act_quant_shapes": quant_shapes,
             "kernels": kernels},
            indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
