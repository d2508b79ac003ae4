#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--json PATH]

It needs a CUDA device; without one (or without the rest of the checkout)
it exits non-zero and prints no result. It imports neither JAX nor the JAX
package. Phases, each of which raises on failure:

1. the card (``nvidia-smi`` name and power limit) and the kernel build,
   from the sources in ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   all started together);
2. kernels: every variant of the PIM matmul kernel (fused, fused + bias,
   fused + row-sums, raw int32) at w4a4 and w8a8, on main-path shapes and
   a ragged one, against its plain PyTorch version on the card, bit for
   bit; then both passes of the analog readout kernel (full scale and
   readout, with and without a bias) at w4a4 and w8a8 on main-path shapes
   and a ragged one, with the (chunk, ADC bits) sweep on the ragged one,
   bit for bit on the deterministic path, and with noise within the
   tolerance stated at ``NOISY_SHARE``;
3. the exact path: full-width ResNet18 (CIFAR-100, 32x32, random weights
   from seed 0) programmed once at w4a4 on ``exact-cuda``, then 4
   requests of 128 synthetic images through ``cnn_forward``; 21 kernel
   launches per request, logits bit-identical to ``exact-torch`` on the
   card; one request also at w8a8;
4. numbers of the exact path: request latency and images/s, a
   torch.profiler breakdown of one request's device time by stage with
   the device's idle share, and per main-path kernel shape the kernel's
   time, launches, bound, plain-version time and a library yardstick
   (``torch._int_mm`` on one plane pair + the epilogue);
5. the analog path: the same network and requests programmed at w4a4
   with a 5-bit ADC on ``analog-cuda``; 21 launches of each analog pass
   per request and none of the PIM matmul kernel, logits bit-identical
   to the plain ``analog`` substrate on the card; one noisy request
   (CPU generator of seed 9, the cell model's implied sigma) that is
   finite, differs from the deterministic one and repeats bit for bit;
6. numbers of the analog path: latency, a profile with both analog
   kernels named, and per shape, on the inputs the path gave it, each
   pass's time, launches, bound and plain-version time;
7. the ADC ablation and Table II (``repro_torch.benchmarks_impl.table2``)
   on the card, printing their rows.

Each path's launch counts are set to 0 just before its requests and read
just after. It prints a ``{"kernels": [...]}`` line, then the device line
``{"ok": true, "device": {...}}`` last. ``--json PATH`` also writes every
number of the run (per-shape timings, the profiles, the study rows) to
``PATH``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15        # H100 SXM dense int8 tensor cores
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BATCH = 128
REQUESTS = 4
CHECK_SHAPES = {                 # (M, K, N) as the kernel sees them
    "stage0": (131072, 1024, 64),
    "stage3": (2048, 4608, 512),
    "fc": (128, 512, 100),
    "ragged": (1000, 333, 77),
}
KERNEL_SOURCE = "src/repro_torch/csrc/pim_matmul.cu"
ANALOG_SOURCE = "src/repro_torch/csrc/analog_readout.cu"
REPLACES = {
    "pim_matmul_fused": "src/repro/kernels/pim_matmul/pim_matmul.py:227",
    "pim_matmul_int": "src/repro/kernels/pim_matmul/pim_matmul.py:108",
    "analog_fullscale":
        "src/repro/kernels/analog_readout/analog_readout.py:263",
    "analog_readout":
        "src/repro/kernels/analog_readout/analog_readout.py:322",
}
# the analog kernels take K in whole WDM chunks (336 = 21 * 16)
ANALOG_CHECK_SHAPES = {**CHECK_SHAPES, "ragged": (1000, 336, 77)}
ANALOG_SWEEP = ((4, 3), (8, 5), (16, 8))   # (chunk, adc_bits) on "ragged"
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


def bound(pa, pw, m, k, n, out_bytes, extra_bytes):
    """Least time (ms) for one call: each input read once, each output
    written once, against HBM bandwidth; int8 ops against the tensor-core
    peak. Returns (ms, "bytes" | "operations")."""
    moved = pa * m * k + pw * k * n + out_bytes * m * n + extra_bytes
    ops = 2.0 * pa * pw * m * k * n
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def planes(torch, gen, p, rows, cols, dev):
    return torch.randint(-15, 16, (p, rows, cols), generator=gen,
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


def kernel_phase(torch, dev, kern, ref):
    """Every variant against the plain version, bit for bit."""
    err = {"pim_matmul_fused": 0.0, "pim_matmul_int": 0.0}
    gen = torch.Generator(device=dev).manual_seed(1)
    for label, (m, k, n) in CHECK_SHAPES.items():
        for pa, pw in ((1, 1), (2, 2)):
            a = planes(torch, gen, pa, m, k, dev)
            w = planes(torch, gen, pw, k, n, dev)
            a_s, w_s, bias = scales(torch, gen, m, n, dev)
            e = [max_err(torch, kern.pim_matmul_fused_cuda(a, w, a_s, w_s),
                         ref.pim_matmul_fused_ref(a, w, a_s, w_s)),
                 max_err(torch,
                         kern.pim_matmul_fused_cuda(a, w, a_s, w_s, bias),
                         ref.pim_matmul_fused_ref(a, w, a_s, w_s, bias))]
            out, rs = kern.pim_matmul_fused_cuda(a, w, a_s, w_s,
                                                 want_rowsum=True)
            ref_out, ref_rs = ref.pim_matmul_fused_ref(a, w, a_s, w_s,
                                                       want_rowsum=True)
            e += [max_err(torch, out, ref_out), max_err(torch, rs, ref_rs)]
            e_int = max_err(torch, kern.pim_matmul_cuda(a, w),
                            ref.pim_matmul_ref(a, w))
            err["pim_matmul_fused"] = max(err["pim_matmul_fused"], *e)
            err["pim_matmul_int"] = max(err["pim_matmul_int"], e_int)
            log(f"kernel check {label} M={m} K={k} N={n} w{4 * pw}a{4 * pa}"
                ": fused, fused+bias, fused+rowsum, int32 all bit-exact")
            del a, w, out, rs, ref_out, ref_rs
            torch.cuda.empty_cache()
    return err


def analog_kernel_phase(torch, dev, akern, aref):
    """Both analog passes against their plain versions: bit for bit on
    the deterministic path, within the NOISY_SHARE rule with noise."""
    err = {"analog_fullscale": 0.0, "analog_readout": 0.0}
    noisy = []
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, (m, k, n) in ANALOG_CHECK_SHAPES.items():
        for pa, pw in ((1, 1), (2, 2)):
            a = planes(torch, gen, pa, m, k, dev)
            w = planes(torch, gen, pw, k, n, dev)
            a_s, w_s, bias = scales(torch, gen, m, n, dev)
            sweep = ANALOG_SWEEP if label == "ragged" else ((8, 5),)
            for chunk, adc in sweep:
                fs = akern.analog_fullscale_cuda(a, w, chunk=chunk)
                ref_fs = aref.analog_fullscale_ref(a, w, chunk).reshape(1)
                err["analog_fullscale"] = max(err["analog_fullscale"],
                                              max_err(torch, fs, ref_fs))
                for b in (None, bias):
                    got = akern.analog_readout_cuda(
                        a, w, a_s, w_s, fs, chunk=chunk, adc_bits=adc,
                        bias=b)
                    want = aref.analog_readout_ref(a, w, a_s, w_s, ref_fs,
                                                   chunk, adc, bias=b)
                    err["analog_readout"] = max(err["analog_readout"],
                                                max_err(torch, got, want))
                log(f"analog check {label} M={m} K={k} N={n} "
                    f"w{4 * pw}a{4 * pa} chunk={chunk} adc={adc}b: full "
                    "scale, readout, readout+bias all bit-exact")
            if label in ("ragged", "stage3") and (label, pa) != ("stage3",
                                                                 2):
                noisy.append(noisy_check(torch, akern, aref, label, a, w,
                                         a_s, w_s, pa + pw - 1))
            del a, w
            torch.cuda.empty_cache()
    return err, noisy


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
    per_request = len(plans)
    if launches["pim_matmul_fused"] != per_request * REQUESTS or \
            launches["analog_fullscale"] or launches["analog_readout"]:
        raise AssertionError(f"exact path launches {launches}, expected "
                             f"{per_request} fused launches per request "
                             "and no analog launch")
    ref = fwd(requests[0], pim.PimConfig(weight_bits=4, act_bits=4,
                                         substrate="exact-torch"), plans)
    if not torch.equal(ref, logits[0]):
        raise AssertionError("exact-cuda logits differ from exact-torch")
    log(f"exact path: {REQUESTS} requests x {BATCH} images, logits "
        f"({BATCH}, 100) finite, {per_request} fused launches per request, "
        "w4a4 logits bit-identical to exact-torch")

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
        "launches_per_request": per_request,
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
    per_request = len(plans)
    if launches["analog_fullscale"] != per_request * REQUESTS or \
            launches["analog_readout"] != per_request * REQUESTS or \
            launches["pim_matmul_fused"] or launches["pim_matmul_int"]:
        raise AssertionError(f"analog path launches {launches}, expected "
                             f"{per_request} of each analog pass per "
                             "request and no PIM matmul launch")
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
        f"{per_request} analog_readout launches per request and no "
        "pim_matmul launch, logits bit-identical to analog; the noisy "
        "request (seed 9) repeats bit for bit; argmax agrees with "
        f"exact-cuda on {agree.item():.3f} of images deterministic, "
        f"{agree_noisy.item():.3f} noisy")
    med = statistics.median(lat_ms)
    numbers = {
        "latency_ms": lat_ms, "latency_ms_median": med,
        "images_per_s": BATCH / (med / 1e3), "peak_bytes": peak,
        "launches": launches, "launches_per_request": per_request,
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
    request, keyed like :func:`analog_shapes`: the per-shape numbers time
    the kernels on the data the main path gives them, whose share of zero
    chunk sums (ReLU zeros, padded K) the readout's time depends on."""
    seen = {}
    original = aops.analog_readout_cuda

    def recording(a, w, a_s, w_s, fs, *, chunk, **kw):
        seen.setdefault((a.shape[1], a.shape[2], w.shape[2], chunk),
                        (a, w, a_s, w_s, kw.get("bias")))
        return original(a, w, a_s, w_s, fs, chunk=chunk, **kw)

    aops.analog_readout_cuda = recording
    try:
        run()
    finally:
        aops.analog_readout_cuda = original
    return seen


def shape_numbers(torch, dev, kern, ref, shapes):
    """Per main-path shape: kernel, plain and library times beside the
    bound, at w4a4 (one plane pair), with the main path's bias."""
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for (m, k, n), count in sorted(shapes.items(), key=lambda s: -s[0][0]):
        a = planes(torch, gen, 1, m, k, dev)
        w = planes(torch, gen, 1, k, n, dev)
        a_s, w_s, bias = scales(torch, gen, m, n, dev)
        row = {"M": m, "K": k, "N": n, "launches_per_request": count}
        args = (a, w, a_s, w_s, bias)
        row["fused_ms"] = time_ms(
            torch, lambda: kern.pim_matmul_fused_cuda(*args))
        row["fused_plain_ms"] = time_ms(
            torch, lambda: ref.pim_matmul_fused_ref(*args))
        row["int_ms"] = time_ms(torch, lambda: kern.pim_matmul_cuda(a, w))
        row["int_plain_ms"] = time_ms(
            torch, lambda: ref.pim_matmul_ref(a, w))
        row["fused_bound_ms"], row["fused_bound_by"] = bound(
            1, 1, m, k, n, 4, 4 * m + 8 * n)
        row["int_bound_ms"], row["int_bound_by"] = bound(1, 1, m, k, n, 4, 0)
        # torch._int_mm takes M > 16 and K, N multiples of 8
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            lib_fused = lambda: torch._int_mm(a[0], w[0]).float() * a_s * \
                w_s + bias
            max_err(torch, lib_fused(),
                    kern.pim_matmul_fused_cuda(a, w, a_s, w_s, bias))
            row["fused_library_ms"] = time_ms(torch, lib_fused)
            row["int_library_ms"] = time_ms(
                torch, lambda: torch._int_mm(a[0], w[0]))
        else:
            row["fused_library_ms"] = row["int_library_ms"] = None
        rows.append(row)
        log(f"shape M={m} K={k} N={n} x{count}/request: fused "
            f"{row['fused_ms']:.4f} ms (bound {row['fused_bound_ms']:.4f} "
            f"ms by {row['fused_bound_by']}, plain "
            f"{row['fused_plain_ms']:.4f} ms, library "
            f"{row['fused_library_ms']}), int32 {row['int_ms']:.4f} ms")
        del a, w
        torch.cuda.empty_cache()
    return rows


def analog_bound(pa, pw, m, k, n, conversions, out_bytes, extra_bytes):
    """Least time (ms) for one analog pass, the largest of three floors:
    each input read once and each output written once at HBM bandwidth;
    the 2*Pa*Pw*M*K*N multiply-adds at the int8 tensor-core peak; and one
    CUDA-core operation per chunk sum the pass must range or convert at
    the float32 non-tensor peak. It is a floor: a conversion is an IEEE
    divide and a rounding, several operations, and the chunk sums are
    shorter than any int8 MMA. Returns (ms, "bytes" | "operations")."""
    moved = pa * m * k + pw * k * n + out_bytes * m * n + extra_bytes
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = max(2.0 * pa * pw * m * k * n / INT8_OPS_PER_S,
                conversions / FP32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def analog_shape_numbers(torch, akern, aref, shapes, inputs):
    """Per analog main-path shape, on the readout inputs the main path
    gave it (``inputs``, w4a4, 5-bit ADC, the layer's bias): each pass's
    time and its plain version's beside the bound. The ranging pass
    visits every chunk sum; the readout pass converts only the nonzero
    ones (a zero sum has code 0), counted on these inputs."""
    rows = []
    for (m, k, n, chunk), count in sorted(shapes.items(),
                                          key=lambda s: -s[0][0]):
        a, w, a_s, w_s, bias = inputs[(m, k, n, chunk)]
        pa, pw = a.shape[0], w.shape[0]
        fs = akern.analog_fullscale_cuda(a, w, chunk=chunk)
        nonzero = sum(int(torch.count_nonzero(sums)) for _, _, sums in
                      aref.chunk_sum_blocks(a, w, chunk))
        row = {"M": m, "K": k, "N": n, "chunk": chunk, "planes": [pa, pw],
               "launches_per_request": count,
               "zero_chunk_sum_share": 1.0 - nonzero / (pa * pw * m * n
                                                        * (k // chunk))}
        row["fullscale_ms"] = time_ms(
            torch, lambda: akern.analog_fullscale_cuda(a, w, chunk=chunk),
            budget_ms=150.0)
        row["fullscale_plain_ms"] = time_ms(
            torch, lambda: aref.analog_fullscale_ref(a, w, chunk),
            budget_ms=150.0)
        row["readout_ms"] = time_ms(
            torch, lambda: akern.analog_readout_cuda(
                a, w, a_s, w_s, fs, chunk=chunk, adc_bits=5, bias=bias),
            budget_ms=150.0)
        row["readout_plain_ms"] = time_ms(
            torch, lambda: aref.analog_readout_ref(
                a, w, a_s, w_s, fs, chunk, 5, bias=bias), budget_ms=150.0)
        row["fullscale_bound_ms"], row["fullscale_bound_by"] = analog_bound(
            pa, pw, m, k, n, pa * pw * m * n * (k // chunk), 0, 4)
        row["readout_bound_ms"], row["readout_bound_by"] = analog_bound(
            pa, pw, m, k, n, nonzero, 4, 4 * m + 8 * n + 4)
        row["fullscale_library_ms"] = row["readout_library_ms"] = None
        rows.append(row)
        log(f"analog shape M={m} K={k} N={n} chunk={chunk} x{count}/request"
            f" (zero chunk sums {row['zero_chunk_sum_share']:.3f}):"
            f" full scale {row['fullscale_ms']:.4f} ms (bound "
            f"{row['fullscale_bound_ms']:.4f} ms by "
            f"{row['fullscale_bound_by']}, plain "
            f"{row['fullscale_plain_ms']:.4f} ms), readout "
            f"{row['readout_ms']:.4f} ms (bound "
            f"{row['readout_bound_ms']:.4f} ms by "
            f"{row['readout_bound_by']}, plain "
            f"{row['readout_plain_ms']:.4f} ms)")
    return rows


PROFILED = (  # (module, attribute, range name) wrapped while profiling
    ("cnn", "_im2col", "im2col"),
    ("pim", "_quantize_activations", "quantize+nibbles"),
    ("pim", "_pad_act_planes", "pad activation planes"),
)


PIM_KERNELS = {"pim_matmul kernel": ("pim_matmul_kernel",)}
ANALOG_KERNELS = {  # demangled and mangled template names of each pass
    "analog_fullscale kernel": ("analog_kernel<false", "analog_kernelILb0"),
    "analog_readout kernel": ("analog_kernel<true", "analog_kernelILb1"),
}


def profile_request(torch, modules, run, kernels, what):
    """Device time of one request by stage, and the device's idle share,
    from torch.profiler. The stages are named ranges wrapped around the
    port's functions for this run only, plus each kernel of ``kernels``
    (label -> name fragments) by name; "other" is the rest of the busy
    time (relu, residual adds, pooling, means, bias padding, output
    allocation and slicing)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(fn, label):
        def wrapper(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    saved = [(modules[m], attr, getattr(modules[m], attr))
             for m, attr, _ in PROFILED]
    for (mod, attr, fn), (_, _, label) in zip(saved, PROFILED):
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
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
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
    stages = {}
    for avg in prof.key_averages():
        for _, _, label in PROFILED:
            if avg.key == label:
                stages[label] = getattr(avg, "device_time_total", None) \
                    or getattr(avg, "cuda_time_total", 0.0)
    for label, fragments in kernels.items():
        stages[label] = sum(e.time_range.elapsed_us() for e in device
                            if any(f in e.name for f in fragments))
        if not stages[label]:
            raise AssertionError(f"the profile of one {what} request shows "
                                 f"no {label}")
    stages = {k: v / 1e3 for k, v in stages.items()}
    stages["other"] = busy / 1e3 - sum(stages.values())
    result = {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
              "device_idle_share": 1.0 - busy / window,
              "stages_ms": stages}
    log(f"profile of one {what} request: device busy {busy / 1e3:.3f} ms "
        f"of a "
        f"{window / 1e3:.3f} ms profiled window (idle share "
        f"{result['device_idle_share']:.3f}); by stage: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
    return result


def kernel_entry(name, prefix, rows, launches, err, source=KERNEL_SOURCE,
                 per=None):
    """Per-request totals over the path's launches of each shape."""
    tot = lambda key: sum(r[key] * r["launches_per_request"] for r in rows)
    lib_rows = [r for r in rows if r[f"{prefix}_library_ms"] is not None]
    bound_by = Counter()
    for r in rows:
        bound_by[r[f"{prefix}_bound_by"]] += \
            r[f"{prefix}_bound_ms"] * r["launches_per_request"]
    return {
        "name": name, "route": "cuda", "source": source,
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
            "shapes; library_ms covers the shapes torch._int_mm takes "
            f"({sum(r['launches_per_request'] for r in lib_rows)} of 21)"),
    }


ANALOG_PER = ("one analog-path request (batch 128, w4a4, 5-bit ADC): sum "
              "over the 21 layer shapes, each timed on the inputs the "
              "path gave it; library_ms is null because no "
              "single PyTorch call computes the per-chunk ADC readout chain "
              "(chunk sums, shared full scale, per-chunk rounding, code "
              "sums)")


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
    from repro_torch.benchmarks_impl import table2
    from repro_torch.core import pim, workloads
    from repro_torch.data import pipeline
    from repro_torch.kernels import runtime
    from repro_torch.kernels.analog_readout import analog_readout as akern
    from repro_torch.kernels.analog_readout import ops as aops
    from repro_torch.kernels.analog_readout import ref as aref
    from repro_torch.kernels.pim_matmul import pim_matmul as kern
    from repro_torch.kernels.pim_matmul import ref
    from repro_torch.models import cnn

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

    err = kernel_phase(torch, dev, kern, ref)
    analog_err, noisy = analog_kernel_phase(torch, dev, akern, aref)
    err.update(analog_err)
    counters = (kern, akern)
    model = build_model(torch, dev, cnn, workloads, pipeline)
    path, run_request, exact_logits = main_path(torch, model, cnn, pim,
                                                counters)
    log_latency("exact", path)
    profile = profile_request(torch, {"cnn": cnn, "pim": pim}, run_request,
                              PIM_KERNELS, "exact")
    rows = shape_numbers(torch, dev, kern, ref, path["shapes"])
    kernels = [kernel_entry("pim_matmul_fused", "fused", rows,
                            path["launches"], err),
               kernel_entry("pim_matmul_int", "int", rows,
                            path["launches"], err)]

    apath, run_analog = analog_path(torch, model, cnn, pim, counters,
                                    exact_logits)
    log_latency("analog", apath)
    aprofile = profile_request(torch, {"cnn": cnn, "pim": pim}, run_analog,
                               ANALOG_KERNELS, "analog")
    arows = analog_shape_numbers(torch, akern, aref, apath["shapes"],
                                 capture_analog_inputs(aops, run_analog))
    kernels += [kernel_entry(name, prefix, arows, apath["launches"], err,
                             source=ANALOG_SOURCE, per=ANALOG_PER)
                for name, prefix in (("analog_fullscale", "fullscale"),
                                     ("analog_readout", "readout"))]
    studies = study_phase(table2)
    log(f"command time after the card query: "
        f"{time.perf_counter() - t_start:.1f} s")

    if opts.json is not None:
        opts.json.parent.mkdir(parents=True, exist_ok=True)
        listed = lambda p: dict(p, shapes=[list(s) + [c] for s, c in
                                           p["shapes"].items()])
        opts.json.write_text(json.dumps(
            {"card": smi, "build_s": build_s, "main_path": listed(path),
             "profile": profile, "shapes": rows,
             "analog_path": listed(apath), "analog_profile": aprofile,
             "analog_shapes": arows, "analog_noisy_checks": noisy,
             "studies": studies, "kernels": kernels}, indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
