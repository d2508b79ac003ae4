#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--json PATH]

It needs a CUDA device; without one (or without the rest of the checkout)
it exits non-zero and prints no result. It imports neither JAX nor the JAX
package. Phases, each of which raises on failure:

1. the card (``nvidia-smi`` name and power limit) and the kernel build,
   from the sources in ``src/repro_torch/csrc``;
2. kernels: every variant of the PIM matmul kernel (fused, fused + bias,
   fused + row-sums, raw int32) at w4a4 and w8a8, on main-path shapes and
   a ragged one, against its plain PyTorch version on the card, bit for
   bit;
3. the main path: full-width ResNet18 (CIFAR-100, 32x32, random weights
   from seed 0) programmed once at w4a4 on ``exact-cuda``, then 4
   requests of 128 synthetic images through ``cnn_forward``; 21 kernel
   launches per request, logits bit-identical to ``exact-torch`` on the
   card; one request also at w8a8;
4. numbers: request latency and images/s, a torch.profiler breakdown of
   one request's device time by stage with the device's idle share, and
   per main-path kernel shape the kernel's time, launches, bound,
   plain-version time and a library yardstick (``torch._int_mm`` on one
   plane pair + the epilogue).

It prints a ``{"kernels": [...]}`` line, then the device line
``{"ok": true, "device": {...}}`` last. ``--json PATH`` also writes every
number of the run (per-shape timings, the profile) to ``PATH``.
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
BATCH = 128
REQUESTS = 4
CHECK_SHAPES = {                 # (M, K, N) as the kernel sees them
    "stage0": (131072, 1024, 64),
    "stage3": (2048, 4608, 512),
    "fc": (128, 512, 100),
    "ragged": (1000, 333, 77),
}
KERNEL_SOURCE = "src/repro_torch/csrc/pim_matmul.cu"
REPLACES = {
    "pim_matmul_fused": "src/repro/kernels/pim_matmul/pim_matmul.py:227",
    "pim_matmul_int": "src/repro/kernels/pim_matmul/pim_matmul.py:108",
}


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


def main_path(torch, dev, cnn, pim, kern, workloads, pipeline):
    """Full-width ResNet18 at w4a4 on exact-cuda: program once, answer
    REQUESTS batches; then the exact-torch and w8a8 checks."""
    layers = workloads.resnet18(100, 32)
    params = cnn.init_cnn(layers, torch.Generator().manual_seed(0),
                          device=dev)
    cfg4 = pim.PimConfig(weight_bits=4, act_bits=4, substrate="exact-cuda")
    t0 = time.perf_counter()
    plans = cnn.plan_cnn_weights(params, layers, cfg4)
    torch.cuda.synchronize()
    program_s = time.perf_counter() - t0
    requests = [torch.from_numpy(pipeline.synthetic_images(
        seed, BATCH, 32, 100)[0]).to(dev) for seed in range(REQUESTS)]
    fwd = lambda x, cfg, p: cnn.cnn_forward(params, layers, x, pim=cfg,
                                            plans=p)

    fwd(requests[0], cfg4, plans)                    # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launches()
    logits, lat_ms = [], []
    for x in requests:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits.append(fwd(x, cfg4, plans))
        end.record()
        end.synchronize()
        lat_ms.append(start.elapsed_time(end))
    launches = dict(kern.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    per_request = len(plans)
    if launches["pim_matmul_fused"] != per_request * REQUESTS:
        raise AssertionError(f"fused kernel launched "
                             f"{launches['pim_matmul_fused']} times, "
                             f"expected {per_request} per request")
    for out in logits:
        if tuple(out.shape) != (BATCH, 100) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"bad logits {tuple(out.shape)}")
    ref = fwd(requests[0], pim.PimConfig(weight_bits=4, act_bits=4,
                                         substrate="exact-torch"), plans)
    if not torch.equal(ref, logits[0]):
        raise AssertionError("exact-cuda logits differ from exact-torch")
    log(f"main path: {REQUESTS} requests x {BATCH} images, logits "
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

    shapes = Counter()
    for spec in layers:
        plan = plans[spec.name]
        rows = BATCH * (spec.out_h * spec.out_w
                        if hasattr(spec, "out_h") else 1)
        shapes[(rows, plan.planes.shape[1], plan.planes.shape[2])] += 1
    med = statistics.median(lat_ms)
    numbers = {
        "latency_ms": lat_ms, "latency_ms_median": med,
        "images_per_s": BATCH / (med / 1e3), "program_s": program_s,
        "peak_bytes": peak, "launches": launches,
        "launches_per_request": per_request, "shapes": shapes,
        "argmax_agreement_with_float": agree,
    }
    return numbers, lambda: fwd(requests[0], cfg4, plans)


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


PROFILED = (  # (module, attribute, range name) wrapped while profiling
    ("cnn", "_im2col", "im2col"),
    ("pim", "_quantize_activations", "quantize+nibbles"),
    ("pim", "_pad_act_planes", "pad activation planes"),
)


def profile_request(torch, modules, run):
    """Device time of one request by stage, and the device's idle share,
    from torch.profiler. The stages are named ranges wrapped around the
    port's functions for this run only, plus the PIM kernel by name;
    "other" is the rest of the busy time (relu, residual adds, pooling,
    means, bias padding, output allocation and slicing)."""
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
    stages["pim_matmul kernel"] = sum(
        e.time_range.elapsed_us() for e in device
        if "pim_matmul_kernel" in e.name)
    stages = {k: v / 1e3 for k, v in stages.items()}
    stages["other"] = busy / 1e3 - sum(stages.values())
    result = {"window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
              "device_idle_share": 1.0 - busy / window,
              "stages_ms": stages}
    log(f"profile of one request: device busy {busy / 1e3:.3f} ms of a "
        f"{window / 1e3:.3f} ms profiled window (idle share "
        f"{result['device_idle_share']:.3f}); by stage: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
    return result


def kernel_entry(name, prefix, rows, launches, err):
    """Per-request totals over the main path's launches of each shape."""
    tot = lambda key: sum(r[key] * r["launches_per_request"] for r in rows)
    lib_rows = [r for r in rows if r[f"{prefix}_library_ms"] is not None]
    bound_by = Counter()
    for r in rows:
        bound_by[r[f"{prefix}_bound_by"]] += \
            r[f"{prefix}_bound_ms"] * r["launches_per_request"]
    return {
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": err[name], "ms": tot(f"{prefix}_ms"),
        "plain_ms": tot(f"{prefix}_plain_ms"),
        "bound_ms": tot(f"{prefix}_bound_ms"),
        "bound_by": bound_by.most_common(1)[0][0],
        "library_ms": sum(r[f"{prefix}_library_ms"]
                          * r["launches_per_request"] for r in lib_rows)
        if lib_rows else None,
        "per": "one request (batch 128): sum over the 21 main-path layer "
               "shapes; library_ms covers the shapes torch._int_mm takes "
               f"({sum(r['launches_per_request'] for r in lib_rows)} of 21)",
    }


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
    from repro_torch.core import pim, workloads
    from repro_torch.data import pipeline
    from repro_torch.kernels import runtime
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

    t0 = time.perf_counter()
    runtime.build_all()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.1f} s (nvcc, sm_90a)")

    err = kernel_phase(torch, dev, kern, ref)
    path, run_request = main_path(torch, dev, cnn, pim, kern, workloads,
                                  pipeline)
    log(f"request latency: median {path['latency_ms_median']:.3f} ms "
        f"(each of {REQUESTS}: "
        + ", ".join(f"{t:.3f}" for t in path["latency_ms"])
        + f"), {path['images_per_s']:.1f} images/s, programming "
        f"{path['program_s']:.3f} s, peak device memory "
        f"{path['peak_bytes'] / 2 ** 30:.3f} GiB")
    profile = profile_request(
        torch, {"cnn": cnn, "pim": pim}, run_request)
    rows = shape_numbers(torch, dev, kern, ref, path["shapes"])
    kernels = [kernel_entry("pim_matmul_fused", "fused", rows,
                            path["launches"], err),
               kernel_entry("pim_matmul_int", "int", rows,
                            path["launches"], err)]

    if opts.json is not None:
        opts.json.parent.mkdir(parents=True, exist_ok=True)
        path = dict(path, shapes=[list(s) + [c] for s, c in
                                  path["shapes"].items()])
        opts.json.write_text(json.dumps(
            {"card": smi, "build_s": build_s, "main_path": path,
             "profile": profile, "shapes": rows, "kernels": kernels},
            indent=1))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
