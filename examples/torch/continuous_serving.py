"""Continuous-batching LM serving over the weight-stationary PIM engine,
on the PyTorch port (counterpart of ``examples/continuous_serving.py``).

Programs a reduced LM's projection weights onto an engine substrate once,
then streams a synthetic Poisson request trace — mixed arrival times,
prompt lengths, and generation lengths — through a fixed pool of decode
slots (``repro_torch/serving/``): prefill of newly admitted requests
interleaves with decode of in-flight ones, finished sequences free their
slots for the next arrival. The port runs its steps eagerly, so "compiled
once" counts the distinct step-input shapes, which fixed slot geometry
keeps at one each. On the card the plans run the PIM matmul kernel
(``exact-cuda``).

  PYTHONPATH=src python examples/torch/continuous_serving.py \\
      [--substrate exact-torch] [--requests 8] [--slots 3] [--device cpu]

Wall time on the card (NVIDIA H100 80GB HBM3, 700.00 W): 0.45 s for
``main()`` at its defaults in a process whose kernels were already built
(``chip_smoke.py`` phase 22); a fresh process first builds the kernels
with ``nvcc`` (about a minute).
"""
import argparse

from repro_torch.engine import available_substrates
from repro_torch.launch.serve import serve_continuous


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--substrate", default="exact-cuda",
                    choices=available_substrates(),
                    help="engine substrate for the programmed plans "
                         "(on CPU tensors exact-cuda runs its plain version)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--sanitize", action="store_true",
                    help="arm the runtime sanitizers: a host-read guard "
                         "around every decode step and the compile "
                         "counter (repro_torch.analysis.sanitize)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    res = serve_continuous(args.arch, num_slots=args.slots,
                           num_requests=args.requests, prompt_len=12, gen=8,
                           layers=2, d_model=64, pim=True,
                           pim_substrate=args.substrate, arrival_rate=0.5,
                           seed=0, sanitize=args.sanitize,
                           device=args.device)

    print(f"arch={res['arch']} (reduced 2L/64d), substrate="
          f"{res['pim_substrate']}: {res['num_requests']} requests through "
          f"{res['num_slots']} slots")
    print(f"  {res['prefills']} prefills interleaved with "
          f"{res['decode_steps']} decode steps "
          f"(compiled once: {res['prefill_traces']}/{res['decode_traces']} "
          "traces), mean slot occupancy "
          f"{res['mean_slot_occupancy']:.2f}")
    print(f"  {res['generated_tokens']} tokens at {res['tokens_per_s']:.1f} "
          f"tok/s wall-clock ({args.device})")
    print(f"  TTFT p50/p90 = {res['ttft_steps_p50']:.1f}/"
          f"{res['ttft_steps_p90']:.1f} steps, latency p50/p90 = "
          f"{res['latency_steps_p50']:.1f}/{res['latency_steps_p90']:.1f}")
    if args.sanitize:
        print(f"  sanitize: decode host-read guard armed, compiles "
              f"{res['sanitize']['compiles']}")
    print("\nper-request completions:")
    for r in res["requests"]:
        toks = " ".join(str(t) for t in r["tokens"].tolist())
        print(f"  req {r['id']}: arrival {r['arrival_step']:.1f}, prompt "
              f"{r['prompt_len']}, ttft {r['ttft_steps']:.1f}, "
              f"tokens [{toks}]")

    assert res["prefill_traces"] == 1 and res["decode_traces"] == 1, \
        "slot refills must not add step shapes"
    print("\nOPIMA hardware estimate for the aggregate trace:")
    for k in ("opima_latency_ms_per_token_batch", "opima_tokens_per_s",
              "opima_power_w"):
        print(f"  {k} = {res[k]:.4g}")
    return res


if __name__ == "__main__":
    main()
