"""Serve an LM with OPIMA-PIM-quantized weights on the PyTorch port
(counterpart of ``examples/serve_pim_lm.py``; beyond-paper extension: the
paper evaluates CNNs; the same weight-stationary PIM mapping covers
transformer serving). Batched prefill + greedy decode + OPIMA estimate;
on the card every programmed projection runs the PIM matmul kernel
(``exact-cuda``).

  PYTHONPATH=src python examples/torch/serve_pim_lm.py [--arch qwen2.5-3b]
  PYTHONPATH=src python examples/torch/serve_pim_lm.py --device cpu

Wall time on the card (NVIDIA H100 80GB HBM3, 700.00 W): 0.62 s for
``main()`` at its defaults in a process whose kernels were already built
(``chip_smoke.py`` phase 22); a fresh process first builds the kernels
with ``nvcc`` (about a minute).
"""
import argparse

from repro_torch.engine import available_substrates
from repro_torch.launch.serve import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--substrate", default="exact-cuda",
                    choices=available_substrates(),
                    help="engine substrate for the programmed plans")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    res = serve(args.arch, batch=args.batch, prompt_len=32, gen=16,
                layers=4, d_model=128, pim=True, pim_bits=4,
                pim_substrate=args.substrate, device=args.device)
    print(f"arch={args.arch} (reduced 4L/128d), batch={args.batch}, "
          f"substrate={res['pim_substrate']}")
    print(f"wall-clock: prefill {res['prefill_s']*1e3:.1f} ms, "
          f"decode {res['decode_s_per_token']*1e3:.1f} ms/token "
          f"({args.device})")
    print(f"generated tokens:\n{res['generated']}")
    print("\nOPIMA hardware estimate for this model's GEMMs "
          "(weight-stationary mapping, 4-bit cells):")
    for k in ("opima_latency_ms_per_token_batch",
              "opima_energy_mj_per_token_batch", "opima_power_w"):
        print(f"  {k} = {res[k]:.4g}")
    return res


if __name__ == "__main__":
    main()
