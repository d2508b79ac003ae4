"""End-to-end training driver on the PyTorch port (counterpart of
``examples/train_lm.py``): train an assigned-architecture LM on the
synthetic token pipeline with checkpoint/restart and optional int8
gradient compression.

Reduced default:
  PYTHONPATH=src python examples/torch/train_lm.py               # card
  PYTHONPATH=src python examples/torch/train_lm.py --device cpu

The ~100M-parameter invocation used on real hardware, with the
flash-attention kernels' forward and backward:
  PYTHONPATH=src python examples/torch/train_lm.py --layers 12 \\
      --d-model 768 --steps 300 --batch 32 --seq 1024 --attn-backend cuda

A checkpoint is written every 50 steps; re-running the same command
resumes from the latest one.

Wall time on the card (NVIDIA H100 80GB HBM3, 700.00 W), at the
real-hardware size with ``--steps 50``: 37.8 s (0.76 s a step), and 12.8
s for the resumed run's 10 steps to 60, in a process whose kernels were
already built (``chip_smoke.py`` phase 22); a fresh process first builds
the kernels with ``nvcc`` (about a minute).
"""
import argparse

from repro_torch.launch.train import train_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--compress-bits", type=int, default=0)
    ap.add_argument("--attn-backend", default=None,
                    help="jnp or cuda (the flash-attention kernels); "
                         "default: the config's")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    res = train_loop(args.arch, steps=args.steps, batch=args.batch,
                     seq=args.seq, layers=args.layers, d_model=args.d_model,
                     ckpt_dir=args.ckpt_dir, ckpt_every=50,
                     compress_bits=args.compress_bits, device=args.device,
                     attn_backend=args.attn_backend)
    print(f"loss: {res['first_loss']:.4f} -> {res['last_loss']:.4f} "
          f"(re-run the same command to exercise checkpoint resume)")
    return res


if __name__ == "__main__":
    main()
