"""Execution substrates for the PIM engine (counterpart of
``repro/engine/substrates.py``).

A substrate is one way of realizing the weight-stationary datapath: it
``program``s weights into a stationary plan once and drives activations
past it with ``matmul`` many times, registered under a string key so
models select behaviour by name.

Registered substrates:

  ``exact-cuda``   the bit-exact integer datapath through the hand-written
                   Hopper kernel with the fused dequant epilogue (the
                   default; alias ``exact-pallas``).
  ``exact-torch``  the same integer math in plain PyTorch — bit-identical
                   to ``exact-cuda``, with or without a bias (alias
                   ``exact-jnp``).
  ``analog``       the paper's physical readout model (per-WDM-chunk
                   photodetector sums, transmission noise, a shared
                   auto-ranged ADC, integer code accumulation) in plain
                   PyTorch, folded over chunk blocks.
  ``analog-cuda``  the same readout model through the two-pass
                   hand-written Hopper kernel, bias fused; bit-identical
                   to ``analog`` with ``rng=None`` (alias
                   ``analog-pallas``).
  ``emulate``      weight-quantization-only float matmul.

``rng`` is an optional CPU ``torch.Generator``; only the analog
substrates read it (transmission noise).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import pim


class Substrate:
    """Base execution substrate: program-once / drive-many.

    Subclasses set ``name`` (the registry key) and ``is_exact`` (whether
    ``matmul`` equals :func:`repro_torch.core.pim.reference_quantized_matmul`
    bit for bit) and implement ``_dense2d``. Plan-type dispatch and
    activation reshaping are shared here.
    """

    name: str = ""
    is_exact: bool = False
    # whether matmul runs the int32 bit-sliced datapath (operand-width
    # guarded); float-only routes like ``emulate`` set this False
    integer_datapath: bool = True

    # -- programming ------------------------------------------------------
    def stamp(self, cfg: pim.PimConfig) -> pim.PimConfig:
        """``cfg`` with this substrate recorded as the route."""
        return dataclasses.replace(cfg, substrate=self.name)

    def program(self, w: torch.Tensor, cfg: pim.PimConfig = pim.DEFAULT_PIM
                ) -> pim.DensePlan:
        """Program a (K, N) weight matrix into a stationary plan."""
        return pim.prepare_weights(w, self.stamp(cfg))

    def program_depthwise(self, w: torch.Tensor,
                          cfg: pim.PimConfig = pim.DEFAULT_PIM
                          ) -> pim.DepthwisePlan:
        """Program (K=kh*kw, C) depthwise filters, one column per channel."""
        return pim.prepare_depthwise_weights(w, self.stamp(cfg))

    # -- execution --------------------------------------------------------
    def matmul(self, x: torch.Tensor, plan: pim.Plan, *,
               cfg: Optional[pim.PimConfig] = None,
               bias: Optional[torch.Tensor] = None,
               rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """Dense plans take x (..., K) -> (..., N); depthwise plans take
        x (..., K, C) -> (..., C)."""
        cfg = plan.cfg if cfg is None else cfg
        if self.integer_datapath:
            pim._check_widths(cfg)
        if isinstance(plan, pim.DepthwisePlan):
            if bias is not None:
                raise ValueError(
                    "depthwise plans have no fused bias path; add the "
                    "bias to the engine.matmul result instead")
            return self._depthwise(x, plan, cfg)
        if not isinstance(plan, pim.DensePlan):
            raise TypeError(f"unsupported plan type {type(plan).__name__}")
        return self._dense_nd(x, plan, cfg, bias, rng)

    def _dense_nd(self, x: torch.Tensor, plan: pim.DensePlan,
                  cfg: pim.PimConfig, bias: Optional[torch.Tensor],
                  rng: Optional[torch.Generator]) -> torch.Tensor:
        orig_shape = tuple(x.shape)
        k = orig_shape[-1]
        if k != plan.k:
            raise ValueError(f"contraction mismatch {k} vs plan {plan.k}")
        out = self._dense2d(x.reshape(-1, k), plan, cfg, bias, rng)
        return out.reshape(orig_shape[:-1] + (plan.n,))

    def _dense2d(self, x2: torch.Tensor, plan: pim.DensePlan,
                 cfg: pim.PimConfig, bias: Optional[torch.Tensor],
                 rng: Optional[torch.Generator]) -> torch.Tensor:
        raise NotImplementedError

    def _depthwise(self, x: torch.Tensor, plan: pim.DepthwisePlan,
                   cfg: pim.PimConfig) -> torch.Tensor:
        # depthwise filters (K = kh*kw taps) fit below one WDM chunk, so
        # every substrate but ``emulate`` runs the exact per-channel math
        return pim.depthwise_exact_matmul(x, plan, cfg)


class ExactCudaSubstrate(Substrate):
    """Bit-exact integer datapath through the fused-epilogue CUDA kernel."""

    name = pim.EXACT_CUDA
    is_exact = True

    def _dense2d(self, x2, plan, cfg, bias, rng):
        return pim.exact_cuda_matmul2d(x2, plan, cfg, bias)


class ExactTorchSubstrate(Substrate):
    """Bit-exact integer datapath in plain PyTorch (the kernel's twin)."""

    name = pim.EXACT_TORCH
    is_exact = True

    def _dense2d(self, x2, plan, cfg, bias, rng):
        return pim.exact_torch_matmul2d(x2, plan, cfg, bias)


class AnalogSubstrate(Substrate):
    """Physical-readout model in plain PyTorch: PD chunk sums + noise +
    ADC quantization + integer code accumulation."""

    name = pim.ANALOG
    is_exact = False

    def _dense2d(self, x2, plan, cfg, bias, rng):
        return pim.analog_matmul2d(x2, plan, cfg, bias, rng)


class AnalogCudaSubstrate(Substrate):
    """The same readout model through the two-pass CUDA kernel. Plans are
    interchangeable with ``analog``; with ``rng=None`` the outputs are
    bit-identical."""

    name = pim.ANALOG_CUDA
    is_exact = False

    def _dense2d(self, x2, plan, cfg, bias, rng):
        return pim.analog_cuda_matmul2d(x2, plan, cfg, bias, rng)


class EmulateSubstrate(Substrate):
    """Weight-quantization-only emulation (float matmul on dequantized
    codes). Plans are programmed like every other substrate's, so a plan
    can be re-routed to an exact substrate with a cfg override."""

    name = pim.EMULATE
    is_exact = False
    integer_datapath = False

    def _dense2d(self, x2, plan, cfg, bias, rng):
        return pim.emulate_matmul2d(x2, plan, cfg, bias)

    def _depthwise(self, x, plan, cfg):
        return pim.depthwise_emulate_matmul(x, plan, cfg)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Substrate] = {}


def register_substrate(substrate: Substrate, *, name: Optional[str] = None
                       ) -> Substrate:
    """Register a substrate under ``name`` (default ``substrate.name``);
    re-registering a name replaces the previous entry."""
    key = name or substrate.name
    if not key:
        raise ValueError("substrate must have a non-empty name")
    _REGISTRY[key] = substrate
    return substrate


def get_substrate(name: str) -> Substrate:
    """Look up a substrate by registry key (the JAX package's names are
    accepted as aliases); unknown names raise ValueError listing what is
    available."""
    try:
        return _REGISTRY[pim.SUBSTRATE_ALIASES.get(name, name)]
    except KeyError:
        raise ValueError(
            f"unknown PIM substrate {name!r}; available: "
            f"{', '.join(available_substrates())}") from None


def available_substrates() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_substrate(ExactCudaSubstrate())
register_substrate(ExactTorchSubstrate())
register_substrate(AnalogSubstrate())
register_substrate(AnalogCudaSubstrate())
register_substrate(EmulateSubstrate())
