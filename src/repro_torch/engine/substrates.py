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
substrates read it (transmission noise). An expert stack draws one seed
per expert from it (in expert order) and gives each expert a generator of
its own seeded with it, so expert ``e``'s noise depends only on ``rng``'s
state and ``e``; the reference splits a JAX key per expert instead, and
noise bits do not carry over between the packages anyway.

ABFT: a plan programmed with ``verify != "off"`` carries a checksum
record, and a dispatch whose config keeps verify on checks it
(:meth:`Substrate._verify`); an expert stack checks each expert against
its own slice of the record under the stack's one tag, as each lane of
the reference's vmap posts its own count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import pim
from repro_torch.engine import mesh as mesh_mod
from repro_torch.kernels.pim_matmul import ops as pim_ops
from repro_torch.kernels.pim_matmul.ref import pim_matmul_ref


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
    # whether ``_dense2d`` takes ``act=`` (the rows' codes, scales and
    # planes from ``pim._quantize_activations``) instead of quantizing
    shares_activation_codes: bool = False
    # the dense mesh splits (:mod:`repro_torch.engine.mesh`) this
    # substrate runs, bit for bit with one device where it is exact; every
    # substrate splits experts
    dense_splits: Tuple[str, ...] = ()

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

    def program_experts(self, w: torch.Tensor,
                        cfg: pim.PimConfig = pim.DEFAULT_PIM
                        ) -> pim.ExpertStackedPlan:
        """Program an (E, K, N) expert stack, one array per expert."""
        return pim.prepare_expert_weights(w, self.stamp(cfg))

    # -- execution --------------------------------------------------------
    def matmul(self, x: torch.Tensor, plan: pim.Plan, *,
               cfg: Optional[pim.PimConfig] = None,
               bias: Optional[torch.Tensor] = None,
               rng: Optional[torch.Generator] = None,
               paired: bool = False) -> torch.Tensor:
        """Dense plans take x (..., K) -> (..., N); depthwise plans take
        x (..., K, C) -> (..., C). Expert stacks broadcast x (..., K) to
        every expert -> (E, ..., N); with ``paired=True`` x carries a
        leading (E, ...) axis and expert e sees only x[e] (the MoE
        down-projection). A plan split over a mesh (``plan.shard``) runs
        its split executor (:mod:`repro_torch.engine.mesh`), which wraps
        this substrate's own math in the split's collective."""
        cfg = plan.cfg if cfg is None else cfg
        if self.integer_datapath:
            pim._check_widths(cfg)
        if getattr(plan, "shard", None) is not None:
            return mesh_mod.sharded_matmul(self, x, plan, cfg=cfg, bias=bias,
                                           rng=rng, paired=paired)
        if isinstance(plan, pim.ExpertStackedPlan):
            return self._experts(x, plan, cfg, bias, rng, paired)
        if paired:
            raise ValueError(
                "paired=True is only meaningful for ExpertStackedPlan, "
                f"got {type(plan).__name__}")
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

    def _experts(self, x: torch.Tensor, plan: pim.ExpertStackedPlan,
                 cfg: pim.PimConfig, bias: Optional[torch.Tensor],
                 rng: Optional[torch.Generator], paired: bool
                 ) -> torch.Tensor:
        """Each expert's own dense math, expert by expert (so the analog
        auto-range is per expert, as under the reference's vmap). Where
        the substrate quantizes activations, all rows are quantized in
        one pass and each expert takes its rows' codes: per-row codes do
        not depend on the other rows, so broadcast rows serve every
        expert and paired rows equal a per-expert quantization."""
        e, k, n = plan.shape
        if paired and (x.dim() < 2 or x.shape[0] != e):
            raise ValueError(f"paired expert input needs a leading ({e}, "
                             f"...) axis, got {tuple(x.shape)}")
        if x.shape[-1] != k:
            raise ValueError(f"contraction mismatch {x.shape[-1]} vs plan "
                             f"{k}")
        lead = tuple(x.shape[1:-1] if paired else x.shape[:-1])
        x2 = x.reshape(-1, k)
        rows = x2.shape[0] // e if paired else x2.shape[0]
        gens = [None] * e
        if rng is not None:
            seeds = torch.randint(0, 2 ** 31 - 1, (e,), generator=rng,
                                  device="cpu").tolist()
            gens = [torch.Generator().manual_seed(s) for s in seeds]
        act = pim._quantize_activations(x2, cfg) \
            if self.shares_activation_codes else None
        outs = []
        for i in range(e):   # plan.expert(i) carries its slice of the record
            sel = slice(i * rows, (i + 1) * rows) if paired else slice(None)
            shared = {}
            if act is not None:
                a_q, a_planes = act
                shared["act"] = act if not paired else (
                    dataclasses.replace(a_q, values=a_q.values[sel],
                                        scale=a_q.scale[sel]),
                    a_planes[:, sel].contiguous())
            outs.append(self._dense2d(x2[sel], plan.expert(i), cfg, bias,
                                      gens[i], **shared))
        return torch.stack(outs).reshape((e,) + lead + (n,))

    def _dense2d(self, x2: torch.Tensor, plan: pim.DensePlan,
                 cfg: pim.PimConfig, bias: Optional[torch.Tensor],
                 rng: Optional[torch.Generator]) -> torch.Tensor:
        raise NotImplementedError

    def _dense_int(self, a_planes: torch.Tensor,
                   w_planes: torch.Tensor) -> torch.Tensor:
        """The raw int32 contraction of (Pa, M, K) activation planes with
        (Pw, K, N) weight planes, no epilogue: a row split's partial.
        Only substrates whose ``dense_splits`` include ``"row"`` have
        one."""
        raise NotImplementedError(f"substrate {self.name!r} has no int32 "
                                  "contraction")

    @staticmethod
    def _verify(plan: pim.DensePlan, cfg: pim.PimConfig) -> bool:
        """Whether this dispatch runs ABFT checksum verification: the
        plan must carry a checksum record (programmed with ``cfg.verify
        != "off"``) and the executing config must not have switched it
        off."""
        return cfg.verify != "off" and getattr(plan, "abft", None) is not None

    def _depthwise(self, x: torch.Tensor, plan: pim.DepthwisePlan,
                   cfg: pim.PimConfig) -> torch.Tensor:
        # depthwise filters (K = kh*kw taps) fit below one WDM chunk, so
        # every substrate but ``emulate`` runs the exact per-channel math
        return pim.depthwise_exact_matmul(x, plan, cfg)


class ExactCudaSubstrate(Substrate):
    """Bit-exact integer datapath through the fused-epilogue CUDA kernel."""

    name = pim.EXACT_CUDA
    is_exact = True
    shares_activation_codes = True
    dense_splits = ("col", "row")

    def _dense2d(self, x2, plan, cfg, bias, rng, act=None):
        return pim.exact_cuda_matmul2d(x2, plan, cfg, bias, act,
                                   verify=self._verify(plan, cfg))

    def _dense_int(self, a_planes, w_planes):
        return pim_ops.pim_matmul_int(a_planes, w_planes)


class ExactTorchSubstrate(Substrate):
    """Bit-exact integer datapath in plain PyTorch (the kernel's twin)."""

    name = pim.EXACT_TORCH
    is_exact = True
    shares_activation_codes = True
    dense_splits = ("col", "row")

    def _dense2d(self, x2, plan, cfg, bias, rng, act=None):
        return pim.exact_torch_matmul2d(x2, plan, cfg, bias, act,
                                   verify=self._verify(plan, cfg))

    def _dense_int(self, a_planes, w_planes):
        return pim_matmul_ref(a_planes, w_planes)


class AnalogSubstrate(Substrate):
    """Physical-readout model in plain PyTorch: PD chunk sums + noise +
    ADC quantization + integer code accumulation."""

    name = pim.ANALOG
    is_exact = False
    shares_activation_codes = True

    def _dense2d(self, x2, plan, cfg, bias, rng, act=None):
        return pim.analog_matmul2d(x2, plan, cfg, bias, rng, act,
                                   verify=self._verify(plan, cfg))


class AnalogCudaSubstrate(Substrate):
    """The same readout model through the two-pass CUDA kernel. Plans are
    interchangeable with ``analog``; with ``rng=None`` the outputs are
    bit-identical."""

    name = pim.ANALOG_CUDA
    is_exact = False
    shares_activation_codes = True

    def _dense2d(self, x2, plan, cfg, bias, rng, act=None):
        return pim.analog_cuda_matmul2d(x2, plan, cfg, bias, rng, act,
                                        verify=self._verify(plan, cfg))


class EmulateSubstrate(Substrate):
    """Weight-quantization-only emulation (float matmul on dequantized
    codes). Plans are programmed like every other substrate's, so a plan
    can be re-routed to an exact substrate with a cfg override."""

    name = pim.EMULATE
    is_exact = False
    integer_datapath = False
    dense_splits = ("col",)    # a column block's float matmul may round
                               # differently from the whole's

    def _dense2d(self, x2, plan, cfg, bias, rng):
        return pim.emulate_matmul2d(x2, plan, cfg, bias,
                                    verify=self._verify(plan, cfg))

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
