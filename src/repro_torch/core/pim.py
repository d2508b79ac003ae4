"""The OPIMA PIM datapath math (counterpart of ``repro/core/pim.py``): the
operating point (:class:`PimConfig`), plans (weights programmed into
'OPCM'), programming, and the exact / analog / emulation arithmetic each
substrate runs. Dispatch lives in :mod:`repro_torch.engine`.

  1. Weights are programmed once: :func:`prepare_weights` quantizes per
     output channel, nibble-decomposes into int8 digit planes and pads
     them to the kernel's tile multiples and WDM-chunk boundaries — the
     JAX package's layout, so plans convert between the two packages.
  2. Activations are quantized per row at every call and decomposed the
     same way (on the card in one launch of the fused quantizer,
     ``csrc/act_quant.cu``).
  3. Every (act-plane, weight-plane) pair is one integer product over K.
  4. The aggregation unit shift-adds the planes and rescales; on
     ``exact-cuda`` this is the hand-written kernel's fused epilogue, bit
     for bit equal to ``exact-torch`` and :func:`reference_quantized_matmul`.

  5. The analog substrates model the paper's physical readout instead
     (``analog`` in plain PyTorch, ``analog-cuda`` through the two-pass
     hand-written kernel): per-WDM-chunk photodetector sums, optional
     transmission noise, a shared auto-ranged ADC and integer code
     accumulation; the two are bit-identical with ``rng=None``.

  6. MoE expert stacks are programmed as one :class:`ExpertStackedPlan`
     (every :class:`DensePlan` field stacked on a leading expert axis, the
     reference layout); the engine drives each expert's array with that
     expert's own math.

  7. ABFT verification (``verify != "off"``): programming records the
     plan's checksum column (:func:`repro_torch.reliability.abft.
     checksums`, for expert stacks one record per expert), and each
     verified matmul checks it (B1's int32 row-sums on ``exact-cuda``,
     the plain row-sums on ``exact-torch``, a tolerance band plus storage
     audits on the float routes) and reports the count to
     :mod:`repro_torch.reliability.abft`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.analysis import trace
from repro_torch.core.cell import DEFAULT_CELL
from repro_torch.kernels.act_quant import act_quant as act_kern
from repro_torch.kernels.analog_readout import ops as analog_ops
from repro_torch.kernels.analog_readout.ref import (analog_readout_fused_ref,
                                                    inv_half_levels)
from repro_torch.kernels.pim_matmul import ops as pim_ops
from repro_torch.kernels.pim_matmul.pim_matmul import kernel_tiles
from repro_torch.kernels.pim_matmul.ref import (pim_matmul_ref,
                                                plane_partials, rowsum_int32,
                                                shift_add, wrap_int32)
from repro_torch.kernels.runtime import on_cuda
from repro_torch.quant.nibbles import NIBBLE_BASE, num_nibbles, to_nibbles
from repro_torch.quant.quantize import QTensor, quantize

# Canonical substrate names (registry keys, see engine/substrates.py).
EXACT_CUDA = "exact-cuda"
EXACT_TORCH = "exact-torch"
ANALOG = "analog"
ANALOG_CUDA = "analog-cuda"
EMULATE = "emulate"
# The JAX package's names, accepted so that configs and plans carry over.
SUBSTRATE_ALIASES = {"exact-pallas": EXACT_CUDA, "exact-jnp": EXACT_TORCH,
                     "analog-pallas": ANALOG_CUDA}


@dataclasses.dataclass(frozen=True)
class PimConfig:
    """Operating point of the PIM engine; ``substrate`` names the route
    (``exact-cuda`` when ``None``). The reference's deprecated boolean
    route aliases and its Pallas ``interpret`` flag have no counterpart:
    the route is the substrate name, and the kernel/plain choice is the
    tensor's device."""
    weight_bits: int = 4          # paper baseline: 4b (one cell per weight)
    act_bits: int = 4
    cell_bits: int = 4            # OPCM MLC density
    adc_bits: int = 5             # aggregation-unit ADC resolution
    wdm_chunk: int = 8            # products summed in analog before one ADC
                                  # conversion (programming pads K to it)
    substrate: Optional[str] = None  # registry key (JAX names accepted)
    read_noise_sigma: float = 0.0  # relative transmission read noise; if 0
                                   # and an rng is given, the cell-implied one
    verify: str = "off"           # ABFT checksum policy: "off" | "sample"
                                  # | "always" (repro_torch.reliability.
                                  # abft); non-"off" at programming time
                                  # records the checksum column, at
                                  # execute time checks it
    abft_tag: Optional[str] = None  # violation-report tag (the plan's
                                    # tree path in a serving params tree;
                                    # repair keys on it)

    @property
    def weight_planes(self) -> int:
        return num_nibbles(self.weight_bits)

    @property
    def act_planes(self) -> int:
        return num_nibbles(self.act_bits)

    @property
    def resolved_substrate(self) -> str:
        """The registry key this config selects (JAX aliases resolved)."""
        if self.substrate is None:
            return EXACT_CUDA
        return SUBSTRATE_ALIASES.get(self.substrate, self.substrate)


DEFAULT_PIM = PimConfig()

# The cell model's implied read-noise sigma, evaluated once at import.
_IMPLIED_READ_NOISE_SIGMA = DEFAULT_CELL.level_noise_sigma()
_warned_noiseless_analog = False


# ---------------------------------------------------------------------------
# Plans — weights programmed into 'OPCM'
# ---------------------------------------------------------------------------
class Plan:
    """Marker base for programmed weights; ``plan.substrate`` names the
    execution route, so ``engine.matmul(x, plan)`` needs no flags."""

    cfg: PimConfig

    @property
    def substrate(self) -> str:
        return self.cfg.resolved_substrate

    def dequantized(self) -> torch.Tensor:
        """Float weights implied by the programmed codes (emulation)."""
        return self.values.to(torch.float32) * self.scale


@dataclasses.dataclass
class DensePlan(Plan):
    """A (K, N) weight matrix programmed as stationary nibble planes,
    pre-padded to the kernel's tile multiples (the reference layout)."""

    values: torch.Tensor         # int8 codes (K, N), unpadded
    scale: torch.Tensor          # f32 (1, N), unpadded
    planes: torch.Tensor         # int8 (Pw, Kp, Np), padded
    padded_scale: torch.Tensor   # f32 (1, Np): kernel-epilogue weight scale
    bits: int = 4                # logical weight bit width
    k: int = 0                   # logical contraction dim (planes[:, :k])
    n: int = 0                   # logical output dim (planes[..., :n])
    cfg: PimConfig = DEFAULT_PIM
    abft: Optional[dict] = None  # ABFT checksum record {"col_i32" (K,),
                                 # "col_f32" (K,), "scale_sum" ()} from
                                 # programming with verify != "off"
    shard: Optional["PlanShard"] = None  # mesh split (engine/mesh.py): the
                                 # tensor fields then hold this rank's
                                 # slice, while k and n stay global

    @property
    def shape(self):
        return (self.k, self.n)

    def to(self, device) -> "DensePlan":
        return dataclasses.replace(
            self, values=self.values.to(device), scale=self.scale.to(device),
            planes=self.planes.to(device),
            padded_scale=self.padded_scale.to(device),
            abft=None if self.abft is None else
            {k: v.to(device) for k, v in self.abft.items()})


def _slice_abft(abft: Optional[dict], sel) -> Optional[dict]:
    """An expert stack's record cut to ``sel`` of its expert axis."""
    return None if abft is None else {k: v[sel] for k, v in abft.items()}


@dataclasses.dataclass
class ExpertStackedPlan(Plan):
    """An (E, K, N) MoE expert stack programmed as E stationary arrays:
    ``dense`` is a :class:`DensePlan` whose tensor fields carry a leading
    expert axis (``values`` (E, K, N), ``scale`` (E, 1, N), ``planes``
    (E, Pw, Kp, Np), ``padded_scale`` (E, 1, Np)) while ``bits``, ``k``,
    ``n`` and ``cfg`` are shared: the reference's vmapped layout, so
    plans convert between the two packages. :meth:`expert` gives expert
    ``e``'s plan as views, its planes the contiguous (Pw, Kp, Np) block
    the kernel takes without a copy. A stack split over a mesh
    (``shard``, kind ``"expert"``) holds this rank's experts in ``dense``
    while ``num_experts`` stays the whole stack's; :meth:`expert` and
    :meth:`experts` index the experts it holds and give them unstamped
    (an expert is whole on the rank that holds it), so only whole stamped
    stacks reach the split executor."""

    dense: DensePlan             # fields stacked over a leading expert axis
    num_experts: int = 0
    shard: Optional["PlanShard"] = None  # mesh split (engine/mesh.py)

    @property
    def cfg(self) -> PimConfig:  # type: ignore[override]
        return self.dense.cfg

    @property
    def bits(self) -> int:
        return self.dense.bits

    @property
    def shape(self):
        return (self.num_experts, self.dense.k, self.dense.n)

    def dequantized(self) -> torch.Tensor:
        return self.dense.dequantized()

    def expert(self, e: int) -> DensePlan:
        """Expert ``e``'s plan: views of the stacked fields."""
        d = self.dense
        return dataclasses.replace(d, values=d.values[e], scale=d.scale[e],
                                   planes=d.planes[e],
                                   padded_scale=d.padded_scale[e],
                                   abft=_slice_abft(d.abft, e))

    def experts(self, lo: int, hi: int) -> "ExpertStackedPlan":
        """The stack of experts ``lo`` to ``hi - 1`` (views)."""
        d = self.dense
        return ExpertStackedPlan(
            dense=dataclasses.replace(
                d, values=d.values[lo:hi], scale=d.scale[lo:hi],
                planes=d.planes[lo:hi], padded_scale=d.padded_scale[lo:hi],
                abft=_slice_abft(d.abft, slice(lo, hi))),
            num_experts=hi - lo)

    def to(self, device) -> "ExpertStackedPlan":
        return dataclasses.replace(self, dense=self.dense.to(device))


@dataclasses.dataclass
class DepthwisePlan(Plan):
    """Per-channel planned weights for depthwise convolutions: each
    channel's (kh*kw,) filter is its own stationary column."""

    values: torch.Tensor         # int8 codes (K, C)
    scale: torch.Tensor          # f32 (1, C)
    planes: torch.Tensor         # int8 (Pw, K, C)
    bits: int = 4
    cfg: PimConfig = DEFAULT_PIM

    def to(self, device) -> "DepthwisePlan":
        return dataclasses.replace(
            self, values=self.values.to(device), scale=self.scale.to(device),
            planes=self.planes.to(device))


# ---------------------------------------------------------------------------
# Programming — the single place weight decomposition happens
# ---------------------------------------------------------------------------
def plan_from_qtensor(w_q: QTensor, cfg: PimConfig = DEFAULT_PIM
                      ) -> DensePlan:
    """Plan already-quantized (K, N) codes: nibble planes pre-padded to the
    kernel tile multiples and to a WDM-chunk boundary. Codes (E, K, N)
    with scales (E, 1, N) give the fields of an expert stack, each expert
    planned as a (K, N) matrix would be. With ``cfg.verify`` not "off"
    the plan carries its ABFT checksum record (one per expert); an
    unknown verify mode raises ``ValueError``."""
    if cfg.weight_bits != w_q.bits:
        # adopted codes define the weight width; the stamped cfg must agree
        cfg = dataclasses.replace(cfg, weight_bits=w_q.bits)
    lead = tuple(w_q.values.shape[:-2])
    k, n = w_q.values.shape[-2:]
    planes = to_nibbles(w_q.values, w_q.bits)        # (Pw, *lead, K, N)
    if lead:
        planes = planes.movedim(0, -3)               # (*lead, Pw, K, N)
    _, bn, bk = kernel_tiles(1, k, n)
    pad_k, pad_n = (-k) % bk, (-n) % bn
    chunk = min(cfg.wdm_chunk, k) if cfg.wdm_chunk > 0 else k
    pad_k += (-(k + pad_k)) % chunk
    if pad_k or pad_n:
        planes = F.pad(planes, (0, pad_n, 0, pad_k))
    padded_scale = F.pad(torch.broadcast_to(w_q.scale, lead + (1, n)),
                         (0, pad_n)).contiguous()
    abft = None
    if cfg.verify != "off":
        # imported here: the reliability package imports this module
        from repro_torch.reliability import abft as abft_mod
        if cfg.verify not in abft_mod.VERIFY_MODES:
            raise ValueError(f"unknown verify mode {cfg.verify!r}; "
                             f"expected one of {abft_mod.VERIFY_MODES}")
        abft = abft_mod.checksums(w_q.values, torch.broadcast_to(
            w_q.scale, lead + (1, n)))
    return DensePlan(values=w_q.values, scale=w_q.scale,
                     planes=planes.contiguous(), padded_scale=padded_scale,
                     bits=w_q.bits, k=k, n=n, cfg=cfg, abft=abft)


def prepare_weights(w: torch.Tensor, cfg: PimConfig = DEFAULT_PIM
                    ) -> DensePlan:
    """Program a (K, N) weight matrix: per-output-channel symmetric
    quantization + nibble decomposition + kernel pre-padding, once."""
    if w.dim() != 2:
        raise ValueError(f"prepare_weights expects (K, N), got {w.shape}")
    return plan_from_qtensor(quantize(w, bits=cfg.weight_bits, axis=(0,)),
                             cfg)


def prepare_expert_weights(w: torch.Tensor, cfg: PimConfig = DEFAULT_PIM
                           ) -> ExpertStackedPlan:
    """Program an (E, K, N) expert stack: one stationary array per expert,
    each quantized per output column, decomposed and padded as
    :func:`prepare_weights` does a (K, N) matrix (the reference vmaps
    ``prepare_weights``; the same per-column arithmetic runs here on the
    whole stack at once)."""
    if w.dim() != 3:
        raise ValueError(
            f"prepare_expert_weights expects (E, K, N), got {w.shape}")
    dense = plan_from_qtensor(quantize(w, bits=cfg.weight_bits, axis=(1,)),
                              cfg)
    return ExpertStackedPlan(dense=dense, num_experts=w.shape[0])


def prepare_depthwise_weights(w: torch.Tensor, cfg: PimConfig = DEFAULT_PIM
                              ) -> DepthwisePlan:
    """Program depthwise filters (K=kh*kw, C) with per-channel scales."""
    if w.dim() != 2:
        raise ValueError(
            f"prepare_depthwise_weights expects (K, C), got {w.shape}")
    w_q = quantize(w, bits=cfg.weight_bits, axis=(0,))
    return DepthwisePlan(values=w_q.values, scale=w_q.scale,
                         planes=to_nibbles(w_q.values, w_q.bits),
                         bits=w_q.bits, cfg=cfg)


# ---------------------------------------------------------------------------
# Exact math (bit-sliced integer datapath)
# ---------------------------------------------------------------------------
_plane_matmuls = plane_partials   # (Pa, M, K) x (Pw, K, N) -> (Pa, Pw, M, N)
_shift_add = shift_add            # sum_{d,e} 16^(d+e) partial, int32 wrap


def _check_widths(cfg: PimConfig) -> None:
    if cfg.weight_bits > 8 or cfg.act_bits > 8:
        raise NotImplementedError(
            "exact int32 shift-and-add supports operand widths <= 8 bits "
            "(the paper evaluates 4b and 8b); wider operands would need an "
            "int64/float accumulation path")


def _quantize_activations(x2: torch.Tensor, cfg: PimConfig,
                          width: Optional[int] = None):
    """Dynamic per-row activation quantization + nibble decomposition.
    Returns (QTensor, planes (Pa, M, K or width)): the ``act`` that the
    matmul functions below take instead of quantizing ``x2`` themselves
    (the engine quantizes a row block once for every expert it meets).

    Dispatch is by device, as B1's is. Rows on the card go through the
    fused kernel (``csrc/act_quant.cu``) in one launch, the fine span
    ``pim.quantize`` keyed ``"kernel"``: the planes are ``width`` wide
    when one is given (zero beyond K, so :func:`_pad_act_planes` has
    nothing left to do), up to 4 bits the codes are a view of the one
    plane, and rows the kernel does not take raise (no fallback). CPU
    rows run :func:`_quantize_plain` and leave the padding to
    :func:`_pad_act_planes`."""
    bits = cfg.act_bits
    if on_cuda(x2):
        with trace.fine("pim.quantize", "kernel"):
            values, scale, planes = act_kern.act_quant_cuda(x2, bits, width)
        return QTensor(values=values, scale=scale, bits=bits), planes
    return _quantize_plain(x2, bits)


def _quantize_plain(x2: torch.Tensor, bits: int):
    """The eager steps the fused kernel replaces, on any device: the fine
    spans ``pim.quantize`` keyed ``"plain"`` and ``pim.nibbles``, planes
    (Pa, M, K). The CPU route of :func:`_quantize_activations`, and what
    the card's tests hold the kernel to bit for bit."""
    with trace.fine("pim.quantize", "plain"):
        a_q = quantize(x2, bits=bits, axis=(1,))
    with trace.fine("pim.nibbles"):
        planes = to_nibbles(a_q.values, bits)
    return a_q, planes


def _pad_act_planes(a_planes: torch.Tensor, plan: DensePlan
                    ) -> torch.Tensor:
    """Pad activation planes out to the plan's pre-padded K (the per-call
    half of the padding contract), from their current width: planes
    already that wide come back as they are."""
    pad_k = plan.planes.shape[1] - a_planes.shape[-1]
    with trace.fine("pim.pad"):
        if pad_k > 0:
            a_planes = F.pad(a_planes, (0, pad_k))
    return a_planes


def _pad_bias(bias: Optional[torch.Tensor], plan: DensePlan
              ) -> Optional[torch.Tensor]:
    """An (N,) bias as a (1, Np) float32 row for the fused epilogue."""
    if bias is None:
        return None
    pad_n = plan.planes.shape[2] - plan.n
    return F.pad(bias.to(torch.float32).reshape(1, -1),
                 (0, pad_n)).contiguous()


# ---------------------------------------------------------------------------
# ABFT verification (repro_torch.reliability.abft does the checksum math;
# these helpers adapt it to each substrate's intermediates and post the
# count, which stays on the plan's device)
# ---------------------------------------------------------------------------
def _abft_report_exact(rowsum: torch.Tensor, a_values: torch.Tensor,
                       plan: DensePlan, cfg: PimConfig) -> None:
    """Exact-substrate check: int32 accumulator row-sums against the
    checksum-column matvec (bit-exact, wraparound-safe)."""
    from repro_torch.reliability import abft as abft_mod
    viol = abft_mod.int_violations(rowsum, a_values, plan.abft, plan.scale,
                                   mode=cfg.verify, tag=cfg.abft_tag)
    abft_mod.report(cfg.abft_tag, viol)


def _abft_report_float(out: torch.Tensor, expected: torch.Tensor,
                       extra_tol, plan: DensePlan, cfg: PimConfig) -> None:
    """Float-substrate check: banded output row-sums plus the exact plane/
    scale storage audits (which carry the deterministic detection)."""
    from repro_torch.reliability import abft as abft_mod
    out = out.to(torch.float32)
    # 1e-3 relative band absorbs float re-association across N <= 4096
    tol = extra_tol + 1e-3 * torch.abs(out).sum(dim=1) + 1e-6
    viol = abft_mod.float_violations(out.sum(dim=1), expected, tol,
                                     plan.planes, plan.abft, plan.scale,
                                     k=plan.k, mode=cfg.verify,
                                     tag=cfg.abft_tag)
    abft_mod.report(cfg.abft_tag, viol)


def _analog_rowsum_tolerance(a_q: QTensor, plan: DensePlan, cfg: PimConfig,
                             chunk: int, sigma: float) -> torch.Tensor:
    """Static upper bound on the analog readout's row-sum error: per-ADC
    rounding (half an LSB at the worst-case full scale chunk*15^2) plus a
    6-sigma transmission-noise margin, accumulated over chunks and plane
    pairs, scaled by the live dequantization scales. Deliberately loose:
    the exact storage audits do the fault detection; this band only flags
    gross runtime corruption the stores cannot see."""
    digit_max = float(NIBBLE_BASE - 1)
    pa = num_nibbles(cfg.act_bits)
    pw = plan.planes.shape[-3]
    s16 = float(sum(16 ** d for d in range(pa))
                * sum(16 ** e for e in range(pw)))
    kp = plan.planes.shape[-2]
    n_chunks = max(-(-kp // max(chunk, 1)), 1)
    lsb_bound = chunk * digit_max ** 2 * inv_half_levels(cfg.adc_bits)
    per_col = n_chunks * s16 * (0.5 * lsb_bound
                                + 6.0 * sigma * digit_max ** 2
                                * chunk ** 0.5)
    return a_q.scale[:, 0] * torch.abs(plan.scale).sum() * per_col


def _abft_report_analog(out: torch.Tensor, a_q: QTensor, plan: DensePlan,
                        cfg: PimConfig, chunk: int, sigma: float,
                        bias: Optional[torch.Tensor]) -> None:
    expected = a_q.scale[:, 0] * (
        a_q.values.to(torch.float32) @ plan.abft["col_f32"])
    if bias is not None:
        expected = expected + bias.to(torch.float32).sum()
    _abft_report_float(out, expected,
                       _analog_rowsum_tolerance(a_q, plan, cfg, chunk,
                                                sigma), plan, cfg)


def exact_torch_matmul2d(x2: torch.Tensor, plan: DensePlan, cfg: PimConfig,
                         bias: Optional[torch.Tensor] = None, act=None,
                         verify: bool = False) -> torch.Tensor:
    """``exact-torch`` substrate: the plain integer plane products +
    shift-and-add, dequantized in two float32 steps (counterpart of
    ``exact_jnp_matmul2d``); ``verify`` checks the accumulator's row-sums
    against the plan's checksum record."""
    a_q, a_planes = act or _quantize_activations(x2, cfg)
    w_planes = plan.planes[:, :plan.k, :plan.n]
    acc = pim_matmul_ref(a_planes, w_planes)
    if verify:
        _abft_report_exact(rowsum_int32(acc), a_q.values, plan, cfg)
    out = acc.to(torch.float32) * a_q.scale * plan.scale
    if bias is not None:
        out = out + bias.to(torch.float32).reshape(1, -1)
    return out


def exact_cuda_matmul2d(x2: torch.Tensor, plan: DensePlan, cfg: PimConfig,
                        bias: Optional[torch.Tensor] = None, act=None,
                        verify: bool = False) -> torch.Tensor:
    """``exact-cuda`` substrate: the hand-written kernel with the fused
    dequant epilogue (counterpart of ``exact_pallas_matmul2d``). With
    ``verify`` the same launch also returns the int32 accumulator
    row-sums (``want_rowsum``; padded columns hold zero planes, so the
    padded row-sum equals the logical one) for the ABFT check; ``out`` is
    the same either way. On CPU tensors the same call runs the kernel's
    plain version."""
    a_q, a_planes = act or _quantize_activations(x2, cfg,
                                                 plan.planes.shape[1])
    res = pim_ops.pim_matmul_fused(_pad_act_planes(a_planes, plan),
                                   plan.planes, a_q.scale,
                                   plan.padded_scale,
                                   bias=_pad_bias(bias, plan),
                                   want_rowsum=verify)
    if verify:
        res, rowsum = res
        _abft_report_exact(rowsum, a_q.values, plan, cfg)
    return res[:, :plan.n]


def emulate_matmul2d(x2: torch.Tensor, plan: DensePlan, cfg: PimConfig,
                     bias: Optional[torch.Tensor] = None,
                     verify: bool = False) -> torch.Tensor:
    """``emulate`` substrate: float matmul against the dequantized codes —
    weight programming only, no activation quantization."""
    out = x2.to(torch.float32) @ plan.dequantized()
    if bias is not None:
        out = out + bias.to(torch.float32).reshape(1, -1)
    if verify:
        expected = x2.to(torch.float32) @ plan.abft["col_f32"]
        if bias is not None:
            expected = expected + bias.to(torch.float32).sum()
        _abft_report_float(out, expected, 0.0, plan, cfg)
    return out


# ---------------------------------------------------------------------------
# Analog readout math
# ---------------------------------------------------------------------------
# The readout chain itself (chunked photodetector sums -> transmission
# noise -> shared auto-ranged ADC -> integer code accumulation ->
# shift-and-add -> dequant epilogue) lives in kernels/analog_readout/:
# ``ref.py`` is the plain version the ``analog`` substrate runs, and the
# two-pass CUDA kernel behind ``analog-cuda`` equals it bit for bit on the
# deterministic path. Both take the plans' pre-padded weight planes (K
# lands on a WDM-chunk boundary at programming time); the kernels take the
# activation planes unpadded, the plain version padded to the same K.
def _resolve_analog_sigma(cfg: PimConfig, rng: Optional[torch.Generator]
                          ) -> float:
    """The transmission-noise sigma an analog substrate models.

    An explicit ``read_noise_sigma > 0`` without an rng raises (the noise
    must not silently vanish); with ``read_noise_sigma == 0`` the cell
    model's implied sigma applies when an rng is given, and without one
    the model is the deterministic ADC-only transfer, with a
    once-per-process warning."""
    sigma = cfg.read_noise_sigma
    if sigma > 0.0 and rng is None:
        raise ValueError(
            "analog substrate with an explicit read_noise_sigma > 0 "
            "requires an rng (pass rng=, or leave read_noise_sigma=0 for "
            "the deterministic ADC-only readout)")
    if sigma == 0.0:
        global _warned_noiseless_analog
        if rng is None and not _warned_noiseless_analog:
            _warned_noiseless_analog = True
            warnings.warn(
                "analog readout without an rng models the deterministic "
                "transfer only (ADC quantization, no transmission noise); "
                "pass rng= for the noise study", stacklevel=3)
        sigma = _IMPLIED_READ_NOISE_SIGMA
    return sigma


def _analog_inputs(x2: torch.Tensor, plan: DensePlan, cfg: PimConfig,
                   rng: Optional[torch.Generator], act=None):
    """Shared analog-substrate prep: dynamic activation quantization (the
    planes unpadded, (Pa, M, K)), the WDM chunk length, the
    effective noise sigma (0 without an rng) and the noise seed, a host
    int drawn from ``rng`` (a CPU ``torch.Generator``; no device sync)."""
    a_q, a_planes = act or _quantize_activations(x2, cfg)
    # wdm_chunk <= 0 means one chunk spans all of K, as in programming
    chunk = min(cfg.wdm_chunk, plan.k) if cfg.wdm_chunk > 0 else plan.k
    sigma = _resolve_analog_sigma(cfg, rng)
    seed = None
    if rng is not None:
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng,
                                 device="cpu"))
    return a_q, a_planes, chunk, sigma if rng is not None else 0.0, seed


def analog_matmul2d(x2: torch.Tensor, plan: DensePlan, cfg: PimConfig,
                    bias: Optional[torch.Tensor] = None,
                    rng: Optional[torch.Generator] = None, act=None,
                    verify: bool = False) -> torch.Tensor:
    """``analog`` substrate: the plain readout model (the kernel's plain
    version, folded over chunk blocks); the bias is added after the
    slice."""
    a_q, a_planes, chunk, sigma, seed = _analog_inputs(x2, plan, cfg, rng,
                                                       act)
    out = analog_readout_fused_ref(
        _pad_act_planes(a_planes, plan), plan.planes, a_q.scale,
        plan.padded_scale, chunk, cfg.adc_bits, sigma=sigma,
        seed=seed)[:, :plan.n]
    if bias is not None:
        out = out + bias.to(torch.float32).reshape(1, -1)
    if verify:
        _abft_report_analog(out, a_q, plan, cfg, chunk, sigma, bias)
    return out


def analog_cuda_matmul2d(x2: torch.Tensor, plan: DensePlan, cfg: PimConfig,
                         bias: Optional[torch.Tensor] = None,
                         rng: Optional[torch.Generator] = None, act=None,
                         verify: bool = False) -> torch.Tensor:
    """``analog-cuda`` substrate: the two-pass hand-written kernel, bias
    fused (counterpart of ``analog_pallas_matmul2d``). Bit-identical to
    :func:`analog_matmul2d` for the same rng state, with or without a
    bias, up to the noise normals' transcendental ulps. The activation
    planes go in unpadded: the kernels take them zero beyond their K, so
    the plan's K padding costs no copy and no work. On CPU tensors the
    same call runs the plain version."""
    a_q, a_planes, chunk, sigma, seed = _analog_inputs(x2, plan, cfg, rng,
                                                       act)
    out = analog_ops.analog_matmul_fused(
        a_planes, plan.planes, a_q.scale, plan.padded_scale, seed,
        _pad_bias(bias, plan), chunk=chunk, adc_bits=cfg.adc_bits,
        sigma=sigma)
    out = out[:, :plan.n]
    if verify:
        _abft_report_analog(out, a_q, plan, cfg, chunk, sigma, bias)
    return out


# ---------------------------------------------------------------------------
# Depthwise (grouped-convolution) math
# ---------------------------------------------------------------------------
def depthwise_exact_matmul(x: torch.Tensor, plan: DepthwisePlan,
                           cfg: PimConfig) -> torch.Tensor:
    """Depthwise convolution through the bit-sliced engine: per channel,
    integer plane products over the K = kh*kw taps + shift-and-add,
    dequantized with per-(row, channel) act scales x per-channel weight
    scales. K is tiny, so the products run elementwise in int32 (CUDA has
    no integer einsum). x: (..., K, C) -> (..., C)."""
    orig_shape = tuple(x.shape)
    k, c = orig_shape[-2], orig_shape[-1]
    x3 = x.reshape(-1, k, c)
    a_q = quantize(x3, bits=cfg.act_bits, axis=(1,))       # scale (M, 1, C)
    a_planes = to_nibbles(a_q.values, cfg.act_bits)        # (Pa, M, K, C)
    w_planes = plan.planes.to(torch.int32)
    partials = torch.stack([torch.stack([
        (a_planes[d].to(torch.int32) * w_planes[e]).sum(dim=1)
        for e in range(w_planes.shape[0])])
        for d in range(a_planes.shape[0])])               # (Pa, Pw, M, C)
    acc = _shift_add(partials)                             # (M, C) int32
    out = acc.to(torch.float32) * a_q.scale[:, 0, :] * plan.scale
    return out.reshape(orig_shape[:-2] + (c,))


def depthwise_emulate_matmul(x: torch.Tensor, plan: DepthwisePlan,
                             cfg: PimConfig) -> torch.Tensor:
    """``emulate`` depthwise route: float contraction against the
    dequantized per-channel filters."""
    return torch.einsum("...kc,kc->...c", x.to(torch.float32),
                        plan.dequantized())


# ---------------------------------------------------------------------------
# Legacy entry points (dispatch through repro_torch.engine)
# ---------------------------------------------------------------------------
PlannedWeights = DensePlan
PlannedDepthwiseWeights = DepthwisePlan


def _coerce_plan(w_q: Union[DensePlan, QTensor], cfg: PimConfig
                 ) -> DensePlan:
    if isinstance(w_q, DensePlan):
        return w_q
    # Legacy QTensor callers: plan on the fly (decomposition per call).
    return plan_from_qtensor(w_q, cfg)


def pim_matmul(x: torch.Tensor, w_q: Union[DensePlan, QTensor],
               cfg: Optional[PimConfig] = None,
               rng: Optional[torch.Generator] = None,
               act_scale_axis: int = -1,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Matrix multiply through the OPIMA PIM datapath (legacy wrapper).

    Dispatches through the substrate registry in :mod:`repro_torch.engine`;
    the route is named by ``(cfg or plan.cfg).resolved_substrate`` (on a
    CUDA tensor ``exact-cuda`` launches the PIM matmul kernel and
    ``analog-cuda`` the two analog readout kernels). New code should call
    ``engine.matmul(x, plan)`` directly.

    Args:
      x: float activations, shape (..., K).
      w_q: planned weights (K, N) from :func:`prepare_weights` (a legacy
        :class:`QTensor` is planned on the fly).
      cfg: PIM operating point; defaults to the plan's own config, whose
        ``weight_bits`` are then adopted from the codes. An explicit cfg of
        another width trips ``engine.matmul``'s guard.
      rng: CPU ``torch.Generator`` for the analog substrates' read noise
        (``None`` -> deterministic ADC-only readout).
      act_scale_axis: axis for dynamic activation scales (per-row default;
        kept for the reference's signature, as there).
      bias: optional (N,) float bias, applied inside the kernel's fused
        epilogue on the kernel routes (after dequantization on all).

    Returns:
      float32 result of shape (..., N), de-quantized (+ bias).
    """
    if cfg is None:
        cfg = w_q.cfg if isinstance(w_q, Plan) else DEFAULT_PIM
        plan = _coerce_plan(w_q, cfg)
        if cfg.weight_bits != plan.bits:
            cfg = dataclasses.replace(cfg, weight_bits=plan.bits)
    else:
        plan = _coerce_plan(w_q, cfg)
    # imported here: the engine imports this module
    from repro_torch.engine import api as engine_api
    return engine_api.matmul(x, plan, cfg=cfg, bias=bias, rng=rng)


def pim_depthwise_matmul(x: torch.Tensor,
                         w_q: Union[DepthwisePlan, torch.Tensor],
                         cfg: Optional[PimConfig] = None) -> torch.Tensor:
    """Grouped (depthwise) convolution (legacy wrapper; see
    :func:`depthwise_exact_matmul`). x: (..., K, C) -> (..., C); float
    filters (K, C) are programmed on the fly."""
    if not isinstance(w_q, DepthwisePlan):
        w_q = prepare_depthwise_weights(w_q, cfg or DEFAULT_PIM)
    if cfg is None:
        cfg = w_q.cfg
    from repro_torch.engine import api as engine_api
    return engine_api.matmul(x, w_q, cfg=cfg)


def pim_linear(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None,
               cfg: PimConfig = DEFAULT_PIM,
               rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Float-weight convenience wrapper: plan on the fly + PIM matmul with
    the bias fused into the kernel epilogue."""
    return pim_matmul(x, prepare_weights(w, cfg), cfg, rng, bias=b)


def reference_quantized_matmul(x: torch.Tensor, w_q, cfg: PimConfig =
                               DEFAULT_PIM) -> torch.Tensor:
    """Oracle: the integer product of the quantized codes (no nibble
    decomposition), wrapped to int32 and dequantized. ``w_q`` is a
    :class:`DensePlan` or :class:`QTensor`. Exact substrates match this
    bit for bit."""
    orig_shape = tuple(x.shape)
    x2 = x.reshape(-1, orig_shape[-1])
    a_q = quantize(x2, bits=cfg.act_bits, axis=(1,))
    acc = wrap_int32((a_q.values.to(torch.float64)
                      @ w_q.values.to(torch.float64)).to(torch.int64))
    out = acc.to(torch.float32) * a_q.scale * w_q.scale
    return out.reshape(orig_shape[:-1] + (w_q.values.shape[-1],))
