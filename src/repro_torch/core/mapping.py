"""CNN/GEMM → OPIMA subarray mapping model (paper §IV.D).

Computes, for every layer, how many PIM cycles the OPIMA organization needs,
honouring the paper's dataflow rules:

* Convolutions are *input-stationary*: feature-map rows live in subarray
  rows; kernel rows are driven through on MDL wavelengths. Accumulation
  across the kernel's kh rows happens by same-wavelength interference of
  the kh subarrays sharing a group readout bus, so an accumulation *chain*
  occupies kh subarrays and (kw · C_in/groups) wavelengths.
* Chains on the same group bus must use disjoint wavelength sets, and the
  active subarray row per group has ``subarray_grid`` subarrays, hence:
      chains/group = min( floor(C / λ_chain), floor(subarrays_row / kh) )
  — this is precisely why 1×1 kernels hurt (§V.C): λ_chain = C_in consumes
  the wavelength budget while kh = 1 leaves the row's subarrays idle, and
  there is no in-waveguide accumulation to amortize the readout.
* FC layers are *weight-stationary*: K is folded across ceil(K/C) subarrays
  of a chain (their partial sums interfere), N spreads across groups.
* Parameters wider than the 4-bit cell run (bits_w/4)·(bits_a/4) nibble
  passes (TDM, §IV.C.4).

The model returns cycle counts + per-layer utilization; the performance
model (perfmodel.py) turns them into seconds/joules with Table-I constants.

Copied unchanged from ``repro/core/mapping.py``:
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

from repro_torch.core.arch import DEFAULT_ARCH, OpimaArch
from repro_torch.core.workloads import ConvSpec, DenseSpec, LayerSpec


@dataclasses.dataclass(frozen=True)
class LayerMapping:
    name: str
    macs: int
    cycles: float                 # PIM cycles (all nibble passes included)
    utilization: float            # achieved / peak MAC lanes
    chains_per_group: int
    chain_depth: int              # subarrays interfering per chain (kh)
    lambda_per_chain: int         # wavelengths a chain occupies
    nibble_passes: int
    adc_conversions: float        # aggregation-unit conversions
    mdl_drives: float             # MDL DAC drive events (λ · cycles)
    cell_reads: float             # OPCM cell readouts (= MACs in practice)
    out_cells: int                # OPCM cells to write back (output fmap)
    writeback_rows: float         # row-granular OPCM write operations


def _nibble_passes(weight_bits: int, act_bits: int, cell_bits: int) -> int:
    wp = max(1, math.ceil(weight_bits / cell_bits))
    ap = max(1, math.ceil(act_bits / cell_bits))
    return wp * ap


def map_layer(layer: LayerSpec, arch: OpimaArch = DEFAULT_ARCH,
              weight_bits: int = 4, act_bits: int = 4) -> LayerMapping:
    C = arch.cols_per_subarray
    row_subarrays = arch.subarray_grid          # subarrays in the active row
    total_groups = arch.banks * arch.groups     # concurrently active groups
    passes = _nibble_passes(weight_bits, act_bits, arch.cell_bits)

    if isinstance(layer, ConvSpec):
        rf_row = layer.kw * layer.in_c_per_group  # λ/chain (1 kernel row)
        lam_chain = min(rf_row, C)
        depth = min(layer.kh, row_subarrays)
        chains = max(1, min(C // lam_chain if lam_chain < C else 1,
                            row_subarrays // depth))
        macs_per_cycle_group = chains * depth * lam_chain
        if layer.kh * layer.kw == 1:
            # §V.C: 1×1 kernels have no in-waveguide accumulation; additional
            # concurrent operations on the shared mode-reuse plumbing would
            # interfere with their (un-accumulated) results, so only one
            # group per bank can stream 1×1 results to the aggregation unit
            # at a time — OPIMA "loses a significant portion of its parallel
            # processing capabilities".
            total_groups = arch.banks
    else:
        assert isinstance(layer, DenseSpec)
        # weight-stationary: chain folds K across subarrays
        k = layer.in_features
        depth = min(max(1, math.ceil(k / C)), row_subarrays)
        lam_chain = min(k, C)
        chains = max(1, min(C // lam_chain if lam_chain < C else 1,
                            row_subarrays // depth))
        macs_per_cycle_group = chains * depth * lam_chain

    macs_per_cycle = macs_per_cycle_group * total_groups
    # λ-splits (rf_row > C) do not change throughput — each split still moves
    # lam_chain·depth MACs/cycle — so cycles follow from total MACs.
    base_cycles = layer.macs / macs_per_cycle
    cycles = base_cycles * passes
    utilization = macs_per_cycle / arch.peak_macs_per_cycle

    # readout/conversion event counts (per §IV.C.3-4):
    #  - every chain-wavelength pair produces one PD+ADC conversion per cycle
    adc = chains * lam_chain * total_groups * cycles
    #  - every lit wavelength is one MDL DAC drive per cycle
    mdl = chains * lam_chain * total_groups * cycles
    cell_reads = float(layer.macs) * passes

    cells_per_elem = max(1, math.ceil(act_bits / arch.cell_bits))
    out_cells = layer.out_elems * cells_per_elem
    writeback_rows = math.ceil(out_cells / C)

    return LayerMapping(
        name=layer.name, macs=layer.macs, cycles=cycles,
        utilization=utilization, chains_per_group=chains, chain_depth=depth,
        lambda_per_chain=lam_chain, nibble_passes=passes,
        adc_conversions=adc, mdl_drives=mdl, cell_reads=cell_reads,
        out_cells=out_cells, writeback_rows=writeback_rows)


def map_network(layers: Sequence[LayerSpec], arch: OpimaArch = DEFAULT_ARCH,
                weight_bits: int = 4, act_bits: int = 4) -> List[LayerMapping]:
    return [map_layer(l, arch, weight_bits, act_bits) for l in layers]
