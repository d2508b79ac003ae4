"""OPIMA analytical performance / energy / power model (paper §V).

Implements the paper's "Python-based performance analyzer": takes layer
mappings (cycle/event counts from mapping.py) and Table-I device constants,
and produces:

  * latency split into processing vs writeback (Fig. 9),
  * power breakdown (Fig. 8; 55.9 W max, MDL + E-O interface dominant),
  * subarray-group design-space trade-off (Fig. 7; 16 groups optimum),
  * per-inference energy, EPB and FPS/W (Figs. 11–12 inputs).

All Table-I numbers are carried verbatim. Two operating-point constants
(PIM cycle rate, OPCM row write time) are calibration values documented in
OpimaArch — the paper's figures are images, so absolute latency scale is
pinned by these while every *relative* claim (writeback dominance, 1×1
penalty, ratio studies) follows from the model structure.

Copied unchanged from ``repro/core/perfmodel.py``:
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

from repro_torch.core.arch import DEFAULT_ARCH, OpimaArch
from repro_torch.core.mapping import LayerMapping, map_network
from repro_torch.core.workloads import LayerSpec

# ---------------------------------------------------------------------------
# Table I constants (verbatim)
# ---------------------------------------------------------------------------
LOSS_DB = {
    "directional_coupler": 0.02,
    "mr_drop": 0.5,
    "mr_through": 0.02,
    "propagation_per_cm": 0.1,
    "bending_per_90": 0.01,
    "eo_mr_drop": 1.6,
    "eo_mr_through": 0.33,
    "soa_gain": -20.0,            # gain, recorded as negative loss
}

ENERGY = {
    "opcm_read_j": 5e-12,         # per cell read
    "opcm_write_j": 250e-12,      # per cell write
    "epcm_write_j": 860e-9,       # (baseline platforms use this)
    "dram_access_j_per_bit": 20e-12,
    "adc_j_per_step": 24.4e-15,   # per conversion step
    "dac_j_per_bit": 2.0e-12,
}

# Power model calibration (Fig. 8: 55.9 W max, MDL + E-O interface dominate;
# Fig. 7: MAC/W optimum at 16 groups). P(G) = P_static + a·G + b·G^1.5 with
# the optimum condition P_static = 0.5·b·G*^1.5 at G* = 16.
POWER_STATIC_W = 9.9          # external laser + control + SOA bias
POWER_PER_GROUP_W = 1.6375    # MDL arrays + EO tuning per active group-quad
POWER_GROUP_INTERFACE_EXP = 1.5
POWER_GROUP_INTERFACE_W = POWER_STATIC_W / 32.0   # aggregation/demux scaling


def total_power_w(arch: OpimaArch = DEFAULT_ARCH,
                  groups: int | None = None) -> float:
    g = arch.groups if groups is None else groups
    return (POWER_STATIC_W + POWER_PER_GROUP_W * g +
            POWER_GROUP_INTERFACE_W * g ** POWER_GROUP_INTERFACE_EXP)


def power_breakdown_w(arch: OpimaArch = DEFAULT_ARCH) -> Dict[str, float]:
    """Fig. 8 decomposition at the full operating point (PIM + memory)."""
    g = arch.groups
    group_linear = POWER_PER_GROUP_W * g
    interface = POWER_GROUP_INTERFACE_W * g ** POWER_GROUP_INTERFACE_EXP
    # split the linear group term: MDL arrays dominate, EO-tuned access MRs
    # and SOAs take smaller shares (paper: MDL + E-O interface dominate)
    return {
        "mdl_array": 0.72 * group_linear,
        "eo_interface": 0.28 * group_linear + 0.80 * interface,
        "aggregation": 0.20 * interface,
        "external_laser": 0.55 * POWER_STATIC_W,
        "soa": 0.25 * POWER_STATIC_W,
        "control": 0.20 * POWER_STATIC_W,
    }


@dataclasses.dataclass(frozen=True)
class LayerPerf:
    name: str
    macs: int
    processing_s: float
    writeback_s: float
    processing_j: float
    writeback_j: float
    utilization: float

    @property
    def latency_s(self) -> float:
        return self.processing_s + self.writeback_s

    @property
    def energy_j(self) -> float:
        return self.processing_j + self.writeback_j


@dataclasses.dataclass(frozen=True)
class NetworkPerf:
    name: str
    layers: List[LayerPerf]
    weight_bits: int
    act_bits: int

    @property
    def processing_s(self) -> float:
        return sum(l.processing_s for l in self.layers)

    @property
    def writeback_s(self) -> float:
        return sum(l.writeback_s for l in self.layers)

    @property
    def latency_s(self) -> float:
        return self.processing_s + self.writeback_s

    @property
    def energy_j(self) -> float:
        return sum(l.energy_j for l in self.layers)

    @property
    def macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def fps(self) -> float:
        return 1.0 / self.latency_s

    @property
    def avg_power_w(self) -> float:
        return self.energy_j / self.latency_s

    def fps_per_watt(self, arch: OpimaArch = DEFAULT_ARCH) -> float:
        # throughput efficiency against the architecture's operating power
        return self.fps / total_power_w(arch)

    @property
    def moved_bits(self) -> float:
        """Bits that cross a memory interface per inference. For OPIMA that
        is only the written-back output feature maps (weight reads and input
        accesses are in-situ — the PIM argument)."""
        wb_cells = sum(l.writeback_j / ENERGY["opcm_write_j"]
                       for l in self.layers)
        return wb_cells * DEFAULT_ARCH.cell_bits

    def epb(self) -> float:
        """Energy-per-bit: total inference energy normalized by the bits the
        platform moves across its memory interface (Fig. 11 metric)."""
        return self.energy_j / max(self.moved_bits, 1.0)


def layer_perf(m: LayerMapping, arch: OpimaArch = DEFAULT_ARCH) -> LayerPerf:
    # --- latency ---------------------------------------------------------
    processing_s = m.cycles / arch.cycle_hz
    writeback_s = (math.ceil(m.writeback_rows / arch.write_parallel_rows) *
                   arch.write_row_s)
    # --- energy ----------------------------------------------------------
    adc_steps = 2 ** arch.adc_bits
    processing_j = (
        m.cell_reads * ENERGY["opcm_read_j"] +
        m.adc_conversions * ENERGY["adc_j_per_step"] * adc_steps +
        m.mdl_drives * ENERGY["dac_j_per_bit"] * arch.cell_bits)
    writeback_j = m.out_cells * ENERGY["opcm_write_j"]
    return LayerPerf(name=m.name, macs=m.macs, processing_s=processing_s,
                     writeback_s=writeback_s, processing_j=processing_j,
                     writeback_j=writeback_j, utilization=m.utilization)


def network_perf(name: str, layers: Sequence[LayerSpec],
                 arch: OpimaArch = DEFAULT_ARCH, weight_bits: int = 4,
                 act_bits: int = 4) -> NetworkPerf:
    mappings = map_network(layers, arch, weight_bits, act_bits)
    return NetworkPerf(name=name,
                       layers=[layer_perf(m, arch) for m in mappings],
                       weight_bits=weight_bits, act_bits=act_bits)


# ---------------------------------------------------------------------------
# Fig. 7: subarray-group design-space exploration
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GroupingPoint:
    groups: int
    power_w: float
    mac_throughput: float          # peak MAC lanes · cycle rate
    rows_for_memory: int
    macs_per_watt: float


def grouping_sweep(arch: OpimaArch = DEFAULT_ARCH,
                   candidates: Sequence[int] = (1, 2, 4, 8, 16, 32, 64)
                   ) -> List[GroupingPoint]:
    points = []
    for g in candidates:
        a = dataclasses.replace(arch, groups=g)
        power = total_power_w(a, g)
        thpt = a.peak_macs_per_cycle * a.cycle_hz
        points.append(GroupingPoint(
            groups=g, power_w=power, mac_throughput=thpt,
            rows_for_memory=a.rows_available_for_memory,
            macs_per_watt=thpt / power))
    return points


def best_grouping(arch: OpimaArch = DEFAULT_ARCH) -> int:
    pts = grouping_sweep(arch)
    # the paper excludes the extremes (1 group: no parallelism; 64 groups:
    # memory starvation) before optimizing MAC/W
    interior = [p for p in pts if 1 < p.groups < arch.subarray_grid]
    return max(interior, key=lambda p: p.macs_per_watt).groups
