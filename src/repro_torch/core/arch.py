"""OPIMA architecture configuration (paper §IV–V).

Main-memory organization used in the paper's evaluation (§V):
  4 banks, 64×64 subarrays per bank, 256×512 OPCM cells per subarray,
  256 MDLs per subarray, 16 subarray groups (Fig. 7 optimum), MDM degree 4,
  4 bits per OPCM cell (16 transmission levels, Fig. 2), 5-bit ADCs.

Note on MDL count vs. columns: §V specifies 256×512 OPCM elements and 256
MDLs per subarray, while §IV.C.2 states "Each subarray uses C MDLs ...
reflecting the column number per subarray". We resolve the ambiguity by
taking rows R=512, columns C=256 (so MDL count == C); total cells per
subarray (131072) and per-bank capacity are unchanged either way.

Copied unchanged from ``repro/core/arch.py``:
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OpimaArch:
    # -- memory organization (paper §V) ------------------------------------
    banks: int = 4                 # limited by MDM degree
    subarray_grid: int = 64        # S×S subarrays per bank (64×64)
    rows_per_subarray: int = 512   # R OPCM cells (see module docstring)
    cols_per_subarray: int = 256   # C OPCM cells == MDL count
    mdls_per_subarray: int = 256
    groups: int = 16               # subarray groups (Fig. 7 optimum)
    mdm_degree: int = 4            # modes (reused across groups, §V.A)
    cell_bits: int = 4             # OPCM MLC density (Fig. 2: 16 levels)
    adc_bits: int = 5              # aggregation-unit ADC (§IV.C.4)

    # -- operating point (calibrated; see DESIGN.md §6) ---------------------
    cycle_hz: float = 1.0e9        # PIM read/MAC cycle (MDL modulation rate)
    write_row_s: float = 80e-9    # OPCM write pulse per row (GST program)
    write_parallel_rows: int = 4   # rows programmable in parallel (1/bank)

    # ----------------------------------------------------------------------
    @property
    def subarrays_per_bank(self) -> int:
        return self.subarray_grid * self.subarray_grid

    @property
    def subarray_rows_per_group(self) -> int:
        # 64 rows of subarrays per bank split into `groups` groups; one row
        # of subarrays per group is PIM-active at a time (§IV.C.2).
        return self.subarray_grid // self.groups

    @property
    def pim_active_subarrays(self) -> int:
        """Subarrays engaged in PIM simultaneously, whole memory."""
        return self.banks * self.groups * self.subarray_grid

    @property
    def peak_macs_per_cycle(self) -> int:
        """One MAC per lit column (wavelength) of every PIM-active subarray."""
        lanes = min(self.cols_per_subarray, self.mdls_per_subarray)
        return self.pim_active_subarrays * lanes

    @property
    def cells_per_subarray(self) -> int:
        return self.rows_per_subarray * self.cols_per_subarray

    @property
    def capacity_bits(self) -> int:
        return (self.banks * self.subarrays_per_bank *
                self.cells_per_subarray * self.cell_bits)

    @property
    def rows_available_for_memory(self) -> int:
        """Subarray rows per bank NOT tied up in PIM (Fig. 7 y-axis #3)."""
        return self.subarray_grid - self.groups


DEFAULT_ARCH = OpimaArch()
