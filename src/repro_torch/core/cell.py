"""OPCM cell transmission model and design-space exploration (counterpart
of ``repro/core/cell.py``, paper §IV.A, Fig. 2), in float32 like the
reference.

The paper models a 2 um-long GST patch on a silicon waveguide:

    T_out = T_in - dT_s - P_abs          (all in dB; eq. 2)

where dT_s is the transmission change from scattering/back-reflection at
the GST facets and P_abs is absorption in the film. The chosen design
point (w=0.48 um, t=20 nm) gives dT_s < 5% in both states and an
amorphous<->crystalline contrast of about 96%, so 16 transmission levels
(4 bits per cell).

The physics surrogate (calibrated to the paper's numbers) and its
constants are the reference's, unchanged:

* absorption: P_abs = 1 - exp(-Gamma(w,t) * alpha * L), alpha = 4 pi kappa
  / lambda, Gamma a saturating mode-overlap factor in the thin film;
* scattering: a facet index-mismatch Fresnel term scaled by a
  mode-mismatch factor that is smallest near the mode-matched width.

The analog readout route reads :meth:`CellDesign.level_noise_sigma` of
:data:`DEFAULT_CELL`: the implied read-noise sigma when a config asks for
noise without naming one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

LAMBDA_UM = 1.55          # C-band
CELL_LENGTH_UM = 2.0      # paper §IV.A
N_WG = 2.4                # effective index of the SOI strip waveguide mode
N_GST_AM, K_GST_AM = 3.94, 0.02   # thin-film amorphous GST @1550nm
N_GST_CR, K_GST_CR = 6.11, 0.83

# Calibrated surrogate constants (fit so the paper's design point
# (w=0.48um, t=20nm) yields dTs<5% in both states and contrast ~96%).
_GAMMA_SAT = 0.357        # confinement saturation (cryst.-index mode pull)
_GAMMA_T0_NM = 11.0       # thickness scale of confinement saturation
_GAMMA_W0_UM = 0.35       # width scale (fast saturation past single-mode w)
_GAMMA_INDEX_POW = 3.0    # mode pull-up into film grows with film index
_SCATTER_BASE = 0.035     # crystalline facet scattering at the design point
_SCATTER_WIDTH_UM = 0.48  # mode-matched width (minimum of scattering)
_SCATTER_W_CURV = 20.0    # scattering growth away from matched width
_SCATTER_T_POW = 3.2      # scattering growth with thickness (t/20nm)^pow
_MULTIMODE_ONSET_UM = 0.52  # amorphous-state multimode scattering onset
_MULTIMODE_SCALE_UM = 0.02
_FRESNEL_CR = ((N_GST_CR - N_WG) / (N_GST_CR + N_WG)) ** 2


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _effective_index(frac_cryst) -> Tuple[torch.Tensor, torch.Tensor]:
    """Effective-medium (linear-in-permittivity) n, kappa at
    crystallization fraction ``frac_cryst`` in [0, 1]."""
    eps_am = (N_GST_AM + 1j * K_GST_AM) ** 2
    eps_cr = (N_GST_CR + 1j * K_GST_CR) ** 2
    eps = eps_am + _f32(frac_cryst) * (eps_cr - eps_am)    # complex64
    nk = torch.sqrt(eps)
    return nk.real, nk.imag


def confinement(width_um, thickness_nm, n_gst) -> torch.Tensor:
    """Mode overlap Gamma(w, t) of the waveguide mode with the GST film;
    it grows with the film index as (n/n_cr)^p, which makes the
    crystalline state strongly absorbing and the amorphous one nearly
    transparent."""
    t_term = 1.0 - torch.exp(-_f32(thickness_nm) / _GAMMA_T0_NM)
    w_term = 1.0 - torch.exp(-_f32(width_um) / _GAMMA_W0_UM)
    index_term = (_f32(n_gst) / N_GST_CR) ** _GAMMA_INDEX_POW
    return _GAMMA_SAT * t_term * w_term * index_term


def scattering_loss(width_um, thickness_nm, n_gst) -> torch.Tensor:
    """dT_s: fraction of power lost to scattering/back-reflection."""
    width_um, thickness_nm, n_gst = (_f32(width_um), _f32(thickness_nm),
                                     _f32(n_gst))
    fresnel = ((n_gst - N_WG) / (n_gst + N_WG)) ** 2 / _FRESNEL_CR
    w_mismatch = 1.0 + _SCATTER_W_CURV * (
        (width_um - _SCATTER_WIDTH_UM) / _SCATTER_WIDTH_UM) ** 2
    t_growth = (thickness_nm / 20.0) ** _SCATTER_T_POW
    # wider waveguides go multimode: the low-index (amorphous) state
    # scatters into higher-order modes past the onset width
    multimode = 1.0 + torch.where(
        n_gst < 0.5 * (N_GST_AM + N_GST_CR),
        torch.exp((width_um - _MULTIMODE_ONSET_UM) / _MULTIMODE_SCALE_UM),
        _f32(0.0))
    scatter = _SCATTER_BASE * fresnel * w_mismatch * t_growth * multimode
    return torch.clamp(scatter, 0.0, 1.0)


def absorption(width_um, thickness_nm, n, kappa) -> torch.Tensor:
    """P_abs: fraction of power absorbed in the film over the cell."""
    alpha_per_um = 4.0 * math.pi * _f32(kappa) / LAMBDA_UM
    gamma = confinement(width_um, thickness_nm, n)
    return 1.0 - torch.exp(-gamma * alpha_per_um * CELL_LENGTH_UM)


def transmission(width_um, thickness_nm, frac_cryst) -> torch.Tensor:
    """T_out/T_in of the cell at crystallization fraction ``frac_cryst``
    (eq. 2 in linear units)."""
    n, k = _effective_index(frac_cryst)
    dts = scattering_loss(width_um, thickness_nm, n)
    pabs = absorption(width_um, thickness_nm, n, k)
    return torch.clamp(1.0 - dts - pabs, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class CellDesign:
    width_um: float = 0.48
    thickness_nm: float = 20.0

    def levels(self, n_levels: int = 16) -> torch.Tensor:
        """The ``n_levels`` programmable transmissions, equally spaced in
        crystallization fraction (level 0 = crystalline = lowest T)."""
        fracs = 1.0 - torch.arange(n_levels, dtype=torch.float32) / (
            n_levels - 1)
        return transmission(self.width_um, self.thickness_nm, fracs)

    def contrast(self) -> torch.Tensor:
        """dT = T_amorphous - T_crystalline (Fig. 2(c) figure of merit)."""
        return transmission(self.width_um, self.thickness_nm, 0.0) - \
            transmission(self.width_um, self.thickness_nm, 1.0)

    def scatter_change(self, crystalline: bool) -> torch.Tensor:
        """dT_s in the given state (Fig. 2(a)/(b) figure of merit)."""
        n, _ = _effective_index(1.0 if crystalline else 0.0)
        return scattering_loss(self.width_um, self.thickness_nm, n)

    def level_noise_sigma(self) -> float:
        """Relative read-noise sigma implied by residual scattering: the
        worst-state dT_s spread across 3 sigma."""
        worst = float(torch.maximum(self.scatter_change(True),
                                    self.scatter_change(False)))
        return worst / 3.0


def design_space(widths_um, thicknesses_nm):
    """The full Fig. 2 sweep: (dTs_cryst, dTs_amorph, contrast) grids of
    shape (len(widths), len(thicknesses))."""
    w = _f32(widths_um)[:, None]
    t = _f32(thicknesses_nm)[None, :]
    n_cr, _ = _effective_index(1.0)
    n_am, _ = _effective_index(0.0)
    dts_c = scattering_loss(w, t, n_cr)
    dts_a = scattering_loss(w, t, n_am)
    contrast = transmission(w, t, 0.0) - transmission(w, t, 1.0)
    return dts_c, dts_a, contrast


def best_design(widths_um, thicknesses_nm, dts_budget: float = 0.05):
    """The (width, thickness) of largest contrast with dT_s < budget in
    both states — the paper's selection rule ('X' in Fig. 2(c))."""
    widths_um, thicknesses_nm = _f32(widths_um), _f32(thicknesses_nm)
    dts_c, dts_a, contrast = design_space(widths_um, thicknesses_nm)
    feasible = (dts_c < dts_budget) & (dts_a < dts_budget)
    score = torch.where(feasible, contrast, _f32(-math.inf))
    i, j = divmod(int(torch.argmax(score)), score.shape[1])
    return (float(widths_um[i]), float(thicknesses_nm[j]),
            float(contrast[i, j]))


DEFAULT_CELL = CellDesign()
