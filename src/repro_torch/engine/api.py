"""Top-level engine verbs: ``program`` once, ``matmul`` many
(counterpart of ``repro/engine/api.py``).

  plan = engine.program(w, cfg)        # weights -> stationary plan
  y    = engine.matmul(x, plan)        # activations driven past the plan

``program`` resolves the substrate from ``cfg`` (or an override) and
stamps it into the plan; ``matmul`` dispatches on the plan's recorded
substrate and type, so call sites carry no mode flags.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import pim
from repro_torch.engine.substrates import get_substrate

_PROGRAM_KINDS = ("dense", "depthwise")


def program(w: torch.Tensor, cfg: pim.PimConfig = pim.DEFAULT_PIM, *,
            kind: str = "dense", substrate: Optional[str] = None
            ) -> pim.Plan:
    """Program float weights — (K, N) for ``kind="dense"``, (K=kh*kw, C)
    for ``kind="depthwise"`` — into a plan on a named substrate
    (``substrate`` overrides ``cfg``'s). The plan lives where ``w`` does."""
    sub = get_substrate(substrate or cfg.resolved_substrate)
    if kind == "dense":
        return sub.program(w, cfg)
    if kind == "depthwise":
        return sub.program_depthwise(w, cfg)
    raise ValueError(f"unknown plan kind {kind!r}; expected one of "
                     f"{_PROGRAM_KINDS}")


def matmul(x: torch.Tensor, plan: pim.Plan, *,
           cfg: Optional[pim.PimConfig] = None,
           bias: Optional[torch.Tensor] = None,
           rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Drive activations past a programmed plan — no mode flags.

    The route is the plan's recorded substrate, overridable with an
    explicit ``cfg``. Dense plans take x (..., K) -> (..., N), depthwise
    plans x (..., K, C) -> (..., C); ``bias`` is an optional (N,) dense
    bias, fused into the kernel epilogue on ``exact-cuda`` and
    ``analog-cuda``. ``rng`` is an optional CPU ``torch.Generator`` that
    keys the analog substrates' transmission noise (the other substrates
    ignore it).

    An override ``cfg`` must agree with the plan's programmed weight
    width: the planes were decomposed at ``plan.bits`` and cannot be
    reinterpreted at another width. A mismatch raises.
    """
    if cfg is None:
        cfg = plan.cfg
    elif getattr(plan, "bits", None) is not None and \
            cfg.weight_bits != plan.bits:
        pim._check_widths(cfg)   # wide operands raise first
        raise ValueError(
            f"override cfg has weight_bits={cfg.weight_bits} but the plan "
            f"was programmed at {plan.bits} bits; weight width is baked "
            "into the plan at programming time — build the override with "
            "dataclasses.replace(plan.cfg, ...) to change only the route")
    sub = get_substrate(cfg.resolved_substrate)
    return sub.matmul(x, plan, cfg=cfg, bias=bias, rng=rng)
