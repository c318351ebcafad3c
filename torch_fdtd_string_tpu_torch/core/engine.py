"""Simulation constants and the string parameters the simulate task passes on.

PyTorch port of the containers of ``torch_fdtd_string_tpu/core/engine.py``.
The time loop itself runs in the fused string kernel
(``ops/string_kernel.py``); the general scan engine with bow, hammer, MMS
forcing and the GMRES coupled solve is ROADMAP Queue 1 item 2 and is not
part of this package yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SimConsts(NamedTuple):
    """Run constants (same fields and defaults as the JAX package)."""

    k: float
    theta_t: float
    lambda_c: float
    relative_error: float
    M_t: int  # static padded transverse width (Nx_t + 1)
    M_l: int  # static padded longitudinal width (Nx_l + 1)
    surface_integral: bool = False
    manufactured: bool = False
    picard_max_iter: int = 40
    hammer_max_iter: int = 40
    coupling_max_iter: int = 8
    coupling_eps_factor: float = 100.0
    coupling_solver: str = "gs"
    has_bow: bool = True
    has_hammer: bool = True
    coupling_fixed_iters: int = 0
    collect_state: bool = True
    mms_centered: bool = False


class StringParams(NamedTuple):
    """Per-batch string parameters on the simulation device."""

    kappa: torch.Tensor  # (B,) relative stiffness
    alpha: torch.Tensor  # (B,) stiffness vs tension
    p_a: torch.Tensor  # (B,) max pluck amplitude
    f0: torch.Tensor  # (B, Nt) fundamental frequency control
    pos: torch.Tensor  # (B,) readout position
    T60: torch.Tensor  # (B, 2, 2) damping spec

