"""Independent float64 derivation of the kWTA/FFFB stage (second oracle).

The reference's ``ApplyGabor`` tail (sound/sndenv.go:303-323) calls
``kwta.KWTAPool`` / ``kwta.KWTALayer`` from *external, unvendored* packages
(``emer/vision/kwta`` v1.1.15 + ``emer/leabra/fffb`` v1.1.48, imports at
sndenv.go:19-20); no upstream source is available offline, so ``nn/kwta.py``
is a behavioral port with no oracle. This module is the best offline
substitute: a SECOND, independent derivation of
the same published Leabra spec, sharing no code, no numerical method, and no
evaluation strategy with the production path:

==============================  =================================  ==========================
aspect                          production (``nn/kwta.py``)        this module
==============================  =================================  ==========================
noisy-XX1 evaluator             two-band Chebyshev fit, Clenshaw   lookup TABLE + linear
                                on device (VPU elementwise)        interpolation (the
                                                                   published table spec)
convolution quadrature          Riemann sum over a +-5 sigma       adaptive Gauss-Kronrod
                                linspace (2049 pts)                (``scipy.integrate.quad``)
                                                                   with the XX1 kink split
settle loop                     fixed ``iters`` under lax.scan     scalar while loop with the
                                                                   upstream EARLY-STOP
                                                                   (max |delta act| <
                                                                   del_act_thr)
arithmetic                      float32, vectorized                float64, per-pool Python
                                                                   loops
==============================  =================================  ==========================

The Leabra equations implemented (O'Reilly et al., Computational Cognitive
Neuroscience, ch. 2-3; same formulation cited by ``nn/fffb.py``):

  FFFB:  ffi = FF * max(netin_avg + MaxVsAvg*(netin_max - netin_avg) - FF0, 0)
         fbi += (1/FBTau) * (FB * act_avg - fbi)
         Gi   = Gi_gain * (ffi + fbi)
  rate:  ge_thr = (gbar_i*Gi*(Thr-Erev_i) + gbar_l*(Thr-Erev_l)) / (Erev_e-Thr)
         act   += (1/ActTau) * (nxx1(gbar_e*ge - ge_thr) - act)
  nxx1:  XX1(g x) = g x / (g x + 1) for x > 0, convolved with N(0, nvar)
         (evaluated via a range/resolution lookup table with linear
         interpolation -- the construction the emergent implementation
         documents for its noisy-XX1 table)

Agreement between the two derivations is measured by
``tests/test_kwta_cross.py`` and the bound frozen in ``docs/PARITY.md``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from ..config import FFFBParams, KWTAParams

__all__ = ["noisy_xx1_ref", "kwta_layer_ref", "kwta_pool_ref"]


@lru_cache(maxsize=8)
def _nxx1_table(gain: float, nvar: float, res: int = 2000):
    """Noisy-XX1 lookup table over the transition band [-4*nvar, hi].

    Each table entry is the exact gaussian-convolved clean XX1,
    integrated adaptively (Gauss-Kronrod) over t in (0, x+8*nvar] with the
    integrand kink at t=0 as an endpoint:

        conv(x) = int_0^inf  g t/(g t + 1) * phi((x - t)/nvar)/nvar dt

    Outside the band: 0 below (the gaussian tail is < 1e-15 of peak), the
    clean XX1 above (the convolution of a locally-linear function with a
    symmetric kernel is itself; XX1's curvature at x >= hi contributes
    < nvar^2 * |f''| ~ 1e-7 for the default band edge).
    """
    from scipy.integrate import quad

    lo = -4.0 * nvar
    hi = max(16.0 / max(gain, 1e-6), 8.0 * nvar)
    xs = np.linspace(lo, hi, res + 1)
    inv_s = 1.0 / (nvar * math.sqrt(2.0 * math.pi))

    def conv(x: float) -> float:
        def f(t):
            return (gain * t / (gain * t + 1.0)) * (
                inv_s * math.exp(-0.5 * ((x - t) / nvar) ** 2)
            )

        val, _ = quad(f, 0.0, x + 8.0 * nvar, limit=200,
                      points=[max(0.0, x)] if 0.0 <= x + 8.0 * nvar else None)
        return val

    ys = np.array([conv(float(x)) if x + 8.0 * nvar > 0 else 0.0 for x in xs])
    return xs, ys


def noisy_xx1_ref(params: KWTAParams, x: np.ndarray) -> np.ndarray:
    """Table + linear-interpolation evaluation of the noisy XX1 (float64)."""
    x = np.asarray(x, dtype=np.float64)
    if params.xx1_nvar <= 0.0:
        g = params.xx1_gain * x
        return np.where(x > 0, g / (g + 1.0), 0.0)
    xs, ys = _nxx1_table(float(params.xx1_gain), float(params.xx1_nvar))
    out = np.interp(x, xs, ys)  # linear interp; clamps at the edges
    g = params.xx1_gain * x
    out = np.where(x >= xs[-1], g / (g + 1.0), out)
    return np.where(x <= xs[0], 0.0, out)


class _FFFB:
    """Scalar FFFB inhibition state for one group (float64)."""

    def __init__(self, p: FFFBParams, netin_avg: float, netin_max: float):
        self.p = p
        ff_netin = netin_avg + p.max_vs_avg * (netin_max - netin_avg)
        self.ffi = p.ff * max(ff_netin - p.ff0, 0.0)
        self.fbi = 0.0
        self.gi = 0.0

    def cycle(self, act_avg: float) -> float:
        p = self.p
        if not p.on:
            self.gi = 0.0
            return 0.0
        self.fbi += (1.0 / p.fb_tau) * (p.fb * act_avg - self.fbi)
        self.gi = p.gi * (self.ffi + self.fbi)
        return self.gi


def _ge_thr(p: KWTAParams, gi: np.ndarray) -> np.ndarray:
    num = p.gbar_i * gi * (p.thr - p.erev_i) + p.gbar_l * (p.thr - p.erev_l)
    return num / (p.erev_e - p.thr)


def _settle_ref(
    p: KWTAParams,
    ge: np.ndarray,
    ext_gi: np.ndarray,
    pool_axes: Optional[Tuple[int, ...]],
    max_cycles: Optional[int] = None,
    early_stop: bool = True,
) -> np.ndarray:
    """Early-stopping scalar settle (upstream semantics: iterate until
    max |delta act| < del_act_thr). ``early_stop=False`` runs exactly
    ``max_cycles`` iterations for matched-iteration comparisons."""
    ge = np.asarray(ge, dtype=np.float64)
    ext_gi = np.asarray(ext_gi, dtype=np.float64)
    act = np.zeros_like(ge)
    lay = _FFFB(p.lay_fffb, float(ge.mean()), float(ge.max()))

    pools = []
    if pool_axes is not None:
        axes = tuple(a % ge.ndim for a in pool_axes)
        outer = tuple(a for a in range(ge.ndim) if a not in axes)
        # iterate pools as explicit index tuples over the outer dims
        outer_shape = tuple(ge.shape[a] for a in outer)
        for idx in np.ndindex(*outer_shape):
            sel = [slice(None)] * ge.ndim
            for a, i in zip(outer, idx):
                sel[a] = i
            sel = tuple(sel)
            sub = ge[sel]
            pools.append((sel, _FFFB(p.pool_fffb, float(sub.mean()),
                                     float(sub.max()))))

    limit = max_cycles if max_cycles is not None else 1000
    for _ in range(limit):
        gi_lay = lay.cycle(float(act.mean()))
        gi = np.full_like(ge, gi_lay)
        for sel, pool in pools:
            gi_pool = pool.cycle(float(act[sel].mean()))
            gi[sel] = np.maximum(gi[sel], gi_pool)
        gi = gi + ext_gi
        drive = p.gbar_e * ge - _ge_thr(p, gi)
        target = noisy_xx1_ref(p, drive)
        delta = (1.0 / p.act_tau) * (target - act)
        act = act + delta
        if early_stop and float(np.abs(delta).max()) < p.del_act_thr:
            break
    return act


def kwta_layer_ref(
    p: KWTAParams,
    raw: np.ndarray,
    ext_gi: Optional[np.ndarray] = None,
    max_cycles: Optional[int] = None,
    early_stop: bool = True,
) -> np.ndarray:
    """Layer-level kWTA, independent float64 derivation."""
    if not p.on:
        return np.asarray(raw, dtype=np.float64)
    eg = np.zeros_like(raw, dtype=np.float64) if ext_gi is None else ext_gi
    return _settle_ref(p, raw, eg, None, max_cycles, early_stop)


def kwta_pool_ref(
    p: KWTAParams,
    raw: np.ndarray,
    ext_gi: Optional[np.ndarray] = None,
    pool_axes: Tuple[int, ...] = (-2, -1),
    max_cycles: Optional[int] = None,
    early_stop: bool = True,
) -> np.ndarray:
    """Pool-level kWTA (per-pool FFFB max-combined with the layer group),
    independent float64 derivation."""
    if not p.on:
        return np.asarray(raw, dtype=np.float64)
    eg = np.zeros_like(raw, dtype=np.float64) if ext_gi is None else ext_gi
    return _settle_ref(p, raw, eg, pool_axes, max_cycles, early_stop)
