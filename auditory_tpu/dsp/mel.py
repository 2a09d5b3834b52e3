"""Mel filterbank, MFCC cepstrum, energy, and delta features (device side).

Batched form of the reference mel package + SndEnv post-processing:

- :func:`apply_mel` -- mel.FilterDft (mel/mel.go:120-153) as one matmul
  against the dense triangle matrix from :mod:`.design`, followed by the
  +LogOff / ==0 -> LogMin / ln / optional renorm-clamp chain.
- :func:`mfcc_dct` -- mel.CepstrumDct (mel/mel.go:192-212): unnormalized DCT-I
  matmul, coef0 replaced by ln(1 + c0^2), first NCoefs kept.
- :func:`energy` -- the SndEnv Energy computation *including the reference's
  indexing quirk* (sndenv.go:360-366): with mode='sndenv', Energy[s] sums
  LogPowerSegment[s, 0:steps] -- the step index is used as the frequency row.
  mode='gaborview' reproduces gbv.go:553-560 (sum over the first `steps`
  frequency rows at step s); mode='spectral' is the corrected per-step sum
  over all frequency bins.
- :func:`mfcc_deltas` -- the accumulating delta/delta-delta recurrence
  (sndenv.go:379-432). The reference accumulates ``prv``/``nxt`` across BOTH
  the coefficient loop i and the tap loop n without reset; this is a pure
  prefix-sum over the flattened (i, n) axis -- i.e. a fixed LINEAR operator
  over the [steps, n_coefs] plane. On device it runs as ONE matmul against
  the host-built operator (:func:`delta_operator`); the cumsum formulation
  is retained as :func:`mfcc_deltas_reference` and the two are asserted
  equal in tests. mode='gaborview' uses the gbv.go:570-620 variant
  d = nume/2 * n^2.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..config import FilterBank

__all__ = [
    "apply_mel", "mel_renorm", "mfcc_dct", "energy", "mfcc_deltas",
    "mfcc_deltas_reference", "delta_operator",
]


def apply_mel(
    power: jnp.ndarray, mel_weights: jnp.ndarray, fbank: FilterBank,
    precision: str = "highest",
) -> jnp.ndarray:
    """power [..., n_bins] -> log-mel [..., n_filters].

    Default precision='highest' = full f32: an unpinned f32 matmul may run
    in TF32 on a GPU (~3 decimal digits), which would silently break the
    f32 device path's CPU-equivalence (``chip_smoke.py`` phases 1-2).
    'high'/'default' opt in (SndEnv(matmul_precision=...)).
    """
    s = jnp.matmul(
        power, mel_weights.T, precision=precision,
        preferred_element_type=power.dtype,
    )
    s = s + jnp.asarray(fbank.log_off, dtype=power.dtype)
    safe = jnp.where(s == 0, 1.0, s)
    val = jnp.where(
        s == 0, jnp.asarray(fbank.log_min, dtype=power.dtype), jnp.log(safe)
    )
    if fbank.renorm_effective:
        val = mel_renorm(val, fbank)
    return val


def mel_renorm(val: jnp.ndarray, fbank: FilterBank) -> jnp.ndarray:
    """The reference's renorm clamp (mel/mel.go:144-149): scale into
    [renorm_min, renorm_max] and clip to [0, 1]. One source of truth for
    every spectrum frontend."""
    val = (val - fbank.renorm_min) * fbank.renorm_scale
    return jnp.clip(val, 0.0, 1.0)


def mfcc_dct(
    mel_vals: jnp.ndarray, dct_mat: jnp.ndarray, n_coefs: int,
    precision: str = "highest",
) -> jnp.ndarray:
    """log-mel [..., n_filters] -> MFCC [..., n_coefs] (mel/mel.go:192-212)."""
    out = jnp.matmul(
        mel_vals, dct_mat.T, precision=precision,
        preferred_element_type=mel_vals.dtype,
    )
    c0 = out[..., 0]
    out = out.at[..., 0].set(jnp.log(1.0 + c0 * c0))
    return out[..., :n_coefs]


def energy(log_power_seg: jnp.ndarray, mode: str = "sndenv") -> jnp.ndarray:
    """log_power_seg [..., steps, n_bins] -> energy [..., steps].

    mode='sndenv' (reference sndenv.go:360-366): Energy[s] = sum_t LPS[s, t]
    where LPS is the [freq, step] matrix -- i.e. sum over *steps* of frequency
    row s. In our [steps, bins] layout: sum over axis -2 of the leading
    [0:steps] slice of the bin axis, transposed.
    """
    steps = log_power_seg.shape[-2]
    n_bins = log_power_seg.shape[-1]
    if mode == "sndenv":
        if steps > n_bins:
            raise ValueError(
                "energy mode 'sndenv' requires segment_steps <= n_bins "
                "(the reference would index out of range)"
            )
        # LPS_go[s, t] = log_power_seg[..., t, s]; Energy[s] = sum_t LPS_go[s, t]
        return jnp.sum(log_power_seg[..., :, :steps], axis=-2)
    if mode == "gaborview":
        # gbv.go:553-560: Energy[s] = sum_{f<steps} LPS_go[f, s]
        if steps > n_bins:
            raise ValueError("energy mode 'gaborview' requires steps <= n_bins")
        return jnp.sum(log_power_seg[..., :steps], axis=-1)
    if mode == "spectral":
        return jnp.sum(log_power_seg, axis=-1)
    raise ValueError(f"unknown energy mode: {mode}")


def mfcc_deltas_reference(
    mfcc_seg: jnp.ndarray, npn: int = 2, mode: str = "sndenv"
) -> jnp.ndarray:
    """mfcc_seg [..., steps, n_coefs] -> deltas of the same shape.

    Vectorization of the reference recurrence (sndenv.go:379-432): per step s,
    with prv/nxt accumulating over the flattened (coefficient i, tap n) loop
    order and nume resetting per coefficient:

        prv_cum[i, n] = sum of src[i', clamp(s - n')] over (i', n') <= (i, n)
        nxt_cum[i, n] = likewise with clamp(s + n')
        d[i, s] = (sum_{n=1..npn} n * (nxt_cum[i, n] - prv_cum[i, n])) / (2*npn^2)

    mode='gaborview' (gbv.go:590-592): d = nume / 2 * npn^2.
    """
    *batch, steps, ncoef = mfcc_seg.shape
    n_idx = jnp.arange(1, npn + 1)

    # clamped shifts built from slices + edge repeats (no gather; pure data
    # movement XLA fuses)
    def shift_prev(k):  # [..., s, c] -> [..., clamp(s-k), c]
        lead = jnp.repeat(mfcc_seg[..., :1, :], min(k, steps), axis=-2)
        return jnp.concatenate(
            [lead, mfcc_seg[..., : max(steps - k, 0), :]], axis=-2
        )

    def shift_next(k):
        tail = jnp.repeat(mfcc_seg[..., -1:, :], min(k, steps), axis=-2)
        return jnp.concatenate([mfcc_seg[..., k:, :], tail], axis=-2)

    p = jnp.stack([shift_prev(k) for k in range(1, npn + 1)], axis=-2)
    x = jnp.stack([shift_next(k) for k in range(1, npn + 1)], axis=-2)
    # [..., steps, npn, ncoef]
    # flatten (i, n) in the reference loop order: i-major, n-minor
    p = jnp.moveaxis(p, -1, -2).reshape(*batch, steps, ncoef * npn)
    x = jnp.moveaxis(x, -1, -2).reshape(*batch, steps, ncoef * npn)
    p_cum = jnp.cumsum(p, axis=-1).reshape(*batch, steps, ncoef, npn)
    x_cum = jnp.cumsum(x, axis=-1).reshape(*batch, steps, ncoef, npn)

    weights = n_idx.astype(mfcc_seg.dtype)  # [npn]
    nume = jnp.sum(weights * (x_cum - p_cum), axis=-1)  # [..., steps, ncoef]
    if mode == "sndenv":
        d = nume / float(2 * npn * npn)
    elif mode == "gaborview":
        d = nume / 2.0 * float(npn * npn)
    else:
        raise ValueError(f"unknown delta mode: {mode}")
    return d


@functools.lru_cache(maxsize=32)
def delta_operator(
    steps: int, ncoef: int, npn: int = 2, mode: str = "sndenv"
):
    """The reference delta recurrence (sndenv.go:379-432) as an explicit
    linear operator: returns ``(M, reach)``, both
    [steps, ncoef, steps, ncoef] float64 host arrays, with
    ``delta[t, c] = sum_{s,i} M[t, c, s, i] * mfcc[s, i]`` and ``reach``
    marking which sources the recurrence touches (NaN propagation).

    Derivation: the (i', n') source term appears in the accumulating
    prv/nxt sums of output coefficient i for every tap n with
    (i', n') <= (i, n) in the reference's i-major/n-minor loop order, each
    weighted by n; source steps are edge-clamped. Equality with the cumsum
    formulation (:func:`mfcc_deltas_reference`) is asserted in tests."""
    M = np.zeros((steps, ncoef, steps, ncoef), dtype=np.float64)
    # reach[t, c, s, i]: the recurrence *touches* source (s, i) for output
    # (t, c) -- needed for exact NaN propagation, because touched terms can
    # cancel in M (e.g. clamped prev/next landing on the same step) yet a
    # NaN source still poisons the reference's accumulation
    reach = np.zeros((steps, ncoef, steps, ncoef), dtype=np.float64)
    if mode == "sndenv":
        scale = 1.0 / float(2 * npn * npn)
    elif mode == "gaborview":
        scale = float(npn * npn) / 2.0
    else:
        raise ValueError(f"unknown delta mode: {mode}")
    for i in range(ncoef):          # output coefficient
        for ip in range(i + 1):     # source coefficient i' <= i contributes
            for n_src in range(1, npn + 1):
                # taps n of output i that include (ip, n_src):
                # ip < i -> all n; ip == i -> n >= n_src
                lo_n = 1 if ip < i else n_src
                w = sum(range(lo_n, npn + 1)) * scale
                for s in range(steps):
                    sp = min(max(s - n_src, 0), steps - 1)
                    sx = min(max(s + n_src, 0), steps - 1)
                    M[s, i, sp, ip] -= w
                    M[s, i, sx, ip] += w
                    reach[s, i, sp, ip] = 1.0
                    reach[s, i, sx, ip] = 1.0
    return M, reach


def mfcc_deltas(
    mfcc_seg: jnp.ndarray, npn: int = 2, mode: str = "sndenv"
) -> jnp.ndarray:
    """mfcc_seg [..., steps, n_coefs] -> deltas of the same shape, as one
    matmul against the host-built :func:`delta_operator` (the recurrence is
    linear; the cumsum formulation spent ~20%% of the whole feature
    pipeline on latency-bound shifts/cumsums over tiny axes)."""
    *batch, steps, ncoef = mfcc_seg.shape
    M, reach = delta_operator(steps, ncoef, npn, mode)
    m = jnp.asarray(
        M.reshape(steps * ncoef, steps * ncoef), dtype=mfcc_seg.dtype
    )
    flat = mfcc_seg.reshape(*batch, steps * ncoef)
    # exact NaN propagation: the recurrence poisons exactly the outputs it
    # *touches* from a NaN source (mel's NaN-triangle quirk), while a plain
    # matmul would spread NaN through zero-weight terms too. Sanitize, then
    # re-inject via the reachability mask (a second tiny matmul).
    nan_src = jnp.isnan(flat)
    r = jnp.asarray(
        reach.reshape(steps * ncoef, steps * ncoef), dtype=mfcc_seg.dtype
    )
    # precision='highest': a reduced-precision (TF32) product would regress
    # delta accuracy vs the exact-f32 cumsum formulation; the operator is
    # 182x182, so full precision is free
    clean = jnp.where(nan_src, 0, flat)
    out = jnp.matmul(clean, m.T, precision="highest")
    poisoned = jnp.matmul(
        nan_src.astype(mfcc_seg.dtype), r.T, precision="highest"
    ) > 0
    out = jnp.where(poisoned, jnp.nan, out)
    return out.reshape(*batch, steps, ncoef)
