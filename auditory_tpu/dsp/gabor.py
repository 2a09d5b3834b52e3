"""Gabor feature extraction over the mel spectrogram (device side).

Batched form of ``agabor.Convolve`` (reference agabor/gabor.go:225-315):

- NaN inputs are replaced with 0.5 before filtering (gabor.go:279-281). The
  reference mel stage can legitimately emit NaN (see dsp/design.mel_design).
- valid-mode strided 2-D cross-correlation of the filter bank with the
  [freq, time] mel segment, lowered to ``lax.conv_general_dilated`` so XLA
  maps it onto an implicit GEMM over the batch.
- half-rectified two-channel output: act = Gain * |sum| routed to the 'on'
  channel if sum >= 0 else 'off' (gabor.go:284-308).
- output layouts: 4-D pooled [fIdx, tIdx, 2, filter] (gabor.go:301-308) and
  2-D [2*fIdx(+1), flt + tIdx*nf] / byTime [2*fIdx(+1), tIdx + tMax*flt]
  (gabor.go:286-300) -- both are pure transposes/reshapes of the conv output.

Output-position counts reproduce the reference loop bounds exactly,
including the 4-D clamping against the caller-provided output shape
(gabor.go:231-262).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import GaborSet

__all__ = ["gabor_out_counts", "convolve", "to_layout_2d"]


def gabor_out_counts(
    mel_shape: Tuple[int, int],
    gset: GaborSet,
    out_pools: Optional[Tuple[int, int]] = None,
) -> Tuple[int, int]:
    """(f_count, t_count) of gabor output positions, per the reference loop
    bounds (gabor.go:231-262). mel_shape is (n_mel_freq, n_steps).

    out_pools = (poolsY, poolsX) triggers the 4-D clamping logic; None uses
    the 2-D logic.
    """
    n_freq, n_time = mel_shape
    if out_pools is None:
        x = n_time - gset.size_x
        t_max = 1 if (x == 0 or x < gset.stride_x) else x + 1
        y = n_freq - gset.size_y
        f_max = 1 if (y == 0 or y < gset.stride_y) else y + 1
    else:
        pools_y, pools_x = out_pools
        t_max = min(pools_x * gset.stride_x, n_time - gset.stride_x)
        f_max = min(pools_y * gset.stride_y, n_freq - gset.stride_y)
    t_count = max(0, -(-t_max // gset.stride_x))  # ceil(t_max / stride)
    f_count = max(0, -(-f_max // gset.stride_y))
    if out_pools is not None:
        # clamp to the VALID conv range so this public count always matches
        # what convolve() emits. DOCUMENTED DEVIATION: when stride < size
        # the Go loop bounds (above) can exceed the valid range, where the
        # reference's behavior diverges by axis -- a time-axis overrun
        # silently reads the next frequency row through etensor's row-major
        # flat indexing (garbage, no panic; gabor.go:264-277), a
        # frequency-axis overrun panics, and the refemu oracle raises
        # IndexError. We emit only valid positions on both axes.
        t_count = min(
            t_count, max(0, (n_time - gset.size_x) // gset.stride_x + 1)
        )
        f_count = min(
            f_count, max(0, (n_freq - gset.size_y) // gset.stride_y + 1)
        )
    return f_count, t_count


def convolve(
    mel_seg: jnp.ndarray,
    filters: jnp.ndarray,
    gset: GaborSet,
    out_pools: Optional[Tuple[int, int]] = None,
    precision: str = "highest",
    method: str = "conv",
) -> jnp.ndarray:
    """mel_seg [..., n_freq, n_steps] -> gabor activations
    [..., f_count, t_count, 2, n_filters] (float32).

    This is the canonical 4-D pooled layout; use :func:`to_layout_2d` for the
    reference's flattened 2-D layouts.

    ``method`` picks the lowering: ``'conv'`` is the strided 2-D
    ``conv_general_dilated``; ``'gemm'`` extracts the f_count*t_count
    patches with static slices (no gather) and runs ONE
    [N*positions, sy*sx] x [sy*sx, n_filters] matmul, bit-identical in
    f64. 'conv' is the default; which lowering is faster on a GPU has not
    been measured.
    """
    n_freq, n_time = mel_seg.shape[-2], mel_seg.shape[-1]
    if n_time < gset.size_x:
        # DOCUMENTED DEVIATION: the reference silently leaves its (caller
        # pre-zeroed) output tensor all-zero when the mel matrix is narrower
        # than the filter (agabor/gabor.go:231-236 computes no columns).
        # Silent all-zero features are a footgun; we raise instead. The
        # production segment path never hits this (pipeline/segments.py
        # Resize widens the segment to fit the gabor grid, gbv.go:456-479).
        raise ValueError(
            "gabor filter width cannot exceed the mel matrix width "
            f"({gset.size_x} > {n_time}); the reference would silently "
            "produce all-zero gabor output here"
        )
    if n_freq < gset.size_y:
        # same footgun on the frequency axis: the reference's inner loop
        # would index past the mel rows (a Go panic, gabor.go:264-277);
        # XLA would instead convolve an implicitly padded plane and emit
        # plausible-looking garbage rows -- raise loudly instead
        raise ValueError(
            "gabor filter height cannot exceed the mel band count "
            f"({gset.size_y} > {n_freq})"
        )
    f_count, t_count = gabor_out_counts((n_freq, n_time), gset, out_pools)

    if method not in ("conv", "gemm"):
        raise ValueError(f"method must be 'conv' or 'gemm', got {method!r}")
    x = jnp.where(jnp.isnan(mel_seg), 0.5, mel_seg)  # gabor.go:279-281
    batch_shape = x.shape[:-2]
    x = x.reshape((-1, 1) + x.shape[-2:])  # [B, C=1, n_freq, n_time]
    k = jnp.asarray(filters, dtype=x.dtype)[:, None]  # [nf, 1, sy, sx]

    if method == "gemm":
        # static-slice patch extraction + one matmul. Valid-range counts:
        vy = max(0, (n_freq - gset.size_y) // gset.stride_y + 1)
        vx = max(0, (n_time - gset.size_x) // gset.stride_x + 1)
        fy = min(f_count, vy)
        tx = min(t_count, vx)
        if fy * tx == 0:
            # degenerate out_pools (zero positions): match the conv
            # branch's empty-slice result instead of stacking nothing
            out = jnp.zeros((x.shape[0], k.shape[0], fy, tx), x.dtype)
        else:
            xs = x[:, 0]  # [B, n_freq, n_time]
            patches = jnp.stack(
                [
                    xs[
                        :,
                        i * gset.stride_y : i * gset.stride_y + gset.size_y,
                        j * gset.stride_x : j * gset.stride_x + gset.size_x,
                    ]
                    for i in range(fy)
                    for j in range(tx)
                ],
                axis=1,
            )  # [B, fy*tx, sy, sx]
            pm = patches.reshape(patches.shape[0], fy * tx, -1)
            km = k[:, 0].reshape(k.shape[0], -1).T  # [sy*sx, nf]
            out = jnp.matmul(
                pm, km, precision=precision, preferred_element_type=x.dtype
            )  # [B, fy*tx, nf]
            out = out.reshape(out.shape[0], fy, tx, -1)
            out = jnp.moveaxis(out, -1, 1)  # [B, nf, fy, tx]
    else:
        out = jax.lax.conv_general_dilated(
            x,
            k,
            window_strides=(gset.stride_y, gset.stride_x),
            padding="VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            # pinned: 'highest' (the default) = full f32; an unpinned f32
            # conv may run in TF32 on a GPU. 'high'/'default' opt in to it
            precision=precision,
            preferred_element_type=x.dtype,
        )  # [B, nf, outY, outX]
    # gabor_out_counts is already clamped to the valid conv range (see its
    # DOCUMENTED DEVIATION note); this min() is a residual shape safety net
    f_count = min(f_count, out.shape[2])
    t_count = min(t_count, out.shape[3])
    out = out[:, :, :f_count, :t_count]

    act = (jnp.abs(out) * jnp.asarray(gset.gain, dtype=out.dtype)).astype(
        jnp.float32
    )
    pos = out >= 0
    on = jnp.where(pos, act, 0.0)
    off = jnp.where(pos, 0.0, act)
    res = jnp.stack([on, off], axis=2)  # [B, nf, 2, fI, tI]
    res = jnp.moveaxis(res, 1, -1)  # [B, 2, fI, tI, nf]
    res = jnp.moveaxis(res, 1, 3)  # [B, fI, tI, 2, nf]
    return res.reshape(batch_shape + res.shape[1:])


def to_layout_2d(gabor4d: jnp.ndarray, by_time: bool, t_max_strides: int) -> jnp.ndarray:
    """[..., fI, tI, 2, nf] -> the reference 2-D layout [..., 2*fI, X]
    (gabor.go:286-300).

    Default: X = flt + tIdx*nf  -> [..., fI, 2, tI, nf] reshaped.
    byTime:  X = tIdx + t_max_strides*flt -> [..., fI, 2, nf, tI] reshaped,
    where t_max_strides = (n_time - size_x)//stride_x + 1 (gabor.go:242-243)
    may exceed tI, leaving zero columns exactly like the reference's
    pre-zeroed output tensor.
    """
    *b, fi, ti, two, nf = gabor4d.shape
    x = jnp.moveaxis(gabor4d, -2, -3)  # [..., fI, 2, tI, nf]
    if not by_time:
        return x.reshape(*b, fi * two, ti * nf)
    x = jnp.moveaxis(x, -1, -2)  # [..., fI, 2, nf, tI]
    if t_max_strides > ti:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, t_max_strides - ti)]
        x = jnp.pad(x, pad)
    return x.reshape(*b, fi * two, nf * t_max_strides)
