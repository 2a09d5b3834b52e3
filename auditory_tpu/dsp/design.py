"""Host-side (NumPy, float64) construction of the constant operators used by
the device pipeline.

Everything here runs once per configuration and is closed over by the jitted
pipeline as constants:

- :func:`mel_design` -- dense mel triangle-filter matrix. The reference builds
  per-filter weight vectors (mel.InitFilters, mel/mel.go:77-117) and applies
  them as scalar dot products over bin ranges (FilterDft, mel/mel.go:120-153).
  Here the same weights are placed into one dense [n_filters, n_bins] matrix so
  the filter bank application is a single matmul. The floor-based
  FreqToBin arithmetic and the 0/0 -> NaN quirk (adjacent mel points in one
  bin) are reproduced exactly.
- :func:`dct1_matrix` -- the unnormalized DCT-I computed by gonum
  fourier.NewDCT (mel/mel.go:198-204), as a matmul.
- :func:`dft_matrices` -- real/imag DFT basis for the matmul form of the power
  spectrum (GEMM-friendly alternative to an FFT; exact same math).
- :func:`gabor_filters` -- rendered gabor bank incl. the pos/neg-separate
  renormalization (agabor.ToTensor, agabor/gabor.go:89-222).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..config import FilterBank, GaborSet

__all__ = [
    "MelDesign",
    "mel_design",
    "dct1_matrix",
    "dft_matrices",
    "gabor_filters",
    "gabor_table",
    "analysis_window",
]


@dataclass(frozen=True)
class MelDesign:
    """Mel filterbank constants: dense weights + bin bookkeeping."""

    weights: np.ndarray      # [n_filters, n_bins] float64 (may contain NaN, by design)
    bin_pts: np.ndarray      # [n_filters + 2] int64
    hz_pts: np.ndarray       # [n_filters + 2] float64


def mel_design(fbank: FilterBank, win_samples: int, sample_rate: int) -> MelDesign:
    """Dense mel matrix equivalent of mel.InitFilters + FilterDft indexing."""
    nf = fbank.n_filters
    n_bins = win_samples // 2 + 1

    hi_mel = 1127.0 * np.log1p(fbank.hi_hz / 700.0)
    lo_mel = 1127.0 * np.log1p(fbank.lo_hz / 700.0)
    incr = (hi_mel - lo_mel) / float(nf + 1)
    mels = lo_mel + np.arange(nf + 2, dtype=np.float64) * incr
    hz = 700.0 * (np.exp(mels / 1127.0) - 1.0)
    bins = np.floor((float(win_samples) + 1.0) * hz / float(sample_rate)).astype(np.int64)

    if bins[-1] >= n_bins:
        raise ValueError(
            f"mel HiHz={fbank.hi_hz} maps to bin {bins[-1]} >= n_bins={n_bins}; "
            "HiHz must be <= sample_rate/2"
        )
    # the Go reference sizes each filter's weight row to NFilters+2 bins
    # (mel/mel.go:96-116) and panics (index out of range) when a triangle
    # spans more: Go panic -> ValueError, mirroring refemu.goref.init_filters
    widest = int(np.max(bins[2:] - bins[:-2])) + 1
    if widest > nf + 2:
        raise ValueError(
            f"mel filter spans {widest} bins > NFilters+2={nf + 2}: the "
            "reference would panic on this config (mel/mel.go:96-116); "
            "raise n_filters or lower hi_hz"
        )

    b = np.arange(n_bins, dtype=np.float64)[None, :]
    bmin = bins[:-2, None].astype(np.float64)
    bctr = bins[1:-1, None].astype(np.float64)
    bmax = bins[2:, None].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rising = (b - bmin) / (bctr - bmin)
        falling = (bmax - b) / (bmax - bctr)
    w = np.zeros((nf, n_bins), dtype=np.float64)
    w = np.where((b >= bmin) & (b <= bctr), rising, w)
    w = np.where((b > bctr) & (b <= bmax), falling, w)
    return MelDesign(weights=w, bin_pts=bins, hz_pts=hz)


def dct1_matrix(n: int) -> np.ndarray:
    """Matrix M with (M @ x) == gonum fourier.DCT.Transform(x) (unnormalized
    DCT-I): M[k,0]=1, M[k,n-1]=(-1)^k, M[k,i]=2*cos(pi*i*k/(n-1))."""
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    m = 2.0 * np.cos(np.pi * i * k / (n - 1))
    m[:, 0] = 1.0
    m[:, -1] = (-1.0) ** k[:, 0]
    return m


def dft_matrices(win_samples: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real DFT basis: windows @ C and windows @ S give Re/Im of the
    unnormalized forward DFT at bins 0..N/2 (dft/dft.go:42-71 semantics)."""
    n_bins = win_samples // 2 + 1
    n = np.arange(win_samples, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / float(win_samples)
    return np.cos(ang), -np.sin(ang)


def analysis_window(kind: Optional[str], win_samples: int) -> Optional[np.ndarray]:
    """Optional analysis window (extension; the reference applies none,
    dft/dft.go:42-59)."""
    if kind is None:
        return None
    if kind == "hamming":
        return np.hamming(win_samples)
    if kind == "hann":
        return np.hanning(win_samples)
    raise ValueError(f"unknown window_fn: {kind}")


def gabor_filters(gset: GaborSet) -> np.ndarray:
    """Render the active gabor specs into [n_filters, size_y, size_x]
    (agabor.ToTensor, agabor/gabor.go:89-222), vectorized over the patch."""
    active = [s.with_defaults() for s in gset.active_specs()]
    sx, sy = gset.size_x, gset.size_y
    radius_x, radius_y = sx / 2.0, sy / 2.0
    ctr_x, ctr_y = (sx - 1) / 2.0, (sy - 1) / 2.0

    nhf = nvf = 1
    if gset.distribute:
        nhf = sum(1 for f in active if f.orientation == 0)
        nvf = sum(1 for f in active if f.orientation == 90)
    h_ctr_inc = (sy - 1) / float(nhf + 1)
    v_ctr_inc = (sx - 1) / float(nvf + 1)

    ygrid, xgrid = np.meshgrid(
        np.arange(sy, dtype=np.float64), np.arange(sx, dtype=np.float64), indexing="ij"
    )

    out = np.zeros((len(active), sy, sx), dtype=np.float64)
    h_cnt = v_cnt = 0
    for i, f in enumerate(active):
        two_pi_norm = 2.0 * np.pi / f.wavelen
        l_norm = 1.0 / (2.0 * f.sigma_length**2) if f.sigma_length else 0.0
        w_norm = 1.0 / (2.0 * f.sigma_width**2)

        if gset.distribute:
            h_pos = v_pos = 0.0
            if f.orientation == 0:
                h_cnt += 1
                h_pos = h_ctr_inc * h_cnt
            if f.orientation == 90:
                v_cnt += 1
                v_pos = v_ctr_inc * v_cnt
        else:
            h_pos = h_ctr_inc * (h_cnt + 1)
            v_pos = v_ctr_inc * (v_cnt + 1)

        if not f.circular:
            xf = xgrid - ctr_x
            yf = ygrid - ctr_y
            if f.orientation == 0:
                yf = ygrid - h_pos
            if f.orientation == 90:
                xf = xgrid - v_pos
            xfn = xf / radius_x
            yfn = yf / radius_y
            rad = np.deg2rad(f.orientation)
            nx = xfn * np.cos(rad) - yfn * np.sin(rad)
            ny = yfn * np.cos(rad) + xfn * np.sin(rad)
            val = np.exp(-(w_norm * nx**2 + l_norm * ny**2)) * np.sin(
                two_pi_norm * ny + f.phase_offset
            )
            if f.circle_edge:
                val = np.where(np.hypot(xfn, yfn) > 1.0, 0.0, val)
            out[i] = val
        else:  # circular variant (gabor.go:172-191)
            norm = 1.0 / (2.0 * f.sigma_width**2)
            xfn = (xgrid - ctr_x) / radius_x
            yfn = (ygrid - ctr_y) / radius_y
            nx = xfn**2 * norm
            ny = yfn**2 * norm
            out[i] = -np.sqrt(nx + ny) * np.sin(two_pi_norm * nx * ny)

    # pos/neg-separate renormalization (gabor.go:194-221)
    pos_sum = np.where(out > 0, out, 0.0).sum(axis=(1, 2), keepdims=True)
    neg_sum = np.where(out < 0, out, 0.0).sum(axis=(1, 2), keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(
            out > 0, out / pos_sum, np.where(out < 0, -out / neg_sum, out)
        )
    return out


def gabor_table(gset: GaborSet) -> dict:
    """Display/validation export of a rendered gabor bank -- the analog of
    agabor.FilterSet.ToTable (agabor/gabor.go:318-326)."""
    filters = gabor_filters(gset)
    specs = [s.with_defaults() for s in gset.active_specs()]
    return {
        "n_filters": filters.shape[0],
        "size_y": gset.size_y,
        "size_x": gset.size_x,
        "orientation": np.asarray([s.orientation for s in specs]),
        "wavelen": np.asarray([s.wavelen for s in specs]),
        "phase_offset": np.asarray([s.phase_offset for s in specs]),
        "filters": filters,
    }
