"""Batched DFT power spectrum (device side).

Batched form of ``dft.Params.Filter``/``Power`` (reference dft/dft.go:42-85):

- NO analysis window by default (the reference feeds the raw rectangular
  window into the FFT, dft/dft.go:42-59).
- power[k] = re^2 + im^2 for k in [0, N/2] of the unnormalized forward DFT.
- optional temporal smoothing ``p'_t = prev*p'_{t-1} + cur*p_t`` applied for
  step t>0 (dft/dft.go:67-69); a linear scan over the step axis.
- log power = ln(power + LogOffSet), with the exact ``== 0`` -> LogMin floor
  (dft/dft.go:73-83).

Two spectrum methods:
- 'matmul': windows @ cos/sin DFT basis as dense GEMMs (f32 at a pinned
  precision, fuses with the mel matmul downstream); the f32 default.
- 'fft': jnp.fft.rfft -- the float64 parity default.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DFTParams
from .design import dft_matrices

__all__ = [
    "UNIFORM_SPECTRUM_METHODS",
    "power_spectrum",
    "power_spectrum_conv",
    "power_spectrum_frames",
    "power_spectrum_windows",
    "power_spectrum_sliced",
    "power_spectrum_factored",
    "segment_spans",
    "FactoredDFTPlan",
    "factored_dft_plan",
    "preferred_spectrum_frontend",
    "smooth_power",
    "log_power",
    "dft_power_pipeline",
]


# Every spectrum method that runs the DFT as dense GEMMs on the uniform
# window grid ('matmul' = auto-dispatch among them). ONE source of truth:
# the pipeline's basis-construction gate, method-name mapping, and
# uniform-path gate all consume this tuple — a new frontend added here is
# live everywhere at once.
UNIFORM_SPECTRUM_METHODS = (
    "matmul", "conv", "frames", "factored", "windowed", "sliced",
)


def _pad128(n: int) -> int:
    """``n`` rounded up to the 128-wide GEMM tile that the dispatch and
    factored cost models charge for (both GEMM dims; not yet re-derived
    for the GPU's tensor-core tiles)."""
    return -(-n // 128) * 128


def _frame_block_sizes(step: int, win: int) -> Tuple[int, ...]:
    """Block sizes of the frames frontend's J = ceil(win/step) step-aligned
    shifted GEMMs (the last block possibly partial). THE single source of
    the frames blocking — :func:`power_spectrum_frames` (the kernel) and
    :func:`_frames_padded_contraction` (the dispatch cost model) both use
    it, so the model cannot drift from the code it models."""
    j_blocks = max(1, -(-win // step))
    return tuple(min(step, win - j * step) for j in range(j_blocks))


def _frames_padded_contraction(step: int, win: int) -> int:
    """Total 128-padded contraction the frames frontend pays per window:
    one GEMM per step-aligned block (see :func:`_frame_block_sizes`), each
    padded to the GEMM tile. The windowed frontend pays _pad128(win) plus
    a windows-materialization HBM charge instead."""
    return sum(_pad128(b) for b in _frame_block_sizes(step, win))


def preferred_spectrum_frontend(
    step_samples: int, win_samples: int, precision: str = "highest"
) -> str:
    """Dispatch rule for ``spectrum_method='matmul'`` (the f32 default).
    Three XLA frontends compete -- ``conv`` (one strided convolution),
    ``frames`` (J = ceil(win/step) block-shifted dense GEMMs) and
    ``windowed`` (materialized windows, ONE dense GEMM) -- and the pick is
    set by the overlap factor J = win/step, then by window size:

    1. step >= win -> frames: framing degenerates to a reshape, zero
       redundant bytes.
    2. J >= 4 (heavy overlap): conv up to win 768 (512 at
       ``precision='default'``); above it frames when its tile-padded
       per-block contraction total does not exceed pad128(win)
       (:func:`_frames_padded_contraction`), else windowed; always
       windowed at ``precision='default'``.
    3. moderate overlap (the reference's win = 2.5*step family) ->
       windowed. On an NVIDIA H100 80GB HBM3 (700 W), B=512 x 3 s,
       'highest', median of 5 (``chip_smoke.py`` phase 3): 400/160
       windowed 1.78 ms, frames 2.46, conv 5.31; 1103/441 windowed 9.98,
       frames 10.19, conv 21.55.

    Terms 1 and 2 have not yet been measured on a GPU; ROADMAP S4
    re-derives them.
    """
    if step_samples >= win_samples:
        return "frames"
    if win_samples / step_samples >= 4.0:
        if win_samples <= (512 if precision == "default" else 768):
            return "conv"
        if precision != "default" and _frames_padded_contraction(
            step_samples, win_samples
        ) <= _pad128(win_samples):
            return "frames"
    return "windowed"


def power_spectrum_conv(
    signals: jnp.ndarray,
    basis: Tuple[jnp.ndarray, jnp.ndarray],
    step_samples: int,
    offset0: int,
    n_windows: int,
    precision: str = "highest",
) -> jnp.ndarray:
    """DFT power of uniformly-strided windows as ONE strided convolution.

    The window gather (sndenv.go SndToWindow) + DFT matmul is algebraically a
    1-D cross-correlation of the signal with the DFT basis rows at stride
    ``step_samples``: re[b, k, i] = sum_n sig[b, i*step + offset0 + n] *
    cos(2 pi n k / W). XLA lowers this conv to an implicit GEMM with no
    materialized [B, n_windows, W] tensor and no gather.

    Negative window positions read zeros via explicit conv padding, exactly
    reproducing the reference's left zero-fill (sndenv.go:455-478).

    Args:
      signals: [B, S].
      basis: (cos [W, K], sin [W, K]) from design.dft_matrices (analysis
        window already folded in, if any).
      step_samples: grid stride; window i starts at i*step + offset0.
      offset0: start of window 0 (may be negative).
      n_windows: number of grid windows.

    Returns power [B, n_windows, K].
    """
    cos_m, sin_m = basis
    w, k = cos_m.shape
    b, s = signals.shape

    if offset0 > 0:
        signals = signals[:, offset0:]
        s -= offset0
        offset0 = 0
    pad_l = -offset0
    last_end = (n_windows - 1) * step_samples + offset0 + w
    pad_r = max(0, last_end - s)

    kernel = jnp.concatenate([cos_m, sin_m], axis=1)  # [W, 2K]
    kernel = jnp.transpose(kernel)[:, None, :]  # [2K, 1, W]
    out = jax.lax.conv_general_dilated(
        signals[:, None, :],  # [B, 1, S]
        kernel,
        window_strides=(step_samples,),
        padding=[(pad_l, pad_r)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        # pinned: 'highest' (the default) = full f32; unpinned f32
        # contractions may run in TF32 on a GPU. 'high'/'default' are the
        # opt-in reduced-precision tiers (SndEnv(matmul_precision=...)).
        precision=precision,
        preferred_element_type=signals.dtype,
    )  # [B, 2K, n_out]
    out = out[:, :, :n_windows]
    re = out[:, :k, :]
    im = out[:, k:, :]
    power = re * re + im * im
    return jnp.moveaxis(power, 1, 2)  # [B, n_windows, K]


def _step_frames(
    signals: jnp.ndarray, step: int, offset0: int,
    n_windows: int, j_blocks: int,
) -> jnp.ndarray:
    """[B, n_frames, step] step-aligned frames (n_frames = n_windows +
    J - 1) with the reference's left zero-fill for negative window
    positions and right zero-pad for overrunning ones (sndenv.go:455-478).
    THE single implementation of the frontends' zero-fill semantics --
    frames/windowed/factored all build on it, so a semantics fix lands
    everywhere at once."""
    b, s = signals.shape
    if offset0 > 0:
        signals = signals[:, offset0:]
        s -= offset0
        offset0 = 0
    pad_l = -offset0
    total = (n_windows + j_blocks - 1) * step
    pad_r = max(0, total - (s + pad_l))
    sig = jnp.pad(signals, ((0, 0), (pad_l, pad_r)))[:, :total]
    return sig.reshape(b, n_windows + j_blocks - 1, step)


def _materialize_windows(
    frames: jnp.ndarray, n_windows: int, j_blocks: int, w: int,
) -> jnp.ndarray:
    """[B, nW, W] windows as J concatenated shifted slices of the frame
    tensor (views of one reshape -- no gather), trimmed to W."""
    return jnp.concatenate(
        [frames[:, j : j + n_windows] for j in range(j_blocks)], axis=-1
    )[..., :w]


def power_spectrum_frames(
    signals: jnp.ndarray,
    basis: Tuple[jnp.ndarray, jnp.ndarray],
    step_samples: int,
    offset0: int,
    n_windows: int,
    precision: str = "highest",
) -> jnp.ndarray:
    """DFT power of uniformly-strided windows as J = ceil(W/step) dense
    shifted GEMMs over step-aligned frames — no conv, no gather.

    Window i = sig[i·step+offset0 : +W] is the concatenation of frames
    i..i+J-1, where frame t = sig[t·step+offset0 : +step] (the final block
    possibly partial). Hence

        re[i] = Σ_j frames[i+j] @ cos[j·step : (j+1)·step]

    and each j-term is ONE [B, n_windows, step] @ [step, 2K] GEMM whose M
    dimension is the full window count. Same zero-fill semantics for
    negative window positions (sndenv.go:455-478); equal to f32 roundoff
    (the W-length dot splits into J partial sums, so rounding differs by
    ~1 ulp like any HIGHEST-grade reassociation).

    Args/returns: identical to :func:`power_spectrum_conv`.
    """
    cos_m, sin_m = basis
    w, k = cos_m.shape
    step = step_samples
    block_sizes = _frame_block_sizes(step, w)
    j_blocks = len(block_sizes)
    frames = _step_frames(signals, step, offset0, n_windows, j_blocks)

    kernel = jnp.concatenate([cos_m, sin_m], axis=1)  # [W, 2K]
    acc = None
    for j, bsz in enumerate(block_sizes):
        bj = kernel[j * step : j * step + bsz]  # [step_j, 2K]
        fr = frames[:, j : j + n_windows, :bsz]
        term = jnp.matmul(
            fr, bj, precision=precision,
            preferred_element_type=signals.dtype,
        )
        acc = term if acc is None else acc + term
    re = acc[..., :k]
    im = acc[..., k:]
    return re * re + im * im  # [B, n_windows, K]


def segment_spans(
    signals: jnp.ndarray,
    stride_samples: int,
    span: int,
    offset0: int,
    n_segments: int,
) -> jnp.ndarray:
    """[B, S] -> [B, n_segments, span] segment slices; slice s covers
    samples [offset0 + s*stride, offset0 + s*stride + span), zero-filled
    outside the signal (the same left-fill/overrun semantics as every
    uniform frontend -- sndenv.go:455-478 via :func:`_step_frames`).

    Gather-free: k = ceil(span/stride) shifted reshapes of the padded
    signal (the :func:`_materialize_windows` construction at segment
    granularity). Built for the per-segment uniform frontend: when stride
    is NOT a multiple of step (e.g. 22.05 kHz: stride 2205, step 221 from
    Go's math.Round of 220.5, sndenv.go:205) no global shared-window grid
    exists, but each segment's windows are still uniformly strided -- so
    slice the segments (this function), flatten them into the batch axis,
    and run the uniform conv/frames/windowed GEMM frontends per segment.

    The restructuring adds span+window materialization passes, so the
    pipeline's 'auto' keeps off-grid builds on the per-window gather;
    SndEnv(segment_frontend='per_segment') opts in. Which of the two is
    faster on a GPU has not been measured.
    """
    k = max(1, -(-span // stride_samples))
    frames = _step_frames(signals, stride_samples, offset0, n_segments, k)
    return _materialize_windows(frames, n_segments, k, span)


def power_spectrum_windows(
    signals: jnp.ndarray,
    basis: Tuple[jnp.ndarray, jnp.ndarray],
    step_samples: int,
    offset0: int,
    n_windows: int,
    precision: str = "highest",
) -> jnp.ndarray:
    """DFT power of uniformly-strided windows as ONE dense GEMM over
    gather-free materialized windows.

    Windows materialize as J=ceil(W/step) concatenated shifted slices of
    the step-frame tensor (views of one reshape -- no gather), trimmed to
    W; then [B*nW, W] @ [W, 2K] is a single dense GEMM with the exact
    W-length contraction. The price is 2W words/window of HBM traffic for
    the windows tensor. The dispatch rule's pick at moderate overlap
    (:func:`preferred_spectrum_frontend`); the factored frontend's
    non-polyphase stage 1 uses the same construction.

    Same zero-fill semantics for negative/overrunning positions
    (sndenv.go:455-478); identical math to the other frontends to f32
    roundoff. Args/returns: identical to :func:`power_spectrum_conv`.
    """
    cos_m, sin_m = basis
    w, k = cos_m.shape
    step = step_samples
    j_blocks = max(1, -(-w // step))
    frames = _step_frames(signals, step, offset0, n_windows, j_blocks)
    windows = _materialize_windows(frames, n_windows, j_blocks, w)

    kernel = jnp.concatenate([cos_m, sin_m], axis=1)  # [W, 2K]
    out = jnp.matmul(
        windows, kernel, precision=precision,
        preferred_element_type=signals.dtype,
    )
    re = out[..., :k]
    im = out[..., k:]
    return re * re + im * im  # [B, n_windows, K]


def power_spectrum_sliced(
    signals: jnp.ndarray,
    basis: Tuple[jnp.ndarray, jnp.ndarray],
    step_samples: int,
    offset0: int,
    n_windows: int,
    precision: str = "highest",
) -> jnp.ndarray:
    """DFT power of uniformly-strided windows as p = ceil(W/step)
    interleaved *pure-reshape* GEMMs — no conv, no gather, no window
    materialization.

    Window i starts at grid position i·step, so the windows of slot
    u ∈ [0, p) (those with i ≡ u mod p) are spaced exactly chunk = p·step
    ≥ W apart: slot u's window matrix IS
    ``sig_grid[:, u·step : u·step + M·chunk].reshape(B, M, chunk)`` — a
    contiguous slice + reshape, i.e. a view, with zero data-movement cost
    beyond the GEMM's own operand read. Each slot then runs ONE dense
    [B, M, chunk] @ [chunk, 2K] GEMM against the basis zero-padded to
    chunk rows, and the slot outputs interleave back to window order with
    a stack + reshape.

    An opt-in probe (``spectrum_method='sliced'``), never auto-dispatched:
    it trades windowed's materialization traffic for p separate small-M
    GEMMs plus a stack/interleave epilogue. Not yet timed on a GPU.

    When step ≥ W (p = 1) this degenerates to frames' single-reshape case.
    Same zero-fill semantics for negative/overrunning window positions
    (sndenv.go:455-478, via :func:`_step_frames`); identical math to the
    other frontends to f32 roundoff (the contraction zero-pad adds exact
    zeros). Args/returns: identical to :func:`power_spectrum_conv`.
    """
    cos_m, sin_m = basis
    w, k = cos_m.shape
    step = step_samples
    p = max(1, -(-w // step))  # slots; chunk = p*step >= w
    chunk = p * step
    m_rows = -(-n_windows // p)  # windows per slot (last slots padded)
    # grid long enough for slot p-1's last row: (p-1)*step + m_rows*chunk
    # = (m_rows*p + p - 1)*step  ->  ask _step_frames for m_rows*p windows
    # with j_blocks = p extra frames
    frames = _step_frames(signals, step, offset0, m_rows * p, p)
    b = frames.shape[0]
    sig_grid = frames.reshape(b, -1)  # [B, (m_rows*p + p - 1) * step]

    kernel = jnp.concatenate([cos_m, sin_m], axis=1)  # [W, 2K]
    if chunk > w:
        kernel = jnp.pad(kernel, ((0, chunk - w), (0, 0)))
    outs = []
    for u in range(p):
        rows = jax.lax.slice_in_dim(
            sig_grid, u * step, u * step + m_rows * chunk, axis=1
        ).reshape(b, m_rows, chunk)
        outs.append(
            jnp.matmul(
                rows, kernel, precision=precision,
                preferred_element_type=signals.dtype,
            )
        )
    out = jnp.stack(outs, axis=2)  # [B, M, p, 2K]
    out = out.reshape(b, m_rows * p, 2 * k)[:, :n_windows]
    re = out[..., :k]
    im = out[..., k:]
    return re * re + im * im  # [B, n_windows, K]


class FactoredDFTPlan:
    """Host-side constants for the two-stage Cooley-Tukey DFT frontend
    (:func:`power_spectrum_factored`). Built once per (win, step) geometry
    by :func:`factored_dft_plan`; matrices are float64 numpy, cast to the
    signal dtype at trace time."""

    def __init__(self, win: int, step: int, n1: int, n2: int):
        assert win == n1 * n2 and n1 >= 2 and n2 >= 2
        self.win = win
        self.step = step
        self.n1 = n1
        self.n2 = n2
        self.h1 = n1 // 2 + 1           # Hermitian-truncated stage-1 bins
        self.k2 = (win // 2) // n1 + 1  # outer bins covering k <= W/2
        # stage-1 mode: when N2 | step, stage 1 runs gather-free on the
        # polyphase decomposition; otherwise windows are materialized from
        # step-frames (J concatenated slices, still no gather) and stage 1
        # is one batched einsum over the [N1, N2] reshape
        self.polyphase = step % n2 == 0
        if self.polyphase:
            self.sub_step = step // n2  # polyphase-domain window stride
            self.j_blocks = -(-n1 // self.sub_step)
        else:
            self.sub_step = None
            self.j_blocks = -(-win // step)  # frames per window

        # stage 1: length-N1 real DFT over each polyphase subsequence.
        # Same [cos | -sin] convention as design.dft_matrices, so
        # acc[..., h1:] is Im(A) directly.
        n1i = np.arange(n1, dtype=np.float64)[:, None]
        h = np.arange(self.h1, dtype=np.float64)[None, :]
        ang1 = 2.0 * np.pi * n1i * h / float(n1)
        self.basis1 = np.concatenate(
            [np.cos(ang1), -np.sin(ang1)], axis=1
        )  # [N1, 2*H1]

        # stage 2 + twiddle, folded into one complex factor per output:
        # X[k] = sum_n2 A[n2, k mod N1] * exp(-2pi i n2 k / W). For
        # k1 = h <= N1/2 that uses A[h] directly (Q1); for k1 = N1-h it
        # uses conj(A[h]) (real input Hermitian symmetry) with Q2.
        n2i = np.arange(n2, dtype=np.float64)
        k2i = np.arange(self.k2, dtype=np.float64)
        k_q1 = h[0][:, None, None] + n1 * k2i[None, None, :]      # [H1,1,K2]
        k_q2 = (n1 - h[0])[:, None, None] + n1 * k2i[None, None, :]
        phase = -2j * np.pi * n2i[None, :, None] / float(win)
        q1 = np.exp(phase * k_q1)  # [H1, N2, K2]
        q2 = np.exp(phase * k_q2)
        self.qall = np.concatenate(
            [q1.real, q1.imag, q2.real, q2.imag], axis=2
        )  # [H1, N2, 4*K2]

    def padded_macs_per_window(self) -> int:
        """Cost model (see :func:`factored_split_cost`)."""
        return factored_split_cost(self.win, self.step, self.n1, self.n2)


# MAC-equivalents charged per f32 word of HBM traffic, i.e. the ratio of
# the f32 MAC rate to the f32 word bandwidth. Without the charge the model
# picks FLOP-cheap/byte-heavy splits. 80 has not been re-derived for the
# GPU (an H100 SXM at full f32 is ~40: 33.5e12 MAC/s over 0.84e12 words/s,
# datasheet rates); ROADMAP S4 re-derives it
_MACS_PER_WORD = 80


def factored_split_cost(win: int, step: int, n1: int, n2: int) -> int:
    """Split-RANKING cost model for a W = N1*N2 split: tile-padded MAC
    count per window plus HBM-traffic charges. Both GEMM dimensions are
    padded to a 128-wide tile (:func:`_pad128`), so a stage GEMM that
    contracts only a few samples is charged as the under-filled GEMM it
    is.

    Traffic charges: the non-polyphase mode's materialized
    [n_windows, W] windows tensor (write + read = 2W words/window), and
    the complex stage-1 intermediate that every split materializes
    between the two GEMMs (write + read = 2 * N2 * 2*H1 words/window).

    Pure scalar geometry -- plan selection calls this for every candidate
    divisor without building the (costly) f64 basis/twiddle matrices."""
    pad = _pad128
    h1 = n1 // 2 + 1
    k2 = (win // 2) // n1 + 1
    if step % n2 == 0:  # polyphase stage 1
        sub_step = step // n2
        j_blocks = -(-n1 // sub_step)
        stage1 = n2 * j_blocks * pad(sub_step) * pad(2 * h1)
        traffic = 0
    else:  # windows-materialization stage 1
        stage1 = n2 * pad(n1) * pad(2 * h1)
        traffic = 2 * win * _MACS_PER_WORD
    traffic += 2 * n2 * 2 * h1 * _MACS_PER_WORD  # stage-1 out roundtrip
    stage2 = 2 * h1 * pad(n2) * pad(4 * k2)
    return stage1 + stage2 + traffic


def factored_dft_plan(
    win_samples: int, step_samples: int, allow_dominated: bool = False
) -> Optional[FactoredDFTPlan]:
    """Best-ranked W = N1*N2 split for :func:`power_spectrum_factored`,
    or None when the geometry admits none (prime W, tiny window) or --
    by default -- when the split is dominated by the dense frames GEMM.
    Reference workload being factored: the dense rectangular-window DFT
    of dft/dft.go:42-59.

    Despite a 3-4.5x raw-FLOP advantage, stage GEMMs contracting N1 or
    N2 << 128 samples under-fill their tiles and the complex stage-1
    intermediate pays two extra HBM passes that the dense single-GEMM
    paths never make. The default gate compares
    :func:`factored_split_cost` (which models both effects) against the
    same-convention dense cost and returns None everywhere at
    reference-scale windows -- the auto-dispatch backfill in
    pipeline/sndenv.py then stays on 'frames'. Not yet timed on a GPU.

    ``allow_dominated=True`` returns the best-ranked split anyway
    (explicit ``spectrum_method='factored'`` opt-in, benches, parity
    tests).

    Splits with N2 | step get the gather-free polyphase stage 1; other
    composite splits (e.g. 22.05 kHz's 551 = 29*19 against step 221) pay
    the windows-materialization traffic charge in the model. Costs are
    evaluated on scalar geometry only; the winner's basis/twiddle
    matrices are built once."""
    w, step = int(win_samples), int(step_samples)
    if w < 16 or step < 2:
        return None
    best = None  # (cost, n2)
    for n2 in range(2, w // 2 + 1):
        if w % n2 or w // n2 < 4:
            continue
        cost = factored_split_cost(w, step, w // n2, n2)
        if best is None or cost < best[0]:
            best = (cost, n2)
    if best is None:
        return None
    if not allow_dominated:
        k = w // 2 + 1
        dense = _frames_padded_contraction(step, w) * _pad128(2 * k)
        # Safety margin: the model does not cost the stage-2 batched
        # einsum and the non-polyphase transpose passes individually, so
        # only a >=2x modeled advantage counts as undominated. At every
        # reference geometry this gate returns None.
        if 2 * best[0] >= dense:
            return None
    return FactoredDFTPlan(w, step, w // best[1], best[1])


def power_spectrum_factored(
    signals: jnp.ndarray,
    plan: FactoredDFTPlan,
    step_samples: int,
    offset0: int,
    n_windows: int,
    precision: str = "highest",
) -> jnp.ndarray:
    """DFT power via a two-stage Cooley-Tukey factorization W = N1*N2 --
    exact math, same rectangular-window semantics as the dense frontends
    (dft/dft.go:42-59), ~W/(N1+N2) fewer raw MACs (e.g. 9x at
    W=1200=120*10), but its stage GEMMs contract only N1 or N2 samples and
    the complex stage-1 intermediate costs two extra HBM passes (see
    :func:`factored_dft_plan`). An explicit opt-in
    (``spectrum_method='factored'``); never auto-dispatched.

    Decompose n = N2*n1 + n2, k = k1 + N1*k2:

      A[n2, k1] = sum_n1 x[N2*n1 + n2] e^{-2pi i n1 k1 / N1}   (stage 1)
      X[k]      = sum_n2 A[n2, k mod N1] e^{-2pi i n2 k / W}   (stage 2,
                                                  twiddle folded in)

    Stage 1 has two gather-free modes (plan.polyphase):

    - N2 | step: the frames trick applied per polyphase component --
      window i's subsequence n2 lives at stride-1 positions
      i*(step/N2) + n1 of the polyphase signal g[n2, m] = sig[m*N2+n2]:
      J' = ceil(N1/(step/N2)) dense shifted GEMMs over [B*N2] signals,
      no window materialization.
    - otherwise (e.g. 22.05 kHz 551 = 29*19 vs step 221): windows are
      materialized as J concatenated slices of the step-frame tensor
      (a concat of views, still no gather), reshaped [N1, N2], and
      stage 1 is one batched einsum. The plan's cost model charges the
      extra HBM traffic, so this mode is only ever selected when the
      MAC savings dominate it.

    Hermitian symmetry of the real input halves stage 1 (only
    k1 <= N1/2 computed; k1 > N1/2 terms use conj(A) inside the
    precomputed Q2 matrices of stage 2). Stage 2 is two batched einsums
    (contraction N2 per output bin) against host matrices that fold the
    twiddle, both DFT stages' phases, and the conjugate mirror. Output
    bins assemble into the [k2, k1] grid whose row-major flattening IS
    k -- a reshape, not a gather.

    Same zero-fill semantics for negative/overrunning window positions
    as the other frontends (sndenv.go:455-478); equals them to f32
    roundoff (one extra reassociation level, like any HIGHEST-grade
    split).

    Args/returns: identical to :func:`power_spectrum_conv`, with the
    basis replaced by the plan (which pins win = plan.win and requires
    step == plan.step).
    """
    assert step_samples == plan.step, (step_samples, plan.step)
    b, s = signals.shape
    w, n1, n2 = plan.win, plan.n1, plan.n2
    h1, k2, jb = plan.h1, plan.k2, plan.j_blocks
    step = step_samples
    k_bins = w // 2 + 1

    n_frames = n_windows + jb - 1
    basis1 = jnp.asarray(plan.basis1, dtype=signals.dtype)
    # shared zero-fill preamble (sndenv.go:455-478 semantics):
    # [B, n_frames, step] whose flatten is the padded signal grid
    sframes = _step_frames(signals, step, offset0, n_windows, jb)

    if plan.polyphase:
        ss = plan.sub_step
        total = n_frames * step
        sig = sframes.reshape(b, total)

        # polyphase decomposition g[b, n2, m] = sig[b, m*N2 + n2]
        g = jnp.transpose(sig.reshape(b, total // n2, n2), (0, 2, 1))
        frames = g.reshape(b, n2, n_frames, ss)

        acc = None
        for j in range(jb):
            bj = basis1[j * ss : min((j + 1) * ss, n1)]  # [ss_j, 2*H1]
            fr = frames[:, :, j : j + n_windows, : bj.shape[0]]
            term = jnp.matmul(
                fr, bj, precision=precision,
                preferred_element_type=signals.dtype,
            )
            acc = term if acc is None else acc + term
    else:
        # windows from step-frames (shared construction with the windowed
        # frontend), then the [N1, N2] index split n = N2*n1 + n2 is a
        # reshape
        windows = _materialize_windows(
            sframes, n_windows, jb, w
        ).reshape(b, n_windows, n1, n2)
        # one batched einsum: contract n1 against the stage-1 basis,
        # emitting the polyphase-mode layout [B, N2, nW, 2*H1]
        acc = jnp.einsum(
            "bwxn,xh->bnwh", windows, basis1, precision=precision,
            preferred_element_type=signals.dtype,
        )
    ar = acc[..., :h1]  # [B, N2, nW, H1]
    ai = acc[..., h1:]

    qall = jnp.asarray(plan.qall, dtype=signals.dtype)  # [H1, N2, 4*K2]
    ein = lambda a: jnp.einsum(
        "bnwh,hnk->bwhk", a, qall, precision=precision,
        preferred_element_type=signals.dtype,
    )
    p = ein(ar)
    r = ein(ai)
    x1r = p[..., :k2] - r[..., k2 : 2 * k2]
    x1i = p[..., k2 : 2 * k2] + r[..., :k2]
    x2r = p[..., 2 * k2 : 3 * k2] + r[..., 3 * k2 :]
    x2i = p[..., 3 * k2 :] - r[..., 2 * k2 : 3 * k2]
    p1 = x1r * x1r + x1i * x1i  # k1 = 0 .. N1//2
    p2 = x2r * x2r + x2i * x2i  # k1 = N1 - h1 (mirror rows)

    # assemble the [k1, k2] grid: rows N1//2+1..N1-1 are the mirror rows
    # h1 = ceil(N1/2)-1..1 (even N1 skips the self-conjugate N1/2 row;
    # odd N1 has none); transpose to [k2, k1] whose row-major flatten is k
    grid = jnp.concatenate(
        [p1, jnp.flip(p2[:, :, 1 : n1 - h1 + 1, :], axis=2)], axis=2
    )  # [B, nW, N1, K2]
    power = jnp.transpose(grid, (0, 1, 3, 2)).reshape(b, n_windows, k2 * n1)
    return power[..., :k_bins]


def power_spectrum(
    windows: jnp.ndarray,
    method: str = "matmul",
    basis: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
    precision: str = "highest",
) -> jnp.ndarray:
    """[..., W] windows -> [..., W//2+1] DFT power."""
    w = windows.shape[-1]
    if method == "fft":
        coefs = jnp.fft.rfft(windows, axis=-1)
        return jnp.real(coefs) ** 2 + jnp.imag(coefs) ** 2
    if method == "matmul":
        if basis is None:
            cos_m, sin_m = dft_matrices(w)
            cos_m = jnp.asarray(cos_m, dtype=windows.dtype)
            sin_m = jnp.asarray(sin_m, dtype=windows.dtype)
        else:
            cos_m, sin_m = basis
        re = jnp.matmul(
            windows, cos_m, precision=precision,
            preferred_element_type=windows.dtype,
        )
        im = jnp.matmul(
            windows, sin_m, precision=precision,
            preferred_element_type=windows.dtype,
        )
        return re * re + im * im
    raise ValueError(f"unknown spectrum method: {method}")


def smooth_power(power: jnp.ndarray, dft: DFTParams) -> jnp.ndarray:
    """Temporal smoothing over the step axis (axis=-2 of [..., steps, bins]).

    p'_0 = p_0 (step 0 is not smoothed, dft/dft.go:67); for t>0:
    p'_t = prev_smooth * p'_{t-1} + cur_smooth * p_t.
    """
    if dft.prev_smooth == 0.0:
        return power

    ps = jnp.asarray(dft.prev_smooth, dtype=power.dtype)
    cs = jnp.asarray(dft.cur_smooth, dtype=power.dtype)

    # first-order linear recurrence via associative scan:
    # state_t = a_t * state_{t-1} + b_t with a_0=0, b_0=p_0; a_t=ps, b_t=cs*p_t
    steps = power.shape[-2]
    a = jnp.full((steps,), ps, dtype=power.dtype).at[0].set(0)
    a = jnp.broadcast_to(
        a[(None,) * (power.ndim - 2) + (slice(None), None)], power.shape
    )
    b = cs * power
    b = b.at[..., 0, :].set(power[..., 0, :])

    def combine(x, y):
        ax, bx = x
        ay, by = y
        return ax * ay, ay * bx + by

    _, out = jax.lax.associative_scan(combine, (a, b), axis=power.ndim - 2)
    return out


def log_power(power: jnp.ndarray, dft: DFTParams) -> jnp.ndarray:
    """ln(power + LogOffSet) with ==0 -> LogMin (dft/dft.go:73-83)."""
    shifted = power + jnp.asarray(dft.log_offset, dtype=power.dtype)
    safe = jnp.where(shifted == 0, 1.0, shifted)
    return jnp.where(
        shifted == 0,
        jnp.asarray(dft.log_min, dtype=power.dtype),
        jnp.log(safe),
    )


def dft_power_pipeline(
    windows: jnp.ndarray,
    dft: DFTParams,
    method: str = "matmul",
    basis: Optional[Tuple[jnp.ndarray, jnp.ndarray]] = None,
    analysis_window: Optional[jnp.ndarray] = None,
    precision: str = "highest",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """windows [..., steps, W] -> (power, log_power) [..., steps, W//2+1]."""
    if analysis_window is not None:
        windows = windows * analysis_window
    p = power_spectrum(windows, method=method, basis=basis, precision=precision)
    p = smooth_power(p, dft)
    lp = log_power(p, dft) if dft.comp_log_pow else jnp.zeros_like(p)
    return p, lp
