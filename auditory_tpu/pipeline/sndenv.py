"""The SndEnv pipeline: WAV signal -> power/log-power -> mel -> MFCC(+deltas)
-> gabor -> (neighbor inhibition) -> (kwta), for all segments of an utterance
-- or a whole padded batch of utterances -- in one jitted tensor program.

Batched replacement for the reference orchestrator ``sound.SndEnv``
(sound/sndenv.go:73-497). Where the reference loops one window at a time
(ProcessSegment -> ProcessStep, sndenv.go:342-452), this builds a single XLA
graph over [batch, n_segments, segment_steps] windows: one strided-conv or
GEMM DFT frontend (or a window gather off the uniform grid), one mel
matmul, one DCT matmul, one grouped conv -- fused by XLA and executed
batched on the accelerator.

Output arrays keep the reference's per-segment shapes with leading
[batch, segment] axes, e.g. ``power_segment[b, seg]`` == the reference's
PowerSegment [freq, step] after ProcessSegment(seg) on utterance b.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SndEnvConfig, msec_to_samples
from ..dsp import design
from ..dsp.dft import UNIFORM_SPECTRUM_METHODS, dft_power_pipeline
from ..dsp.frame import extract_windows, pad_signal, window_starts
from ..dsp.gabor import convolve, gabor_out_counts, to_layout_2d
from ..dsp.mel import apply_mel, energy, mfcc_dct, mfcc_deltas
from ..nn.kwta import kwta_layer, kwta_pool
from ..nn.neigh_inhib import inhib4

__all__ = ["SndEnvOutputs", "SndEnv"]


@jax.tree_util.register_dataclass
@dataclass
class SndEnvOutputs:
    """Pipeline outputs; leading axes [batch, segment] (batch squeezed away
    by :meth:`SndEnv.process`).

    Shapes follow the reference tensors (sndenv.go:95-163):
      power_segment      [.., n_bins, steps]     <- PowerSegment
      log_power_segment  [.., n_bins, steps]     <- LogPowerSegment
      mel_fbank_segment  [.., n_mel, steps]      <- MelFBankSegment
      energy             [.., steps]             <- Energy
      mfcc_segment       [.., n_coefs, steps]    <- MFCCSegment
      mfcc_deltas        [.., n_coefs, steps]    <- MFCCDeltas
      mfcc_delta_deltas  [.., n_coefs, steps]    <- MFCCDeltaDeltas
      gabor_raw          [.., ...]               <- GborOutput (2-D or 4-D layout)
      gabor_kwta         [.., ...]               <- GborKwta
      step_valid         [.., steps] bool        (True where the reference
                                                  would have processed the step)
      mel_fbank_global   [.., n_flat, n_mel]     (opt-in, transfer-side form:
                                                  the deduped global step grid
                                                  mel_fbank_segment is gathered
                                                  from -- UNMASKED; only
                                                  available on the uniform
                                                  window grid, else None. Expand
                                                  via SndEnv.global_grid.)
    """

    power_segment: Any
    log_power_segment: Any
    mel_fbank_segment: Any
    energy: Any
    mfcc_segment: Optional[Any]
    mfcc_deltas: Optional[Any]
    mfcc_delta_deltas: Optional[Any]
    gabor_raw: Any
    gabor_kwta: Any
    step_valid: Any
    mel_fbank_global: Optional[Any] = None


def _tree_squeeze0(out):
    return jax.tree_util.tree_map(lambda x: x[0], out)


class SndEnv:
    """Configured pipeline for a fixed sample rate.

    Usage::

        env = SndEnv(cfg, sample_rate=16000)
        out = env.process(signal)           # all segments, device arrays

    ``process`` jit-compiles per distinct signal length; call
    :func:`dsp.frame.pad_signal` / :func:`pipeline.batch.bucket_length` to
    bucket lengths.
    """

    # all selectable output fields
    ALL_OUTPUTS = (
        "power_segment",
        "log_power_segment",
        "mel_fbank_segment",
        "energy",
        "mfcc_segment",
        "mfcc_deltas",
        "mfcc_delta_deltas",
        "gabor_raw",
        "gabor_kwta",
        "step_valid",
        "mel_fbank_global",
    )

    def __init__(
        self,
        cfg: SndEnvConfig,
        sample_rate: int,
        dtype=jnp.float32,
        spectrum_method: Optional[str] = None,
        outputs: Optional[Tuple[str, ...]] = None,
        channels: int = 1,
        feature_stats: bool = False,
        matmul_precision: str = "highest",
        segment_frontend: str = "auto",
    ):
        """``feature_stats``: additionally return per-mel-band moment
        accumulators (sum, sumsq, count over all valid steps) for corpus
        feature normalization; on a sharded mesh this reduction is the
        pipeline's one cross-device collective.

        ``channels``: number of interleaved channels in the signal, used
        only by the SegCnt arithmetic (sndenv.go:263-265 divides by
        Sound.Channels()); the reference's SndToWindow itself is mono-only.

        ``outputs``: which SndEnvOutputs fields to return (None = all).
        Dropping fields lets XLA dead-code-eliminate their materialization --
        e.g. the reference's PowerSegment/LogPowerSegment are visualization
        tensors ("more useful for visualization", dft/dft.go:17) that corpus
        extraction rarely needs.

        ``matmul_precision``: contraction precision for the device pipeline.
        'highest' (default) = full f32 -- required for the GPU-vs-CPU f32
        equivalence contract (``chip_smoke.py`` phase 1). On an H100,
        'high' and 'default' both run f32 products in TF32 and grade alike
        against the CPU f32 run (phase 2, 8 rows x 3 s): power 1.4e-4
        relative to its peak, log-mel 6.8e-2 absolute at the quietest bins,
        gabor 8.6e-4 relative to its peak, gabor_kwta 3.0e-2 absolute. CPU
        results are unaffected by this knob. The MFCC delta operator always
        runs at 'highest' (its NaN-reachability formulation is
        precision-critical).

        ``segment_frontend``: how to structure the frontend when no shared
        global window grid exists (stride % step != 0, e.g. 22.05 kHz; or
        prev_smooth > 0). 'auto' (default) = the per-window gather.
        'per_segment' = gather-free segment spans + the conv/frames/
        windowed GEMM frontends per segment (dsp/dft.py::segment_spans),
        which adds span and window materialization passes; whether it
        beats the gather on a GPU has not been measured. 'gather' forces
        the gather even on uniform grids (a probe baseline)."""
        self.cfg = cfg
        self.sample_rate = sample_rate
        self.channels = int(channels)
        self.feature_stats = bool(feature_stats)
        if outputs is not None:
            unknown = set(outputs) - set(self.ALL_OUTPUTS)
            if unknown:
                raise ValueError(f"unknown outputs: {sorted(unknown)}")
        self.outputs = tuple(outputs) if outputs is not None else None
        if cfg.gabor.n_filters == 0:
            gabor_keys = {"gabor_raw", "gabor_kwta"}
            requested = set(self.outputs) if self.outputs else gabor_keys
            if requested & gabor_keys:
                raise ValueError(
                    "cfg.gabor has no active specs (empty or all Off) but "
                    "gabor outputs are requested; pass outputs=(...) "
                    "without gabor_raw/gabor_kwta for a mel/MFCC-only "
                    "pipeline, or provide gabor specs"
                )
        if matmul_precision not in ("highest", "high", "default"):
            raise ValueError(
                "matmul_precision must be 'highest', 'high' or 'default', "
                f"got {matmul_precision!r}"
            )
        self.matmul_precision = matmul_precision
        if segment_frontend not in ("auto", "per_segment", "gather"):
            raise ValueError(
                "segment_frontend must be 'auto', 'per_segment' or "
                f"'gather', got {segment_frontend!r}"
            )
        self.segment_frontend = segment_frontend
        self.dtype = jnp.dtype(dtype)
        self.timing = cfg.params.derive(sample_rate)
        if spectrum_method is None:
            spectrum_method = "matmul" if self.dtype == jnp.float32 else "fft"
        self.spectrum_method = spectrum_method

        if (cfg.gbor_out_pools_x > 0) != (cfg.gbor_out_pools_y > 0):
            raise ValueError(
                "GborOutPoolsX & GborOutPoolsY must both be == 0 or > 0 "
                "(2D or 4D; sndenv.go:220-222)"
            )
        # host-built constants
        self.mel_des = design.mel_design(
            cfg.mel.fbank, self.timing.win_samples, sample_rate
        )
        self.dct_mat = design.dct1_matrix(cfg.mel.fbank.n_filters)
        self.gabor_bank = design.gabor_filters(cfg.gabor)
        self.analysis_win = design.analysis_window(
            cfg.dft.window_fn, self.timing.win_samples
        )
        if spectrum_method in UNIFORM_SPECTRUM_METHODS:
            cos_m, sin_m = design.dft_matrices(self.timing.win_samples)
            if self.analysis_win is not None:
                # fold the analysis window into the DFT basis rows
                cos_m = cos_m * self.analysis_win[:, None]
                sin_m = sin_m * self.analysis_win[:, None]
            self.dft_basis = (cos_m, sin_m)
        else:
            self.dft_basis = None
        self.factored_plan = None
        if spectrum_method == "factored":
            from ..dsp.dft import factored_dft_plan

            if self.analysis_win is not None:
                raise ValueError(
                    "spectrum_method='factored' requires the reference's "
                    "rectangular window (window_fn=None): a nontrivial "
                    "analysis window can't be factored across the two "
                    "Cooley-Tukey stages"
                )
            # explicit opt-in: run the best-ranked split even where the
            # cost model ranks it below the dense GEMMs (factored_dft_plan)
            self.factored_plan = factored_dft_plan(
                self.timing.win_samples,
                self.timing.step_samples,
                allow_dominated=True,
            )
            if self.factored_plan is None:
                raise ValueError(
                    "spectrum_method='factored': no W = N1*N2 split "
                    f"for win={self.timing.win_samples}, "
                    f"step={self.timing.step_samples} (prime window or "
                    "tiny geometry; such geometries stay on "
                    "'frames'/'conv')"
                )

        self._orients = tuple(
            s.with_defaults().orientation for s in cfg.gabor.active_specs()
        )
        self._jit_cache: Dict[Tuple, Any] = {}

    # ------------------------------------------------------------------
    # geometry helpers
    # ------------------------------------------------------------------

    @property
    def is_4d(self) -> bool:
        # sndenv.go:214-223: both pools zero => 2-D layout
        return self.cfg.gbor_out_pools_x > 0 and self.cfg.gbor_out_pools_y > 0

    def gabor_output_shape(self) -> Tuple[int, ...]:
        cfg = self.cfg
        n_mel = cfg.mel.fbank.n_filters
        steps = self.timing.segment_steps
        nf = cfg.gabor.n_filters
        if self.is_4d:
            return (cfg.gbor_out_pools_y, cfg.gbor_out_pools_x, 2, nf)
        fc, tc = gabor_out_counts((n_mel, steps), cfg.gabor, None)
        uy = cfg.gbor_out_units_y or fc * 2
        ux = cfg.gbor_out_units_x or tc * nf
        return (uy, ux)

    def seg_cnt(self, n_samples: int) -> int:
        return self.timing.seg_cnt(n_samples, self.channels)

    def global_grid(self, n_samples: int, add_ms: int = 0):
        """Host-side expansion metadata for ``mel_fbank_global``:
        (map_idx [seg, steps] global-row index per (segment, step) or None
        when the uniform grid is unavailable, window_ends [seg, steps]).
        Expansion contract (for segments ``s < seg_cnt_b``)::

            valid = window_ends[s, i] <= length_b
            mel_fbank_segment[b, s, :, i] =
                where(valid, mel_fbank_global[b, map_idx[s, i]], 0)

        Use where/select, NOT multiplication by the mask: the mel NaN
        triangle quirk means gathered values can be NaN, and NaN * 0 != 0
        (see CorpusRunner._write_entry)."""
        seg = max(self.seg_cnt(n_samples), 0)
        _, map_idx, starts_np = self._window_grid(seg, add_ms)
        ends = starts_np + self.timing.win_samples
        return map_idx, ends

    # ------------------------------------------------------------------
    # core program (natively batched: signals [B, S], lengths [B])
    # ------------------------------------------------------------------

    def _window_grid(self, seg_cnt: int, add_ms: int):
        """The (segment, step) -> window-start geometry.

        When StrideSamples is a multiple of StepSamples (the default: 100 ms
        stride / 10 ms step), consecutive segments' windows lie on one global
        step grid and border windows are *shared*: segment s, step i is
        global window s*(stride/step) + i. In that case the front end runs
        once per distinct window (~28% less DFT/mel work at the default
        geometry) and segments are materialized by a static row-gather of the
        small spectra instead of the 400-sample windows.

        Returns (flat_starts [n_flat], map_idx [seg, steps] into flat, or
        None when every (seg, step) is its own window).
        """
        t = self.timing
        starts_np = window_starts(t, seg_cnt, add_ms)
        if (
            seg_cnt > 0
            and t.stride_samples > 0
            and t.stride_samples % t.step_samples == 0
            # per-segment smoothing recurrence (dft/dft.go:67-69) breaks the
            # shared-window equivalence
            and self.cfg.dft.prev_smooth == 0.0
        ):
            sps = t.stride_samples // t.step_samples
            n_global = (seg_cnt - 1) * sps + t.segment_steps
            add = starts_np[0, 0] - t.step_samples * (0 - self.cfg.params.border_steps)
            g_starts = (
                t.step_samples
                * (np.arange(n_global, dtype=np.int64) - self.cfg.params.border_steps)
                + add
            ).astype(np.int32)
            map_idx = (
                np.arange(seg_cnt, dtype=np.int32)[:, None] * sps
                + np.arange(t.segment_steps, dtype=np.int32)[None, :]
            )
            assert (g_starts[map_idx] == starts_np).all()
            return g_starts, map_idx, starts_np
        return starts_np.reshape(-1), None, starts_np

    def _frontend_xla(self, signals, starts2d, signal_len, basis, awin):
        """windows gather + DFT power + log (XLA path).
        signals [B, S], starts2d [G0, G1] -> power/logp [B, G0, G1, n_bins].
        (For the deduped global grid G0=1; for the per-segment grid
        G0=seg, G1=steps so the prev-smooth scan runs over the step axis.)"""
        windows, _ = extract_windows(
            signals, starts2d, self.timing.win_samples, signal_len
        )
        power, logp = dft_power_pipeline(
            windows,
            self.cfg.dft,
            # 'conv'/'frames'/'factored' exist only on the uniform window
            # grid; off-grid the identical math runs as the windows @
            # basis matmul
            method=(
                "matmul"
                if self.spectrum_method in UNIFORM_SPECTRUM_METHODS
                else self.spectrum_method
            ),
            basis=basis,
            analysis_window=awin if self.spectrum_method == "fft" else None,
            precision=self.matmul_precision,
        )
        return power, logp

    def _uniform_power_fn(self, basis):
        """Resolve the uniform-grid spectrum method once per build and
        return ``fn(sig2d [N, S], offset0, n_windows) -> power
        [N, n_windows, bins]``.

        'matmul' (the default) auto-selects by the dispatch rule
        (preferred_spectrum_frontend: conv / frames / windowed by
        overlap factor, stride alignment and window size); 'factored'
        backfills its plan, with prime/refused geometries falling back to
        frames rather than passing a None plan downstream.
        """
        from ..dsp.dft import (
            factored_dft_plan,
            power_spectrum_conv,
            power_spectrum_factored,
            power_spectrum_frames,
            power_spectrum_sliced,
            power_spectrum_windows,
            preferred_spectrum_frontend,
        )

        t = self.timing
        method = self.spectrum_method
        if method == "matmul":
            method = preferred_spectrum_frontend(
                t.step_samples, t.win_samples,
                precision=self.matmul_precision,
            )
        if method == "factored" and self.factored_plan is None:
            # auto-dispatch route (a future rule may return 'factored')
            self.factored_plan = factored_dft_plan(
                t.win_samples, t.step_samples
            )
            if self.factored_plan is None:
                method = "frames"
        if method == "factored":
            plan = self.factored_plan

            def fn(sig2d, offset0, n_windows):
                return power_spectrum_factored(
                    sig2d, plan, t.step_samples, offset0, n_windows,
                    precision=self.matmul_precision,
                )

            return fn

        frontend = {
            "frames": power_spectrum_frames,
            "windowed": power_spectrum_windows,
            "sliced": power_spectrum_sliced,
        }.get(method, power_spectrum_conv)

        def fn(sig2d, offset0, n_windows):
            return frontend(
                sig2d, basis, t.step_samples, offset0, n_windows,
                precision=self.matmul_precision,
            )

        return fn

    def _build(self, n_samples: int, add_ms: int):
        """Returns program(signals [B, S], lengths [B]) ->
        (SndEnvOutputs with [B, seg, ...] axes, seg_valid [B, seg])."""
        cfg = self.cfg
        t = self.timing
        seg_cnt_static = max(self.seg_cnt(n_samples), 0)
        flat_starts_np, map_idx_np, starts_np = self._window_grid(
            seg_cnt_static, add_ms
        )
        map_idx = jnp.asarray(map_idx_np) if map_idx_np is not None else None
        mel_w = jnp.asarray(self.mel_des.weights, dtype=self.dtype)
        dct_m = jnp.asarray(self.dct_mat, dtype=self.dtype)
        gab = jnp.asarray(self.gabor_bank, dtype=self.dtype)
        basis = (
            tuple(jnp.asarray(b, dtype=self.dtype) for b in self.dft_basis)
            if self.dft_basis is not None
            else None
        )
        awin = (
            jnp.asarray(self.analysis_win, dtype=self.dtype)
            if self.analysis_win is not None
            else None
        )
        pools = (
            (cfg.gbor_out_pools_y, cfg.gbor_out_pools_x) if self.is_4d else None
        )
        n_mel = cfg.mel.fbank.n_filters
        steps = t.segment_steps
        uniform_methods = UNIFORM_SPECTRUM_METHODS
        uniform_power = (
            self._uniform_power_fn(basis)
            if (
                self.spectrum_method in uniform_methods
                and self.segment_frontend != "gather"
            )
            else None
        )

        # per-segment uniform grid (opt-in): when no shared global step
        # grid exists (stride % step != 0, e.g. 22.05 kHz stride 2205 /
        # step 221; or prev_smooth > 0), the windows within ONE segment
        # are still uniformly strided -- verify the affine structure
        # host-side (window_starts: s*stride + i*step + const). 'auto'
        # routes off-grid builds to the gather (see __init__'s
        # segment_frontend docstring).
        per_seg_affine = False
        if (
            self.segment_frontend == "per_segment"
            and map_idx_np is None
            and seg_cnt_static > 0
            and t.stride_samples > 0
            and starts_np.ndim == 2
        ):
            model = (
                int(starts_np[0, 0])
                + t.stride_samples
                * np.arange(seg_cnt_static, dtype=np.int64)[:, None]
                + t.step_samples
                * np.arange(t.segment_steps, dtype=np.int64)[None, :]
            )
            per_seg_affine = bool((model == starts_np).all())
        # introspection for tests/tools: 'flat' | 'per_segment' | 'gather'
        # (which frontend structure this build runs)
        self._frontend_structure = (
            "flat"
            if map_idx_np is not None and uniform_power is not None
            else "per_segment"
            if per_seg_affine and uniform_power is not None
            else "gather"
        )

        def post_power(power):
            """log + mel from the (smoothed) power -- shared tail of both
            uniform-grid frontend branches."""
            from ..dsp.dft import log_power

            need_full_logp = (
                self.outputs is None or "log_power_segment" in self.outputs
            )
            if need_full_logp and cfg.dft.comp_log_pow:
                logp = log_power(power, cfg.dft)
            elif need_full_logp:
                logp = jnp.zeros_like(power)
            else:
                logp = None  # energy uses the narrow slice below
            mel_vals = apply_mel(
                power, mel_w, cfg.mel.fbank, precision=self.matmul_precision
            )
            return logp, mel_vals

        def _apply_kwta(fn, raw, ext_gi=None):
            """kwta over each [seg] layer of [B, seg, ...]."""
            b, s = raw.shape[0], raw.shape[1]
            flat = raw.reshape((b * s,) + raw.shape[2:])
            if ext_gi is not None:
                eg = ext_gi.reshape((b * s,) + ext_gi.shape[2:])
                out = jax.vmap(fn)(flat, eg)
            else:
                out = jax.vmap(fn)(flat)
            return out.reshape(raw.shape)

        def program(signals: jnp.ndarray, lengths: jnp.ndarray):
            signals = signals.astype(self.dtype)
            lengths = jnp.asarray(lengths)
            if map_idx is not None and uniform_power is not None:
                # uniform global window grid, no materialized windows and
                # no gather: 'frames' = J shifted dense GEMMs over
                # step-aligned frames (power_spectrum_frames); 'conv' =
                # ONE strided conv (power_spectrum_conv); 'windowed' =
                # ONE dense GEMM over gather-free materialized windows;
                # 'factored' = two-stage Cooley-Tukey GEMMs (composite
                # windows only). 'matmul' (the default) auto-selects by
                # the dispatch rule (_uniform_power_fn).
                power = uniform_power(
                    signals,
                    int(flat_starts_np[0]),
                    int(flat_starts_np.shape[0]),
                )
                logp, mel_vals = post_power(power)
            elif per_seg_affine and uniform_power is not None:
                # per-segment uniform grid (stride % step != 0 and/or
                # prev_smooth > 0): slice gather-free [B, seg, span]
                # segment spans (two reshapes, sndenv.go:455-478 zero-fill
                # via _step_frames), flatten segments into the batch axis
                # and run the SAME fast GEMM frontends with offset0=0;
                # the per-segment prev-smooth recurrence (dft/dft.go:67-69)
                # then applies over the step axis of the reshaped power.
                from ..dsp.dft import segment_spans, smooth_power

                span = (steps - 1) * t.step_samples + t.win_samples
                spans = segment_spans(
                    signals,
                    t.stride_samples,
                    span,
                    int(starts_np[0, 0]),
                    seg_cnt_static,
                )
                bsz = spans.shape[0]
                power = uniform_power(
                    spans.reshape(bsz * seg_cnt_static, span), 0, steps
                )
                power = power.reshape(
                    bsz, seg_cnt_static, steps, power.shape[-1]
                )
                power = smooth_power(power, cfg.dft)
                logp, mel_vals = post_power(power)
            else:
                starts2d = (
                    flat_starts_np[None, :] if map_idx is not None else starts_np
                )
                power, logp = self._frontend_xla(
                    signals, jnp.asarray(starts2d), lengths, basis, awin
                )
                mel_vals = apply_mel(power, mel_w, cfg.mel.fbank, precision=self.matmul_precision)
                if map_idx is not None:  # [B, 1, n_flat, k] -> [B, n_flat, k]
                    power, logp, mel_vals = (
                        power[:, 0], logp[:, 0], mel_vals[:, 0]
                    )

            # step validity from the per-(seg, step) starts (sndenv.go:353-359
            # break semantics; see dsp/frame.py)
            ends = jnp.asarray(starts_np) + t.win_samples  # [seg, steps]
            valid = ends[None] <= lengths[:, None, None]
            vmask = valid[..., None]

            # Energy reads only a narrow slice of the log-power bins (the
            # reference's indexing quirks, dsp/mel.py::energy): computing the
            # full-width log and expanding it per segment just to sum 'steps'
            # bins costs a wide transcendental + gather, so take the slice at
            # the power stage (log of a slice == slice of the log).
            from ..dsp.dft import log_power as _log_power

            en_bins = steps if cfg.energy_mode in ("sndenv", "gaborview") else None
            en_src = power[..., :en_bins] if en_bins else power
            if cfg.dft.comp_log_pow:
                logp_narrow = _log_power(en_src, cfg.dft)
            else:
                logp_narrow = jnp.zeros_like(en_src)

            need_power = self.outputs is None or "power_segment" in self.outputs
            need_logp = (
                self.outputs is None or "log_power_segment" in self.outputs
            )

            # transfer-side deduped form: the global-grid mel BEFORE the
            # segment gather and BEFORE any masking (callers expand + mask
            # host-side; see SndEnv.global_grid). Opt-in output.
            mel_global = (
                mel_vals
                if (
                    map_idx is not None
                    and self.outputs is not None
                    and "mel_fbank_global" in self.outputs
                )
                else None
            )

            if map_idx is not None:
                # materialize segments from the shared global windows: static
                # row-gathers over the *small* spectra (wide power/log-power
                # only when those tensors are requested)
                mel_vals = mel_vals[:, map_idx]
                logp_narrow = logp_narrow[:, map_idx]
                power = power[:, map_idx] if need_power else None
                logp = (
                    logp[:, map_idx]
                    if (need_logp and logp is not None)
                    else None
                )
            else:
                if not need_power:
                    power = None
                if not need_logp:
                    logp = None

            if power is not None:
                power = jnp.where(vmask, power, 0)
            if logp is not None:
                logp = jnp.where(vmask, logp, 0)
            mel_vals = jnp.where(vmask, mel_vals, 0)
            logp_narrow = jnp.where(vmask, logp_narrow, 0)
            en = energy(logp_narrow, cfg.energy_mode)  # [B, seg, steps]

            mfcc = deltas = ddeltas = None
            if cfg.mel.mfcc:
                mfcc = mfcc_dct(mel_vals, dct_m, cfg.mel.n_coefs, precision=self.matmul_precision)
                mfcc = jnp.where(vmask, mfcc, 0)
                # coef0 <- Energy for ALL steps (sndenv.go:368-372; runs after
                # the step loop regardless of step validity)
                mfcc = mfcc.at[..., 0].set(en)
                if cfg.mel.deltas:
                    deltas = mfcc_deltas(mfcc, npn=2, mode=cfg.delta_mode)
                    ddeltas = mfcc_deltas(deltas, npn=2, mode=cfg.delta_mode)

            # gabor over the [n_mel, steps] mel matrix (sndenv.go:481-497)
            mel_fs = jnp.swapaxes(mel_vals, -1, -2)  # [B, seg, n_mel, steps]
            if cfg.gabor.n_filters == 0:
                # mel/MFCC-only configuration (no active gabor specs):
                # __init__ guarantees no gabor outputs were requested
                gabor_raw = gabor_kwta = None
                gab4 = None
            else:
                gab4 = convolve(mel_fs, gab, cfg.gabor, out_pools=pools,
                                precision=self.matmul_precision)
                # [B, seg, fc, tc, 2, nf]
            if gab4 is None:
                pass
            elif self.is_4d:
                py, px = pools
                fc, tc = gab4.shape[-4], gab4.shape[-3]
                gabor_raw = jnp.zeros(
                    gab4.shape[:2] + (py, px, 2, gab4.shape[-1]),
                    dtype=jnp.float32,
                )
                gabor_raw = gabor_raw.at[:, :, :fc, :tc].set(gab4)
                ext_gi = inhib4(cfg.neigh_inhib, gabor_raw, self._orients)
                if cfg.kwta.on:
                    fn = (
                        (lambda g, e: kwta_pool(cfg.kwta, g, e))
                        if cfg.kwta_pool
                        else (lambda g, e: kwta_layer(cfg.kwta, g, e))
                    )
                    gabor_kwta = _apply_kwta(fn, gabor_raw, ext_gi)
                else:
                    gabor_kwta = gabor_raw
            else:
                _, tms = gabor_out_counts((n_mel, steps), cfg.gabor, None)
                gabor_raw = to_layout_2d(gab4, cfg.by_time, tms)
                uy, ux = self.gabor_output_shape()
                if gabor_raw.shape[-2:] != (uy, ux):
                    buf = jnp.zeros(
                        gabor_raw.shape[:2] + (uy, ux), dtype=jnp.float32
                    )
                    buf = buf.at[
                        :, :, : gabor_raw.shape[-2], : gabor_raw.shape[-1]
                    ].set(gabor_raw)
                    gabor_raw = buf
                # NeighInhib is 4-D only (gbv.go:823-828) => no ext_gi in 2-D
                if cfg.kwta.on:
                    gabor_kwta = _apply_kwta(
                        lambda g: kwta_layer(cfg.kwta, g), gabor_raw
                    )
                else:
                    gabor_kwta = gabor_raw

            # per-utterance SegCnt mask (sndenv.go:263-265, Go truncating
            # division, including the division by Channels())
            ch = self.channels
            siglen = lengths.astype(jnp.int32) - t.segment_samples * ch
            siglen = jnp.sign(siglen) * (jnp.abs(siglen) // ch)
            seg_cnt = jnp.sign(siglen) * (jnp.abs(siglen) // t.stride_samples) + 1
            seg_idx = jnp.arange(seg_cnt_static, dtype=jnp.int32)
            seg_valid = seg_idx[None, :] < seg_cnt[:, None]  # [B, seg]

            def seg_mask(x):
                if x is None:
                    return None
                m = seg_valid.reshape(seg_valid.shape + (1,) * (x.ndim - 2))
                return jnp.where(m, x, jnp.zeros((), dtype=x.dtype))

            out = SndEnvOutputs(
                power_segment=(
                    jnp.swapaxes(power, -1, -2) if power is not None else None
                ),
                log_power_segment=(
                    jnp.swapaxes(logp, -1, -2) if logp is not None else None
                ),
                mel_fbank_segment=mel_fs,
                energy=en,
                mfcc_segment=(
                    jnp.swapaxes(mfcc, -1, -2) if mfcc is not None else None
                ),
                mfcc_deltas=(
                    jnp.swapaxes(deltas, -1, -2) if deltas is not None else None
                ),
                mfcc_delta_deltas=(
                    jnp.swapaxes(ddeltas, -1, -2) if ddeltas is not None else None
                ),
                gabor_raw=gabor_raw,
                gabor_kwta=gabor_kwta,
                step_valid=valid,
            )
            out = jax.tree_util.tree_map(seg_mask, out, is_leaf=lambda x: x is None)
            out = dataclasses.replace(
                out,
                step_valid=out.step_valid & seg_valid[..., None],
                # the global grid has no [B, seg] leading axes: attach AFTER
                # the seg mask (host-side expansion applies the masks)
                mel_fbank_global=mel_global,
            )
            if self.outputs is not None:
                out = dataclasses.replace(
                    out,
                    **{
                        f: None
                        for f in self.ALL_OUTPUTS
                        if f not in self.outputs
                    },
                )
            if self.feature_stats:
                # per-mel-band moment accumulators over all VALID steps of all
                # utterances: on a batch-sharded mesh these reductions make
                # XLA insert the cross-device all-reduce (the only collective
                # the pipeline needs; SURVEY.md section 5)
                fmask = (valid & seg_valid[..., None])[..., None]
                mel_valid = jnp.where(fmask, mel_vals, 0)
                stats = {
                    "sum": jnp.sum(mel_valid, axis=(0, 1, 2)),
                    "sumsq": jnp.sum(mel_valid * mel_valid, axis=(0, 1, 2)),
                    "count": jnp.sum(fmask.astype(mel_vals.dtype)),
                }
                return out, seg_valid, stats
            return out, seg_valid

        return program

    def process_fn(self, n_samples: int, add_ms: int = 0):
        """The jitted batched program for signals of ``n_samples`` samples."""
        key = (n_samples, add_ms)
        if key not in self._jit_cache:
            program = self._build(n_samples, add_ms)
            self._jit_cache[key] = jax.jit(program)
        return self._jit_cache[key]

    def process(
        self, signal: np.ndarray, add_ms: int = 0, signal_len: Optional[int] = None
    ) -> SndEnvOutputs:
        """Process one utterance (all segments); batch axis squeezed away."""
        signal = jnp.asarray(signal)
        n = signal.shape[-1]
        fn = self.process_fn(n, add_ms)
        res = fn(
            signal[None],
            jnp.asarray([n if signal_len is None else signal_len]),
        )
        return _tree_squeeze0(res[0])

    def pad(self, signal: np.ndarray, value: float = 0.0) -> np.ndarray:
        """SndEnv.Pad (sndenv.go:510-519)."""
        return pad_signal(np.asarray(signal), self.timing, value)

    def adjust_for_silence(
        self, signal: np.ndarray, add: float, existing: float
    ) -> Tuple[np.ndarray, int]:
        """SndEnv.AdjustForSilence (sndenv.go:274-294); host-side trim/pad."""
        offset = 0
        out = np.asarray(signal)
        if add >= 0:
            if add < existing:
                offset = int(existing - add)
                n = msec_to_samples(float(offset), self.sample_rate)
                out = out[n:]
            elif add > existing:
                offset = int(add - existing)
                n = msec_to_samples(float(offset), self.sample_rate)
                out = np.concatenate([np.zeros(n, dtype=out.dtype), out])
        return out, offset
