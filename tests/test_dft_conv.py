"""The strided-conv DFT frontend must agree with the explicit gather +
DFT-matmul formulation for every geometry: even / odd window lengths,
negative window-0 offsets (left zero fill, sndenv.go:455-478), positive
offsets, and windows overrunning the signal."""

import jax.numpy as jnp
import numpy as np
import pytest

from auditory_tpu.dsp.design import dft_matrices
from auditory_tpu.dsp.dft import (
    power_spectrum,
    power_spectrum_conv,
    power_spectrum_frames,
)
from auditory_tpu.dsp.frame import extract_windows


def _reference_power(signals, w, step, offset0, n_windows, basis):
    starts = (np.arange(n_windows, dtype=np.int32) * step + offset0)[None, :]
    windows, valid = extract_windows(
        jnp.asarray(signals), jnp.asarray(starts), w, signals.shape[-1]
    )
    p = power_spectrum(windows, method="matmul", basis=basis)
    # the pipeline masks overrun windows downstream (step-break semantics);
    # the conv path computes them over the zero-extension instead, so only
    # the masked values are comparable
    return np.asarray(p)[:, 0], np.asarray(valid)[0]  # [B, n_win, K], [n_win]


@pytest.mark.parametrize(
    "w,step,offset0",
    [
        (400, 160, -320),   # default 16 kHz geometry incl. border windows
        (400, 160, 0),
        (400, 160, 137),    # positive offset
        (1102, 441, -882),  # 44.1 kHz geometry
        (64, 64, 0),        # non-overlapping
        (101, 40, -80),     # odd W
        (6, 2, -4),         # tiny, heavy overlap
    ],
)
def test_conv_matches_gather_matmul(w, step, offset0):
    rng = np.random.default_rng(hash((w, step, offset0)) % 2**31)
    b = 3
    n_windows = 9
    s = (n_windows - 2) * step + offset0 + w  # last windows overrun -> zeros
    s = max(s, w // 2 + 1)
    signals = rng.standard_normal((b, s))
    cos_m, sin_m = dft_matrices(w)
    basis = (jnp.asarray(cos_m), jnp.asarray(sin_m))

    got = np.asarray(
        power_spectrum_conv(jnp.asarray(signals), basis, step, offset0, n_windows)
    )
    want, valid = _reference_power(signals, w, step, offset0, n_windows, basis)
    assert got.shape == want.shape == (b, n_windows, w // 2 + 1)
    assert valid.any() and not valid.all()  # both regimes exercised
    got = got * valid[None, :, None]
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-12)
    # the shifted-GEMM frames formulation: identical semantics for the same
    # grid (incl. win < step -> single partial block, odd W, overruns)
    got_f = np.asarray(
        power_spectrum_frames(
            jnp.asarray(signals), basis, step, offset0, n_windows
        )
    ) * valid[None, :, None]
    np.testing.assert_allclose(got_f / scale, want / scale, atol=1e-12)
    # the windowed single-GEMM formulation: same grid, same semantics
    from auditory_tpu.dsp.dft import power_spectrum_windows

    got_w = np.asarray(
        power_spectrum_windows(
            jnp.asarray(signals), basis, step, offset0, n_windows
        )
    ) * valid[None, :, None]
    np.testing.assert_allclose(got_w / scale, want / scale, atol=1e-12)
    # the sliced interleaved pure-reshape GEMM formulation: same grid,
    # same semantics (incl. the step >= W single-slot degenerate case)
    from auditory_tpu.dsp.dft import power_spectrum_sliced

    got_s = np.asarray(
        power_spectrum_sliced(
            jnp.asarray(signals), basis, step, offset0, n_windows
        )
    ) * valid[None, :, None]
    np.testing.assert_allclose(got_s / scale, want / scale, atol=1e-12)


def test_frames_win_smaller_than_step():
    """W < step: a single partial frame block per window."""
    rng = np.random.default_rng(5)
    w, step = 48, 100
    signals = rng.standard_normal((2, 1000))
    cos_m, sin_m = dft_matrices(w)
    basis = (jnp.asarray(cos_m), jnp.asarray(sin_m))
    got = np.asarray(
        power_spectrum_frames(jnp.asarray(signals), basis, step, 0, 9)
    )
    want = np.asarray(
        power_spectrum_conv(jnp.asarray(signals), basis, step, 0, 9)
    )
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_windowed_basis():
    """An analysis window folded into the basis rows (the opt-in window_fn
    extension) must pass through the conv frontend unchanged."""
    rng = np.random.default_rng(11)
    w, step, offset0, n_windows, b = 400, 160, -320, 9, 2
    s = (n_windows - 2) * step + offset0 + w
    signals = rng.standard_normal((b, s))
    cos_m, sin_m = dft_matrices(w)
    ham = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(w) / (w - 1))
    basis = (jnp.asarray(cos_m * ham[:, None]), jnp.asarray(sin_m * ham[:, None]))

    got = np.asarray(
        power_spectrum_conv(jnp.asarray(signals), basis, step, offset0, n_windows)
    )
    want, valid = _reference_power(signals, w, step, offset0, n_windows, basis)
    got = got * valid[None, :, None]
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-12)


def test_parseval():
    """Energy check: sum of DFT power over all W bins equals W * signal
    energy (Parseval for the unnormalized DFT); the one-sided [0, W/2]
    spectrum double-counts interior bins."""
    rng = np.random.default_rng(7)
    w, step = 400, 160
    sig = rng.standard_normal((1, w))
    cos_m, sin_m = dft_matrices(w)
    p = np.asarray(
        power_spectrum_conv(
            jnp.asarray(sig), (jnp.asarray(cos_m), jnp.asarray(sin_m)),
            step, 0, 1,
        )
    )[0, 0]
    total = p[0] + p[-1] + 2 * p[1:-1].sum()
    np.testing.assert_allclose(total, w * (sig**2).sum(), rtol=1e-10)


def test_matmul_precision_knob():
    """SndEnv(matmul_precision=...) plumbing: valid values run (identical on
    CPU, where the knob is a numeric no-op), invalid values raise."""
    import pytest as _pytest

    from auditory_tpu.pipeline.sndenv import SndEnv
    from tests.conftest import default_cfg_2d, tone

    sig = tone(900.0, 0.25, 16000).astype(np.float32)
    outs = {}
    for prec in ("highest", "high", "default"):
        env = SndEnv(default_cfg_2d(), 16000, dtype=jnp.float32,
                     matmul_precision=prec)
        outs[prec] = np.asarray(env.process(env.pad(sig)).mel_fbank_segment)
    np.testing.assert_array_equal(outs["highest"], outs["default"])
    np.testing.assert_array_equal(outs["highest"], outs["high"])
    with _pytest.raises(ValueError, match="matmul_precision"):
        SndEnv(default_cfg_2d(), 16000, matmul_precision="fast")


def test_auto_frontend_44k_matches_conv_pipeline():
    """The 'matmul' auto-selection routes odd strides (44.1 kHz step=441,
    gcd(441,128)=1) to the frames GEMMs; outputs must match an explicit
    conv run to f32 roundoff."""
    from auditory_tpu.config import SndEnvConfig
    from auditory_tpu.pipeline.sndenv import SndEnv

    sr = 44100
    rng = np.random.default_rng(3)
    sig = (0.2 * np.sin(2 * np.pi * 1000 * np.arange(sr) / sr)
           + 0.02 * rng.standard_normal(sr)).astype(np.float32)
    cfg = SndEnvConfig()
    outs = ("power_segment", "mel_fbank_segment", "step_valid")
    auto = SndEnv(cfg, sr, dtype=jnp.float32, outputs=outs)  # 'matmul' auto
    conv = SndEnv(cfg, sr, dtype=jnp.float32, spectrum_method="conv",
                  outputs=outs)
    oa = auto.process(auto.pad(sig))
    oc = conv.process(conv.pad(sig))
    pa, pc = np.asarray(oa.power_segment), np.asarray(oc.power_segment)
    assert np.abs(pa - pc).max() / np.abs(pc).max() < 1e-5
    ma, mc = np.asarray(oa.mel_fbank_segment), np.asarray(oc.mel_fbank_segment)
    np.testing.assert_allclose(ma, mc, atol=5e-4)


def test_preferred_frontend_rate_grid():
    """The dispatch rule over the common sample-rate grid (the
    reference's win = 2.5*step family, all J < 4): windowed, the fastest
    frontend on an H100 at 400/160 and 1103/441 (chip_smoke.py phase 3).
    Derived from the default 25 ms window / 10 ms step (sndenv.go:202)."""
    from auditory_tpu.config import SndEnvConfig
    from auditory_tpu.dsp.dft import preferred_spectrum_frontend

    expect = {
        8000: ("windowed", 80),
        16000: ("windowed", 160),   # measured
        22050: ("windowed", 221),   # round(220.5)
        32000: ("windowed", 320),
        44100: ("windowed", 441),   # measured (win 1103)
        48000: ("windowed", 480),
    }
    cfg = SndEnvConfig()
    for sr, (method, step) in expect.items():
        t = cfg.params.derive(sr)
        assert t.step_samples == step, sr
        assert (
            preferred_spectrum_frontend(t.step_samples, t.win_samples)
            == method
        ), sr


def test_preferred_frontend_off_family():
    """The rule's off-family terms (not yet measured on a GPU):
    step >= win degenerates framing to a reshape (frames); heavy overlap
    (J = win/step >= 4) routes large windows to frames when its 128-padded
    per-block contraction total matches windowed's single pad128(win)
    contraction (it then does the same padded MACs without the
    windows-materialization HBM write), to the materialized-windows single
    GEMM otherwise, with the large-window threshold dropping 768 -> 512
    at precision='default' (640x160: conv at 'highest', windowed at
    'default')."""
    from auditory_tpu.dsp.dft import preferred_spectrum_frontend as pref

    # term 1: step >= win -> frames
    assert pref(240, 200) == "frames"
    assert pref(320, 320) == "frames"
    assert pref(640, 640) == "frames"
    # term 2: J >= 4, win <= 768 -> conv
    assert pref(80, 320) == "conv"
    assert pref(160, 640) == "conv"
    assert pref(40, 400) == "conv"
    # term 2: J >= 4, win > 768: frames at equal padded contraction
    # (1200x240: 5*pad(240)=1280 == pad(1200)); windowed when step
    # padding is wasteful (800x160: 5*pad(160)=1280 > pad(800)=896)
    assert pref(240, 1200) == "frames"
    assert pref(160, 800) == "windowed"
    # term 2 precision split: 640x160 -> conv at 'highest'/'high' but
    # windowed at 'default'; the equal-padding frames pick applies only
    # above 'default' 
    assert pref(160, 640, precision="default") == "windowed"
    assert pref(240, 1200, precision="default") == "windowed"
    assert pref(160, 640, precision="high") == "conv"
    # term 3: moderate overlap -> windowed (H100 pins 400x160, 1103x441)
    assert pref(100, 200) == "windowed"
    assert pref(160, 400) == "windowed"
    assert pref(441, 1103) == "windowed"


def test_frame_block_sizes_invariants():
    """`_frame_block_sizes` is the single source of the frames-frontend
    blocking shared by the kernel (`power_spectrum_frames`) and the
    dispatch cost model (`_frames_padded_contraction`); its invariants:
    blocks tile the window exactly, none exceeds the step, only the last
    may be partial, and the degenerate step >= win case is one full-window
    block (framing-as-reshape, dispatch term 1)."""
    from auditory_tpu.dsp.dft import (
        _frame_block_sizes,
        _frames_padded_contraction,
        _pad128,
    )

    for step, win in [(160, 400), (240, 1200), (160, 800), (40, 400),
                      (221, 551), (441, 1103), (37, 100), (1, 5)]:
        blocks = _frame_block_sizes(step, win)
        assert sum(blocks) == win, (step, win)
        assert len(blocks) == -(-win // step), (step, win)
        assert all(0 < b <= step for b in blocks), (step, win)
        assert all(b == step for b in blocks[:-1]), (step, win)
        assert _frames_padded_contraction(step, win) == sum(
            _pad128(b) for b in blocks
        )
    # step >= win: a single full-window block
    assert _frame_block_sizes(240, 200) == (200,)
    assert _frame_block_sizes(320, 320) == (320,)


@pytest.mark.parametrize(
    "w,step,offset0",
    [
        (1200, 480, -960),  # 48 kHz geometry incl. border windows
        (1200, 480, 0),
        (800, 320, -640),   # 32 kHz geometry
        (400, 160, -320),   # 16 kHz geometry
        (400, 160, 137),    # positive offset
        (200, 80, -160),    # 8 kHz geometry
        (1102, 441, -882),  # 44.1 kHz: composite W, N2 coprime to step ->
                            # windows-materialization stage-1 mode
        (551, 221, -442),   # 22.05 kHz: odd N1 (29*19), non-polyphase
    ],
)
def test_factored_matches_gather_matmul(w, step, offset0):
    """The two-stage Cooley-Tukey frontend is exact math: it must agree
    with the dense gather+matmul formulation bit-tight in f64 on every
    composite geometry, incl. left zero-fill and overrun windows."""
    from auditory_tpu.dsp.dft import factored_dft_plan, power_spectrum_factored

    plan = factored_dft_plan(w, step, allow_dominated=True)
    assert plan is not None, (w, step)
    assert plan.n1 * plan.n2 == w
    assert plan.polyphase == (step % plan.n2 == 0)

    rng = np.random.default_rng(hash((w, step, offset0, 7)) % 2**31)
    b, n_windows = 3, 9
    s = max((n_windows - 2) * step + offset0 + w, w // 2 + 1)
    signals = rng.standard_normal((b, s))
    cos_m, sin_m = dft_matrices(w)
    basis = (jnp.asarray(cos_m), jnp.asarray(sin_m))

    got = np.asarray(
        power_spectrum_factored(
            jnp.asarray(signals), plan, step, offset0, n_windows
        )
    )
    want, valid = _reference_power(signals, w, step, offset0, n_windows, basis)
    assert got.shape == want.shape == (b, n_windows, w // 2 + 1)
    got = got * valid[None, :, None]
    scale = np.abs(want).max() or 1.0
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-12)


def test_factored_plan_selection():
    """Prime windows admit no split at all; every composite reference
    geometry is refused BY DEFAULT (the tile-padded cost model ranks
    every split behind the dense GEMMs — factored_dft_plan docstring);
    allow_dominated=True
    still returns the best-ranked split for explicit opt-in runs."""
    from auditory_tpu.dsp.dft import factored_dft_plan

    assert factored_dft_plan(1103, 441) is None  # prime W
    assert factored_dft_plan(401, 160) is None   # prime W
    assert factored_dft_plan(16, 1) is None      # step too small
    assert factored_dft_plan(64, 64) is None     # tiny window
    # default gate: the contraction-padded cost model says the dense
    # GEMM wins at every reference-scale geometry
    assert factored_dft_plan(1102, 441) is None
    assert factored_dft_plan(551, 221) is None
    assert factored_dft_plan(1200, 480) is None
    assert factored_dft_plan(400, 160) is None
    # explicit opt-in: best-ranked split still constructible
    p44 = factored_dft_plan(1102, 441, allow_dominated=True)
    assert p44 is not None and not p44.polyphase
    p22 = factored_dft_plan(551, 221, allow_dominated=True)
    assert p22 is not None and not p22.polyphase and p22.n1 % 2 == 1
    # 48 kHz: the contraction-padded model ranks 48x25 (non-polyphase)
    # ahead of 75x16 (polyphase)
    p48 = factored_dft_plan(1200, 480, allow_dominated=True)
    assert p48 is not None and p48.n1 * p48.n2 == 1200
    # prime windows stay None even when dominated splits are allowed
    assert factored_dft_plan(1103, 441, allow_dominated=True) is None


def test_factored_sndenv_48k_matches_conv_pipeline():
    """spectrum_method='factored' through the full pipeline at 48 kHz
    must match an explicit conv run to f32 roundoff."""
    from auditory_tpu.config import SndEnvConfig, clamp_mel_to_nyquist
    from auditory_tpu.pipeline.sndenv import SndEnv

    sr = 48000
    rng = np.random.default_rng(13)
    sig = (0.2 * np.sin(2 * np.pi * 1000 * np.arange(sr) / sr)
           + 0.02 * rng.standard_normal(sr)).astype(np.float32)
    cfg = clamp_mel_to_nyquist(SndEnvConfig(), sr)
    outs = ("power_segment", "mel_fbank_segment", "step_valid")
    fac = SndEnv(cfg, sr, dtype=jnp.float32, spectrum_method="factored",
                 outputs=outs)
    assert fac.factored_plan is not None
    conv = SndEnv(cfg, sr, dtype=jnp.float32, spectrum_method="conv",
                  outputs=outs)
    of = fac.process(fac.pad(sig))
    oc = conv.process(conv.pad(sig))
    pf, pc = np.asarray(of.power_segment), np.asarray(oc.power_segment)
    assert np.abs(pf - pc).max() / np.abs(pc).max() < 1e-5
    mf, mc = np.asarray(of.mel_fbank_segment), np.asarray(oc.mel_fbank_segment)
    np.testing.assert_allclose(mf, mc, atol=5e-4)


def test_factored_sndenv_rejections():
    """'factored' refuses coprime geometries and analysis windows with
    clear errors instead of silently falling back."""
    import dataclasses

    from auditory_tpu.config import SndEnvConfig, clamp_mel_to_nyquist
    from auditory_tpu.pipeline.sndenv import SndEnv

    outs = ("mel_fbank_segment", "step_valid")
    # 25.0625 ms at 16 kHz -> win 401 (prime): no factored split exists
    cfg = SndEnvConfig()
    cfg = dataclasses.replace(
        cfg, params=dataclasses.replace(cfg.params, win_ms=25.0625)
    )
    with pytest.raises(ValueError, match="no W = N1\\*N2 split"):
        SndEnv(cfg, 16000, spectrum_method="factored", outputs=outs)

    cfg16 = SndEnvConfig()
    cfg16 = dataclasses.replace(
        cfg16, dft=dataclasses.replace(cfg16.dft, window_fn="hamming")
    )
    with pytest.raises(ValueError, match="rectangular"):
        SndEnv(cfg16, 16000, spectrum_method="factored", outputs=outs)


def test_factored_random_geometry_fuzz():
    """Randomized composite geometries: any (win, step) pair the planner
    accepts must be f64-exact vs the dense frames formulation, for random
    offsets and window counts (incl. overruns)."""
    from auditory_tpu.dsp.dft import factored_dft_plan, power_spectrum_factored

    rng = np.random.default_rng(20260818)
    tested = 0
    trials = 0
    while tested < 12 and trials < 200:
        trials += 1
        step = int(rng.integers(8, 300))
        mult = rng.choice([1.5, 2.0, 2.5, 3.0, 5.0])
        w = int(step * mult)
        plan = factored_dft_plan(w, step, allow_dominated=True)
        if plan is None:
            continue
        n_windows = int(rng.integers(2, 8))
        offset0 = int(rng.integers(-w, step))
        b = 2
        s = max((n_windows - 1) * step + offset0 + w - int(rng.integers(0, w)),
                w // 2 + 1)
        sig = rng.standard_normal((b, s))
        cos_m, sin_m = dft_matrices(w)
        basis = (jnp.asarray(cos_m), jnp.asarray(sin_m))
        want = np.asarray(power_spectrum_frames(
            jnp.asarray(sig), basis, step, offset0, n_windows))
        got = np.asarray(power_spectrum_factored(
            jnp.asarray(sig), plan, step, offset0, n_windows))
        scale = np.abs(want).max() or 1.0
        np.testing.assert_allclose(
            got / scale, want / scale, atol=1e-12,
            err_msg=f"w={w} step={step} off={offset0} "
                    f"N1={plan.n1} N2={plan.n2}",
        )
        tested += 1
    assert tested == 12, (tested, trials)
