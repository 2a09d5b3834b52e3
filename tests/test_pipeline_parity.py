"""End-to-end parity: the jitted JAX pipeline vs the literal Go-semantics
oracle, float64, on synthetic signals and the reference WAV assets.

Gate: <= 1e-5 max-abs deviation (BASELINE.json north-star; the f64 path lands
around 1e-9, dominated by summation-order differences in the matmuls).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from auditory_tpu.config import MelParams, SndEnvConfig
from auditory_tpu.io.wav import load_wav
from auditory_tpu.pipeline.sndenv import SndEnv
from auditory_tpu.refemu.goref import SndEnvRef
from tests.conftest import default_cfg_2d, tone

TOL = 1e-5
SR = 16000


def run_both(cfg: SndEnvConfig, signal: np.ndarray, sr: int, add: int = 0,
             spectrum_method: str = "fft", **env_kw):
    ref = SndEnvRef(cfg)
    ref.init(signal, sr)

    env = SndEnv(cfg, sr, dtype=jnp.float64, spectrum_method=spectrum_method,
                 **env_kw)
    out = env.process(signal, add_ms=add)
    return ref, env, out


def assert_segments_match(cfg, signal, sr, add=0, tol=TOL, check_gabor=True,
                          spectrum_method="fft", **env_kw):
    ref, env, out = run_both(cfg, signal, sr, add,
                             spectrum_method=spectrum_method, **env_kw)
    n_seg = max(ref.seg_cnt, 0)
    assert out.power_segment.shape[0] == n_seg

    for seg in range(n_seg):
        ref.process_segment(seg, add)
        np.testing.assert_allclose(
            np.asarray(out.power_segment[seg]), ref.power_segment, atol=tol,
            rtol=0, err_msg=f"power seg {seg}",
        )
        np.testing.assert_allclose(
            np.asarray(out.log_power_segment[seg]), ref.log_power_segment,
            atol=tol, rtol=0, err_msg=f"logpower seg {seg}",
        )
        np.testing.assert_allclose(
            np.asarray(out.mel_fbank_segment[seg]), ref.mel_fbank_segment,
            atol=tol, rtol=0, err_msg=f"mel seg {seg}",
        )
        np.testing.assert_allclose(
            np.asarray(out.energy[seg]), ref.energy, atol=tol, rtol=1e-9,
            err_msg=f"energy seg {seg}",
        )
        if cfg.mel.mfcc:
            np.testing.assert_allclose(
                np.asarray(out.mfcc_segment[seg]), ref.mfcc_segment,
                atol=tol, rtol=1e-9, err_msg=f"mfcc seg {seg}",
            )
            if cfg.mel.deltas:
                np.testing.assert_allclose(
                    np.asarray(out.mfcc_deltas[seg]), ref.mfcc_deltas,
                    atol=tol, rtol=1e-9, err_msg=f"deltas seg {seg}",
                )
                np.testing.assert_allclose(
                    np.asarray(out.mfcc_delta_deltas[seg]),
                    ref.mfcc_delta_deltas, atol=tol, rtol=1e-9,
                    err_msg=f"ddeltas seg {seg}",
                )
        if check_gabor:
            gref = ref.apply_gabor()
            np.testing.assert_allclose(
                np.asarray(out.gabor_raw[seg]), gref, atol=1e-4, rtol=1e-5,
                err_msg=f"gabor seg {seg}",
            )


def test_tone_default_pipeline():
    cfg = default_cfg_2d()
    sig = tone(1000.0, 0.35, SR)
    env = SndEnv(cfg, SR, dtype=jnp.float64)
    sig = env.pad(sig)
    assert_segments_match(cfg, sig, SR)


def test_multitone_44k():
    cfg = default_cfg_2d()
    sig = (
        tone(800.0, 0.25, 44100, 0.3)
        + tone(2000.0, 0.25, 44100, 0.3)
        + tone(5000.0, 0.25, 44100, 0.3)
    )
    env = SndEnv(cfg, 44100, dtype=jnp.float64)
    sig = env.pad(sig)
    assert_segments_match(cfg, sig, 44100)


def test_noise_no_mfcc():
    rng = np.random.default_rng(7)
    cfg = dataclasses.replace(
        default_cfg_2d(), mel=MelParams(mfcc=False, deltas=False)
    )
    sig = rng.normal(scale=0.2, size=int(0.28 * SR))
    env = SndEnv(cfg, SR, dtype=jnp.float64)
    sig = env.pad(sig)
    assert_segments_match(cfg, sig, SR)


def test_silence_and_short_signal():
    """Silence exercises the ==0 -> LogMin floors; a short signal exercises
    the step-overrun break semantics (zero suffix columns)."""
    cfg = default_cfg_2d()
    sig = np.zeros(int(0.15 * SR))
    assert_segments_match(cfg, sig, SR)


def test_unpadded_signal_step_overrun():
    cfg = default_cfg_2d()
    sig = tone(500.0, 0.237, SR)  # deliberately not padded
    assert_segments_match(cfg, sig, SR)


def test_prev_smooth_recurrence():
    cfg = dataclasses.replace(
        default_cfg_2d(),
        dft=dataclasses.replace(default_cfg_2d().dft, prev_smooth=0.4),
    )
    sig = tone(1200.0, 0.25, SR) + tone(300.0, 0.25, SR, 0.2)
    env = SndEnv(cfg, SR, dtype=jnp.float64)
    sig = env.pad(sig)
    assert_segments_match(cfg, sig, SR)


def test_power_only_mode():
    """CompLogPow=false: the log spectrum stays unwritten (zeros) and every
    downstream stage (mel reads raw power) is unaffected (dft/dft.go:73-83
    gate; oracle reproduces the skip)."""
    cfg = default_cfg_2d()
    cfg = dataclasses.replace(
        cfg, dft=dataclasses.replace(cfg.dft, comp_log_pow=False)
    )
    sig = tone(800.0, 0.25, SR)
    env = SndEnv(cfg, SR, dtype=jnp.float64)
    assert_segments_match(cfg, env.pad(sig), SR)


def test_log_floor_variants():
    """Non-default log floors: log_offset=0 sends the zero-padding bins of a
    part-silent signal through the exact ``== 0`` -> LogMin floor
    (dft/dft.go:73-83), and non-default mel floors (mel/mel.go:133-139)
    exercise the fbank's own offset/floor pair."""
    cfg = default_cfg_2d()
    cfg = dataclasses.replace(
        cfg,
        dft=dataclasses.replace(cfg.dft, log_offset=0.0, log_min=-50.0),
        mel=dataclasses.replace(
            cfg.mel,
            fbank=dataclasses.replace(
                cfg.mel.fbank, log_off=1.0, log_min=-5.0
            ),
        ),
    )
    sig = np.concatenate([np.zeros(int(0.12 * SR)), tone(800.0, 0.13, SR)])
    env = SndEnv(cfg, SR, dtype=jnp.float64)
    assert_segments_match(cfg, env.pad(sig), SR)


def test_gaborview_modes():
    cfg = dataclasses.replace(
        default_cfg_2d(), energy_mode="sndenv", delta_mode="gaborview"
    )
    sig = tone(2000.0, 0.25, SR)
    env = SndEnv(cfg, SR, dtype=jnp.float64)
    sig = env.pad(sig)
    assert_segments_match(cfg, sig, SR)


def test_4d_pooled_layout():
    cfg = dataclasses.replace(
        default_cfg_2d(), gbor_out_pools_y=8, gbor_out_pools_x=2,
        gbor_out_units_y=2, gbor_out_units_x=8,
    )
    sig = tone(700.0, 0.25, SR)
    env = SndEnv(cfg, SR, dtype=jnp.float64)
    sig = env.pad(sig)
    assert_segments_match(cfg, sig, SR)


def test_by_time_layout():
    cfg = dataclasses.replace(default_cfg_2d(), by_time=True)
    sig = tone(900.0, 0.25, SR)
    env = SndEnv(cfg, SR, dtype=jnp.float64)
    sig = env.pad(sig)
    assert_segments_match(cfg, sig, SR)


def test_nondivisible_stride():
    """stride %% step != 0 disables the shared-window dedup -> the per-
    (segment, step) grid path must also match the oracle."""
    import dataclasses as dc

    base = default_cfg_2d()
    cfg = dc.replace(base, params=dc.replace(base.params, stride_ms=95.0))
    sig = tone(1100.0, 0.4, SR)
    env = SndEnv(cfg, SR, dtype=jnp.float64)
    assert env._window_grid(2, 0)[1] is None  # dedup off
    sig = env.pad(sig)
    assert_segments_match(cfg, sig, SR)


def test_add_offset():
    cfg = default_cfg_2d()
    sig = tone(1500.0, 0.3, SR)
    env = SndEnv(cfg, SR, dtype=jnp.float64)
    sig = env.pad(sig)
    assert_segments_match(cfg, sig, SR, add=20)


def test_reference_wav_parity(ref_wavs):
    cfg = default_cfg_2d()
    for name in ("800", "noise130ms", "female_la_100ms", "silence_100ms"):
        w = load_wav(ref_wavs[name])
        sig = w.sound_to_tensor()
        env = SndEnv(cfg, w.sample_rate, dtype=jnp.float64)
        sig = env.pad(sig)
        assert_segments_match(cfg, sig, w.sample_rate)


def test_float32_device_path_close():
    """The f32 matmul path (what runs on the GPU) must stay within loose but
    meaningful tolerance of the f64 oracle."""
    cfg = default_cfg_2d()
    sig = tone(1000.0, 0.3, SR)
    env64 = SndEnv(cfg, SR, dtype=jnp.float64, spectrum_method="fft")
    sig = env64.pad(sig)
    env32 = SndEnv(cfg, SR, dtype=jnp.float32, spectrum_method="matmul")
    o64 = env64.process(sig)
    o32 = env32.process(sig)
    mel64 = np.asarray(o64.mel_fbank_segment)
    mel32 = np.asarray(o32.mel_fbank_segment)
    assert np.max(np.abs(mel64 - mel32)) < 5e-3
    g64 = np.asarray(o64.gabor_raw)
    g32 = np.asarray(o32.gabor_raw)
    assert np.max(np.abs(g64 - g32)) < 2e-2


def test_conv_spectrum_parity_f64():
    """The strided-conv frontend (spectrum_method='conv') must match the
    fft+gather path exactly on the uniform grid, including left zero-padding
    and masked overrun steps."""
    cfg = default_cfg_2d()
    sig = tone(1300.0, 0.33, SR)
    env_fft = SndEnv(cfg, SR, dtype=jnp.float64, spectrum_method="fft")
    env_conv = SndEnv(cfg, SR, dtype=jnp.float64, spectrum_method="conv")
    for s in (env_fft.pad(sig), sig):  # padded and overrunning
        o1 = env_fft.process(s)
        o2 = env_conv.process(s)
        np.testing.assert_allclose(
            np.asarray(o1.power_segment), np.asarray(o2.power_segment),
            rtol=1e-9, atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(o1.mel_fbank_segment), np.asarray(o2.mel_fbank_segment),
            atol=1e-7,
        )
        np.testing.assert_array_equal(
            np.asarray(o1.step_valid), np.asarray(o2.step_valid)
        )
    # oracle parity through the conv frontend too
    assert_segments_match(cfg, env_conv.pad(sig), SR)


def test_hamming_window_extension():
    """window_fn is an opt-in extension (the reference applies none); with it
    folded into the DFT basis, matmul/conv and fft paths must agree."""
    import dataclasses as dc

    base = default_cfg_2d()
    cfg = dc.replace(base, dft=dc.replace(base.dft, window_fn="hamming"))
    sig = tone(1000.0, 0.3, SR)
    env_fft = SndEnv(cfg, SR, dtype=jnp.float64, spectrum_method="fft")
    env_conv = SndEnv(cfg, SR, dtype=jnp.float64, spectrum_method="conv")
    sig = env_fft.pad(sig)
    o1, o2 = env_fft.process(sig), env_conv.process(sig)
    np.testing.assert_allclose(
        np.asarray(o1.power_segment), np.asarray(o2.power_segment),
        rtol=1e-9, atol=1e-12,
    )
    # windowing must actually change the spectrum vs rectangular
    o3 = SndEnv(base, SR, dtype=jnp.float64, spectrum_method="fft").process(sig)
    assert np.abs(np.asarray(o1.power_segment) - np.asarray(o3.power_segment)).max() > 1.0


@pytest.mark.parametrize(
    "kw",
    [
        dict(win_ms=20.0, step_ms=5.0, segment_ms=100.0, stride_ms=100.0,
             border_steps=0),
        dict(win_ms=25.0, step_ms=12.5, segment_ms=100.0, stride_ms=50.0,
             border_steps=1),
        # note: larger windows (more bins) with 32 filters overflow the
        # reference's NFilters+2 weight tensor (a Go panic) -> keep win small
        dict(win_ms=16.0, step_ms=8.0, segment_ms=96.0, stride_ms=96.0,
             border_steps=3),
    ],
)
def test_window_geometry_sweep(kw):
    import dataclasses as dc

    from auditory_tpu.config import WindowParams

    base = default_cfg_2d()
    cfg = dc.replace(base, params=WindowParams(**kw))
    env = SndEnv(cfg, SR, dtype=jnp.float64)
    sig = env.pad(tone(1000.0, 0.35, SR))
    assert_segments_match(cfg, sig, SR)


def test_8khz_and_narrow_mel():
    import dataclasses as dc

    from auditory_tpu.config import FilterBank, MelParams

    base = default_cfg_2d()
    cfg = dc.replace(
        base,
        mel=MelParams(fbank=FilterBank(n_filters=26, hi_hz=4000.0)),
    )
    env = SndEnv(cfg, 8000, dtype=jnp.float64)
    sig = env.pad(tone(900.0, 0.4, 8000))
    assert_segments_match(cfg, sig, 8000)


def test_distribute_and_circular_gabors():
    import dataclasses as dc

    from auditory_tpu.config import GaborSet, GaborSpec

    base = default_cfg_2d()
    specs = (
        GaborSpec(wavelen=2.0, orientation=0, sigma_width=0.5, sigma_length=0.3),
        GaborSpec(wavelen=2.0, orientation=0, sigma_width=0.5, sigma_length=0.3),
        GaborSpec(wavelen=2.0, orientation=90, sigma_width=0.5, sigma_length=0.3),
        GaborSpec(wavelen=1.5, circular=True, sigma_width=0.6),
    )
    cfg = dc.replace(
        base,
        gabor=GaborSet(size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
                       distribute=True, specs=specs),
    )
    env = SndEnv(cfg, SR, dtype=jnp.float64)
    sig = env.pad(tone(1100.0, 0.3, SR))
    assert_segments_match(cfg, sig, SR)


def test_go_round_half_steps():
    """segment_ms/step_ms = 10.5 must give 11 steps (Go math.Round), not
    Python banker's 10 (sndenv.go:205)."""
    from auditory_tpu.config import WindowParams, go_round

    assert go_round(10.5) == 11
    assert go_round(-10.5) == -11
    t = WindowParams(segment_ms=105.0, step_ms=10.0).derive(16000)
    assert t.segment_steps == 11 + 2 * 2
    t = WindowParams(segment_ms=125.0, step_ms=10.0).derive(16000)
    assert t.segment_steps == 13 + 2 * 2  # round(12.5) -> 13, not 12


def test_multichannel_segcnt():
    """SegCnt divides by channels (sndenv.go:263-265)."""
    cfg = default_cfg_2d()
    env1 = SndEnv(cfg, SR, dtype=jnp.float64, channels=1)
    env2 = SndEnv(cfg, SR, dtype=jnp.float64, channels=2)
    n = 48000
    t = env1.timing
    assert env1.seg_cnt(n) == (n - t.segment_samples) // t.stride_samples + 1
    assert env2.seg_cnt(n) == (n - t.segment_samples * 2) // 2 // t.stride_samples + 1
    # the traced mask agrees with the static count
    sig = np.zeros(n)
    out2 = env2.process(sig)
    assert out2.power_segment.shape[0] == env2.seg_cnt(n)


def test_mixed_pools_rejected():
    import dataclasses as dc

    cfg = dc.replace(default_cfg_2d(), gbor_out_pools_y=4, gbor_out_pools_x=0)
    with pytest.raises(ValueError):
        SndEnv(cfg, SR)


def test_conv_method_off_grid_falls_back_to_matmul():
    """spectrum_method='conv' must work when the uniform window grid is
    unavailable (prev_smooth recurrence): identical math via the matmul
    basis, not a ValueError."""
    import dataclasses

    from tests.conftest import default_cfg_2d, tone

    cfg = default_cfg_2d()
    cfg = dataclasses.replace(
        cfg, dft=dataclasses.replace(cfg.dft, prev_smooth=0.5)
    )
    sig = tone(800.0, 0.3, 16000)
    outs = {}
    for m in ("conv", "matmul"):
        env = SndEnv(cfg, 16000, dtype=jnp.float64, spectrum_method=m)
        outs[m] = np.asarray(
            env.process(env.pad(sig)).mel_fbank_segment
        )
    np.testing.assert_array_equal(outs["conv"], outs["matmul"])


def test_mel_only_no_gabor_specs():
    """Empty gabor specs = a valid mel/MFCC-only pipeline when no gabor
    outputs are requested; requesting them raises a clear error."""
    import pytest as _pytest

    from auditory_tpu.config import SndEnvConfig
    from tests.conftest import tone

    cfg = SndEnvConfig()  # default: gabor.specs=()
    with _pytest.raises(ValueError, match="no active specs"):
        SndEnv(cfg, 16000)
    env = SndEnv(cfg, 16000, dtype=jnp.float64,
                 outputs=("mel_fbank_segment", "mfcc_segment", "step_valid"))
    out = env.process(env.pad(tone(900.0, 0.3, 16000)))
    assert out.mel_fbank_segment.shape[-2] == 32
    assert out.gabor_raw is None and out.gabor_kwta is None


def test_mel_span_guard_matches_oracle():
    """mel_design raises for triangles spanning more than NFilters+2 bins,
    exactly when the oracle (Go panic) does."""
    import pytest as _pytest

    from auditory_tpu.config import FilterBank
    from auditory_tpu.dsp.design import mel_design
    from auditory_tpu.refemu import goref

    fb = FilterBank(n_filters=8)
    with _pytest.raises(ValueError, match="NFilters\\+2"):
        mel_design(fb, 400, 16000)
    with _pytest.raises(ValueError):
        goref.init_filters(fb, 400.0, 16000.0)
    # and a config the oracle accepts still designs fine
    ok = FilterBank(n_filters=32)
    w = mel_design(ok, 400, 16000).weights
    goref.init_filters(ok, 400.0, 16000.0)
    assert w.shape == (32, 201)


def test_go_round_double_rounding_edge():
    """Go math.Round(0.49999999999999994) == 0; floor(x+0.5) would give 1."""
    from auditory_tpu.config import go_round

    x = 0.49999999999999994  # largest double < 0.5
    assert go_round(x) == 0
    assert go_round(-x) == 0
    assert go_round(0.5) == 1
    assert go_round(-0.5) == -1
    assert go_round(1.5) == 2
    assert go_round(2.5) == 3


def test_windowed_pipeline_matches_oracle():
    """The opt-in analysis window must have oracle coverage: production
    (hamming folded into the basis) vs SndEnvRef with the same window."""
    import dataclasses

    from auditory_tpu.refemu.goref import SndEnvRef
    from tests.conftest import default_cfg_2d, tone

    cfg = default_cfg_2d()
    cfg = dataclasses.replace(
        cfg, dft=dataclasses.replace(cfg.dft, window_fn="hamming")
    )
    sig = tone(1100.0, 0.3, 16000)
    env = SndEnv(cfg, 16000, dtype=jnp.float64, spectrum_method="matmul")
    out = env.process(env.pad(sig))

    ref = SndEnvRef(cfg)
    ref.init(env.pad(sig), 16000)
    ref.process_segment(0)
    np.testing.assert_allclose(
        np.asarray(out.mel_fbank_segment[0]), ref.mel_fbank_segment,
        atol=1e-9, rtol=1e-9,
    )


def test_energy_mode_gaborview_matches_oracle():
    """cfg.energy_mode='gaborview' now has direct SndEnvRef coverage."""
    import dataclasses

    from auditory_tpu.refemu.goref import SndEnvRef
    from tests.conftest import default_cfg_2d, tone

    cfg = dataclasses.replace(default_cfg_2d(), energy_mode="gaborview")
    sig = tone(900.0, 0.3, 16000)
    env = SndEnv(cfg, 16000, dtype=jnp.float64, spectrum_method="fft")
    out = env.process(env.pad(sig))
    ref = SndEnvRef(cfg)
    ref.init(env.pad(sig), 16000)
    ref.process_segment(0)
    np.testing.assert_allclose(
        np.asarray(out.energy[0]), ref.energy, atol=1e-6, rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(out.mfcc_segment[0])[0], ref.mfcc_segment[0],
        atol=1e-6, rtol=1e-9,
    )


def test_oracle_panic_guards():
    """Configs the reference crashes on must raise in the oracle too."""
    import dataclasses

    import pytest as _pytest

    from auditory_tpu.refemu.goref import SndEnvRef, dct1
    from tests.conftest import default_cfg_2d

    with _pytest.raises(ValueError, match="NewDCT"):
        dct1(np.zeros(1))
    cfg = dataclasses.replace(
        default_cfg_2d(), gbor_out_pools_y=5, gbor_out_pools_x=0,
        gbor_out_units_y=2, gbor_out_units_x=8,
    )
    ref = SndEnvRef(cfg)
    with _pytest.raises(ValueError, match="both"):
        ref.init(np.zeros(4000), 16000)
