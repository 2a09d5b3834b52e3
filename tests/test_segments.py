"""gaborview-equivalent segment pipeline: resize arithmetic, steps quirk,
stage parity against the literal oracle building blocks."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from auditory_tpu.config import (
    DFTParams,
    GaborSet,
    KWTAParams,
    MelParams,
    default_gabor_specs,
)
from auditory_tpu.config import msec_to_samples
from auditory_tpu.pipeline.segments import (
    SegmentPipeline,
    SegmentWindowParams,
    resize_segment,
)
from auditory_tpu.refemu import goref
from tests.conftest import tone

SR = 16000


def gbv_gabor() -> GaborSet:
    # gbv.go InitGabors: 8x8, stride (6,3), gain 1.5, 4 orientations, phase 0
    return GaborSet(
        size_x=8, size_y=8, stride_x=6, stride_y=3, gain=1.5,
        specs=default_gabor_specs(phases=(0.0,)),
    )


def test_resize_widen_short_segment():
    # duration 50ms < sizeX*step = 80ms -> widen by 30ms, split half/half
    s, e = resize_segment(100.0, 150.0, 10.0, gbv_gabor())
    assert (s, e) == (85.0, 165.0)


def test_resize_stride_alignment():
    # duration 100ms: d = 20, rem = 20 % 60 = 20 -> add 40, half before/after
    s, e = resize_segment(100.0, 200.0, 10.0, gbv_gabor())
    assert (s, e) == (80.0, 220.0)
    # already aligned: duration 140 -> d=60, rem=0 -> unchanged
    s, e = resize_segment(100.0, 240.0, 10.0, gbv_gabor())
    assert (s, e) == (100.0, 240.0)


def test_resize_negative_start_extends_end():
    s, e = resize_segment(10.0, 60.0, 10.0, gbv_gabor())
    assert s == 10.0 and e == 90.0  # add=30 all appended


def test_steps_total_quirk():
    p = SegmentPipeline(SR, SegmentWindowParams(resize=False), gabor=gbv_gabor())
    # gbv.go:489-491: segmentMs += stepMs * (int(segmentMs) % int(stepMs))
    assert p.steps_total(0.0, 105.0) == 15  # 105 + 10*5 = 155 -> 15 steps
    assert p.steps_total(0.0, 100.0) == 10  # aligned -> unchanged


def test_segment_stage_parity_vs_oracle():
    """mel/power of a slice must match the literal per-step oracle run at the
    same window starts (gbv.go ProcessStep semantics)."""
    wp = SegmentWindowParams(resize=True, border_steps=0)
    mel_params = MelParams()
    pipe = SegmentPipeline(
        SR, wp, mel=mel_params, gabor=gbv_gabor(),
        kwta=KWTAParams(on=False), dtype=jnp.float64, spectrum_method="fft",
    )
    sig = tone(1100.0, 0.5, SR)
    start_ms, end_ms, steps = pipe.setup(120.0, 260.0)
    out = pipe.process(sig, 120.0, 260.0)

    n_bins = pipe.win_samples // 2 + 1
    nf = mel_params.fbank.n_filters
    power = np.zeros(n_bins)
    logpow = np.zeros(n_bins)
    power_seg = np.zeros((n_bins, steps))
    logpow_seg = np.zeros((n_bins, steps))
    fbank = np.zeros(nf)
    mel_seg = np.zeros((nf, steps))
    mfcc_seg = np.zeros((mel_params.n_coefs, steps))
    bin_pts, _, tri = goref.init_filters(mel_params.fbank, pipe.win_samples, SR)

    start_sample = msec_to_samples(start_ms, SR)
    for s in range(steps):
        st = start_sample + pipe.step_samples * (s - wp.border_steps)
        en = st + pipe.win_samples
        if en > len(sig):
            break
        if st < 0:
            window = np.concatenate([np.zeros(-st), sig[:en]])
        else:
            window = sig[st:en]
        goref.dft_filter(
            pipe.dft, s, window, pipe.win_samples, power, logpow,
            power_seg, logpow_seg,
        )
        goref.filter_dft(mel_params, s, power, mel_seg, fbank, tri, bin_pts)
        goref.cepstrum_dct(mel_params, s, fbank, mfcc_seg)

    np.testing.assert_allclose(
        np.asarray(out["power_segment"]), power_seg, atol=1e-6, rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(out["mel_fbank_segment"]), mel_seg, atol=1e-5, rtol=0
    )
    # energy: gbv quirk = sum over first `steps` freq rows at step s
    e_ref = logpow_seg[:steps, :].sum(axis=0)
    np.testing.assert_allclose(np.asarray(out["energy"]), e_ref, atol=1e-6, rtol=1e-9)
    # coef0 overwritten with energy
    np.testing.assert_allclose(
        np.asarray(out["mfcc_segment"])[0], e_ref, atol=1e-6, rtol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(out["mfcc_segment"])[1:], mfcc_seg[1 : mel_params.n_coefs],
        atol=1e-5, rtol=1e-9,
    )


def test_segment_gabor_shape_gbv_formula():
    pipe = SegmentPipeline(
        SR, SegmentWindowParams(resize=True), gabor=gbv_gabor(),
        kwta=KWTAParams(on=False), dtype=jnp.float64, spectrum_method="fft",
    )
    sig = tone(800.0, 0.6, SR)
    out = pipe.process(sig, 100.0, 240.0)
    steps = pipe.steps_total(*pipe.setup(100.0, 240.0)[:2])
    g = pipe.gabor
    n_mel = 32
    sy = ((n_mel - g.size_y) // g.stride_y + 1) * 2
    sx = ((steps - g.size_x) // g.stride_x + 1) * g.n_filters
    assert np.asarray(out["gabor_raw"]).shape == (sy, sx)
    assert np.asarray(out["gabor_kwta"]).shape == (sy, sx)


def test_segment_kwta_on():
    pipe = SegmentPipeline(SR, gabor=gbv_gabor())
    sig = tone(600.0, 0.5, SR)
    out = pipe.process(sig, 50.0, 200.0)
    raw = np.asarray(out["gabor_raw"])
    kw = np.asarray(out["gabor_kwta"])
    assert kw.shape == raw.shape
    assert (kw > 0.1).mean() <= (raw > 0.1).mean() + 1e-9


def test_compare_segments_api():
    """A/B dual-parameter comparison (gbv.go:243-258): two independent param
    stacks over the same slice must produce the documented differing shapes
    and values, and the diff summary must reflect it."""
    from auditory_tpu.pipeline.segments import compare_segments

    sig = tone(1000.0, 0.5, SR)
    pipe_a = SegmentPipeline(
        SR, SegmentWindowParams(), gabor=gbv_gabor(),
        dtype=jnp.float64, spectrum_method="fft",
    )
    # B: different gabor gain and fewer mel filters; same gabor geometry so
    # the resize (which depends on size/stride, gbv.go:456-479) is identical
    # and the window/power stages stay comparable
    gset_b = GaborSet(
        size_x=8, size_y=8, stride_x=6, stride_y=3, gain=3.0,
        specs=default_gabor_specs(phases=(0.0,)),
    )
    # 40 mel filters (26 would make the widest triangle span more than
    # NFilters+2 bins -- a config the Go reference panics on, now guarded
    # by mel_design like the oracle)
    pipe_b = SegmentPipeline(
        SR, SegmentWindowParams(),
        mel=MelParams(fbank=dataclasses.replace(
            MelParams().fbank, n_filters=40)),
        gabor=gset_b, dtype=jnp.float64, spectrum_method="fft",
    )
    res = compare_segments(pipe_a, pipe_b, sig, 50.0, 330.0)
    a, b, diff = res["a"], res["b"], res["diff"]
    # differing mel filter count -> differing mel shape
    assert np.asarray(a["mel_fbank_segment"]).shape[0] == 32
    assert np.asarray(b["mel_fbank_segment"]).shape[0] == 40
    assert "max_abs_diff" not in diff["mel_fbank_segment"]
    # differing mel height -> differing gabor output height
    ga = np.asarray(a["gabor_raw"])
    gb = np.asarray(b["gabor_raw"])
    assert ga.shape != gb.shape
    # same-shaped tensors get an elementwise diff: power is identical
    # (same window params), so max_abs_diff == 0
    assert diff["power_segment"]["max_abs_diff"] == pytest.approx(0.0)
    for k in ("a", "b"):
        assert diff["gabor_raw"][k]["active_frac"] > 0


def test_compare_segments_different_slices():
    """B may analyze a different slice (CurSnd1 vs CurSnd2)."""
    from auditory_tpu.pipeline.segments import compare_segments

    sig = tone(800.0, 0.6, SR)
    pipe = SegmentPipeline(
        SR, SegmentWindowParams(), gabor=gbv_gabor(),
        dtype=jnp.float64, spectrum_method="fft",
    )
    res = compare_segments(
        pipe, pipe, sig, 50.0, 200.0, start_ms_b=300.0, end_ms_b=450.0
    )
    # same config + pure steady tone, different slice: shapes agree
    assert (np.asarray(res["a"]["mel_fbank_segment"]).shape
            == np.asarray(res["b"]["mel_fbank_segment"]).shape)
    assert "max_abs_diff" in res["diff"]["mel_fbank_segment"]


def test_cli_segment_compare(tmp_path):
    from auditory_tpu.cli import main
    from auditory_tpu.io.wav import float_to_wave, write_wav

    p = str(tmp_path / "t.wav")
    write_wav(p, float_to_wave(tone(1200.0, 0.4, SR), SR))
    out = str(tmp_path / "cmp.npz")
    rc = main([
        "segment", p, "--start-ms", "40", "--end-ms", "200",
        "--compare", "--b-gabor-gain", "3.0",
        "--out", out, "--f64",
    ])
    assert rc == 0
    d = np.load(out)
    # same windows -> identical power on both sides
    np.testing.assert_allclose(
        d["a_power_segment"], d["b_power_segment"], rtol=0, atol=0
    )
    # gain 1.5 vs 3.0 -> raw gabor activations scale by exactly 2
    np.testing.assert_allclose(
        2.0 * d["a_gabor_raw"], d["b_gabor_raw"], rtol=1e-9
    )


def test_segment_bounds_validated():
    """gbv.go:451-454: SegmentEnd <= SegmentStart is an error."""
    pipe = SegmentPipeline(SR, SegmentWindowParams(), gabor=gbv_gabor())
    sig = tone(600.0, 0.5, SR)
    with pytest.raises(ValueError, match="SegmentEnd"):
        pipe.process(sig, 400.0, 380.0)
    with pytest.raises(ValueError, match="SegmentEnd"):
        pipe.process(sig, 200.0, 200.0)


def test_segment_default_gabor_bank_matches_gbv():
    """A default-constructed SegmentPipeline carries gbv's InitGabors bank
    (4 orientations), not an empty spec list."""
    pipe = SegmentPipeline(SR)
    assert pipe.gabor.n_filters == 4
    assert pipe.gabor_bank.shape == (4, 8, 8)


def test_segment_window_fn_honored():
    """DFTParams.window_fn must reach the spectrum: the matmul path (window
    folded into the basis) and the fft path (explicit multiply) agree, and
    both differ from the rectangular default."""
    sig = tone(1000.0, 0.4, SR)
    outs = {}
    for m in ("matmul", "fft"):
        p = SegmentPipeline(
            SR, SegmentWindowParams(), dft=DFTParams(window_fn="hamming"),
            gabor=gbv_gabor(), dtype=jnp.float64, spectrum_method=m,
        )
        outs[m] = np.asarray(p.process(sig, 50.0, 330.0)["power_segment"])
    np.testing.assert_allclose(outs["matmul"], outs["fft"],
                               rtol=1e-9, atol=1e-12)
    rect = SegmentPipeline(
        SR, SegmentWindowParams(), gabor=gbv_gabor(),
        dtype=jnp.float64, spectrum_method="fft",
    )
    r = np.asarray(rect.process(sig, 50.0, 330.0)["power_segment"])
    assert np.max(np.abs(r - outs["fft"])) > 1e-3


def test_compare_segments_both_none_skipped():
    """Keys disabled on BOTH sides (mfcc off) must not appear as 'only_in'."""
    from auditory_tpu.pipeline.segments import compare_segments

    sig = tone(800.0, 0.5, SR)
    mel_off = MelParams(mfcc=False)
    pipe = SegmentPipeline(
        SR, SegmentWindowParams(), mel=mel_off, gabor=gbv_gabor(),
        dtype=jnp.float64, spectrum_method="fft",
    )
    res = compare_segments(pipe, pipe, sig, 50.0, 300.0)
    assert "mfcc_segment" not in res["diff"]


def test_cli_segment_compare_html_report(tmp_path):
    """--html writes ONE self-contained report embedding both runs: params
    (differing row flagged), diff stats, and base64 figures (the browsable
    half of gaborview's A/B explorer)."""
    pytest.importorskip("matplotlib")
    from auditory_tpu.cli import main
    from auditory_tpu.io.wav import float_to_wave, write_wav

    p = str(tmp_path / "t.wav")
    write_wav(p, float_to_wave(tone(1200.0, 0.4, SR), SR))
    out = str(tmp_path / "cmp.npz")
    report = str(tmp_path / "cmp.html")
    rc = main([
        "segment", p, "--start-ms", "40", "--end-ms", "200",
        "--compare", "--b-gabor-gain", "3.0",
        "--out", out, "--html", report, "--f64",
    ])
    assert rc == 0
    html_src = open(report, encoding="utf-8").read()
    # self-contained: figures ride inline, no file references
    assert html_src.count("data:image/png;base64,") >= 2
    assert ".png" not in html_src.split("base64,")[0]
    # params table shows both stacks and flags the differing gain row
    assert "gabor_gain" in html_src and "differs" in html_src
    assert ">1.5<" in html_src and ">3<" in html_src
    # diff stats for the outputs that exist on both sides
    assert "mel_fbank_segment" in html_src and "max|B−A|" in html_src


def test_write_compare_html_mapping_and_only_in(tmp_path):
    """Direct API: mapping input, an only-on-one-side key, and param dicts."""
    pytest.importorskip("matplotlib")
    from auditory_tpu.utils.report import write_compare_html

    rng = np.random.default_rng(0)
    data = {
        "a_mel": rng.random((8, 6)),
        "b_mel": rng.random((8, 6)),
        "a_energy": rng.random(6),
        "b_energy": rng.random(6),
    }
    diff = {
        "mel": {
            "a": {"shape": [8, 6], "max_abs": 1.0, "mean": 0.5,
                  "active_frac": 1.0},
            "b": {"shape": [8, 6], "max_abs": 0.9, "mean": 0.4,
                  "active_frac": 1.0},
            "active_frac_delta": 0.0,
            "max_abs_diff": 0.3,
        },
        "mfcc": {"only_in": "a"},
    }
    out = write_compare_html(
        data, str(tmp_path / "r.html"),
        params_a={"gain": 1.5}, params_b={"gain": 1.5},
        diff=diff, title="unit test", keys=["mel"],
    )
    src = open(out, encoding="utf-8").read()
    assert "unit test" in src
    assert "only computed on side A" in src
    assert src.count("data:image/png;base64,") == 1  # keys filter honored


def test_segment_pipeline_batched_slices():
    """[B, S] input: every slice is processed (review finding: the previous
    code returned batch element 0 with a stray axis and silently discarded
    slices 1..B-1); each row must equal its own single-slice run."""
    from auditory_tpu.pipeline.segments import SegmentPipeline

    sr = 16000
    pipe = SegmentPipeline(sr)
    rng = np.random.default_rng(9)
    # dithered tones (CLAUDE.md): log-mel of a PURE tone reads the FFT
    # noise floor in stop bins, which differs meaninglessly across lowerings
    sigs = np.stack([
        tone(500.0 + 300 * i, 1.0, sr) + 0.01 * rng.standard_normal(sr)
        for i in range(3)
    ]).astype(np.float32)
    batch = pipe.process(sigs, 100.0, 300.0)
    assert batch["mel_fbank_segment"].shape[0] == 3
    assert batch["step_valid"].ndim == 1  # shared slice geometry
    for i in range(3):
        one = pipe.process(sigs[i], 100.0, 300.0)
        # f32-roundoff tolerance: XLA lowers the B=3 and B=1 GEMMs with
        # different tilings, so bitwise equality does not hold
        np.testing.assert_allclose(
            np.asarray(batch["mel_fbank_segment"][i]),
            np.asarray(one["mel_fbank_segment"]), rtol=1e-5, atol=1e-4,
        )
        np.testing.assert_allclose(
            np.asarray(batch["gabor_kwta"][i]),
            np.asarray(one["gabor_kwta"]), rtol=1e-4, atol=1e-3,
        )
