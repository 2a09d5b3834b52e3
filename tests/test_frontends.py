"""The three XLA spectrum frontends that the dispatch rule chooses among
(conv / frames / windowed) through the full f32 pipeline: output
selection, batching and the folded analysis window must not change what
each frontend computes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from auditory_tpu.pipeline.batch import BatchedSndEnv, bucket_length
from auditory_tpu.pipeline.sndenv import SndEnv
from tests.conftest import default_cfg_2d, tone

SR = 16000
FRONTENDS = ("conv", "frames", "windowed")


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_output_selection_matches_full_run(frontend):
    """A mel-only env drops the wide power/log-power fields yet computes
    the same mel; an MFCC env without power_segment still runs the Energy
    chain that feeds coef0."""
    cfg = default_cfg_2d()
    full = SndEnv(cfg, SR, dtype=jnp.float32, spectrum_method=frontend)
    sig = full.pad(tone(1234.0, 0.3, SR)).astype(np.float32)
    ref = full.process(sig)

    mel_env = SndEnv(cfg, SR, dtype=jnp.float32, spectrum_method=frontend,
                     outputs=("mel_fbank_segment", "step_valid"))
    got = mel_env.process(sig)
    assert got.power_segment is None and got.log_power_segment is None
    np.testing.assert_allclose(
        np.asarray(got.mel_fbank_segment), np.asarray(ref.mel_fbank_segment),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_array_equal(
        np.asarray(got.step_valid), np.asarray(ref.step_valid)
    )

    mfcc_env = SndEnv(cfg, SR, dtype=jnp.float32, spectrum_method=frontend,
                      outputs=("mfcc_segment", "energy", "step_valid"))
    got = mfcc_env.process(sig)
    assert got.power_segment is None
    np.testing.assert_allclose(
        np.asarray(got.energy), np.asarray(ref.energy), rtol=1e-6, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(got.mfcc_segment), np.asarray(ref.mfcc_segment),
        rtol=1e-5, atol=1e-4,
    )


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_batched_matches_single(frontend):
    """A padded batch of different-length utterances equals each utterance
    run alone, segment by segment (padding masked, border windows read the
    left zero-fill)."""
    cfg = default_cfg_2d()
    env = SndEnv(cfg, SR, dtype=jnp.float32, spectrum_method=frontend,
                 outputs=("mel_fbank_segment", "gabor_raw", "step_valid"))
    sigs = [env.pad(tone(400 + 250 * i, d, SR)).astype(np.float32)
            for i, d in enumerate([0.25, 0.4, 0.18])]
    smax = bucket_length(max(len(s) for s in sigs), env.timing)
    batch = np.zeros((len(sigs), smax), np.float32)
    lengths = np.array([len(s) for s in sigs], np.int32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s
    out, seg_valid = BatchedSndEnv(env).process(batch, lengths)
    seg_valid = np.asarray(seg_valid)
    for i, s in enumerate(sigs):
        one = env.process(s)
        n = one.mel_fbank_segment.shape[0]
        assert seg_valid[i].sum() == n
        # the batch and the single run contract at different shapes, so
        # f32 sums round differently; log-mel's quiet bins magnify that,
        # hence the linear-domain comparison (plus a log-domain cap)
        m1 = np.asarray(out.mel_fbank_segment)[i, :n]
        m2 = np.asarray(one.mel_fbank_segment)
        np.testing.assert_allclose(np.exp(m1), np.exp(m2), rtol=2e-3,
                                   atol=1e-6, err_msg=f"row {i}")
        np.testing.assert_allclose(m1, m2, atol=2e-2, err_msg=f"row {i}")
        g1 = np.asarray(out.gabor_raw)[i, :n]
        g2 = np.asarray(one.gabor_raw)
        assert np.abs(g1 - g2).max() <= 1e-3 * np.abs(g2).max(), i
        np.testing.assert_array_equal(
            np.asarray(out.step_valid)[i, :n], np.asarray(one.step_valid)
        )


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_folded_analysis_window(frontend):
    """With window_fn set, the analysis window is folded into the DFT
    basis rows; the f32 frontend must match the float64 FFT path that
    multiplies the windows explicitly, incl. the unpadded signal's
    overrunning steps."""
    base = default_cfg_2d()
    cfg = dataclasses.replace(
        base, dft=dataclasses.replace(base.dft, window_fn="hamming")
    )
    outs = ("power_segment", "mel_fbank_segment", "step_valid")
    sig = tone(987.0, 0.217, SR)  # unpadded: the last steps overrun
    env = SndEnv(cfg, SR, dtype=jnp.float32, spectrum_method=frontend,
                 outputs=outs)
    ref_env = SndEnv(cfg, SR, dtype=jnp.float64, spectrum_method="fft",
                     outputs=outs)
    got = env.process(sig.astype(np.float32))
    ref = ref_env.process(sig)
    np.testing.assert_array_equal(
        np.asarray(got.step_valid), np.asarray(ref.step_valid)
    )
    p, r = np.asarray(got.power_segment), np.asarray(ref.power_segment)
    assert np.abs(p - r).max() <= 1e-5 * np.abs(r).max()
    np.testing.assert_allclose(
        np.exp(np.asarray(got.mel_fbank_segment)),
        np.exp(np.asarray(ref.mel_fbank_segment)), rtol=1e-3, atol=1e-6,
    )
    # the window must actually change the spectrum vs rectangular
    rect = SndEnv(base, SR, dtype=jnp.float32, spectrum_method=frontend,
                  outputs=outs).process(sig.astype(np.float32))
    assert np.abs(np.asarray(rect.power_segment) - p).max() > 1.0
