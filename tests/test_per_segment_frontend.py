"""The per-segment uniform frontend (OPT-IN probe path).

When stride % step != 0 (22.05 kHz: stride 2205, step 221 -- Go math.Round
of 220.5, sndenv.go:205) or prev_smooth > 0, no shared global window grid
exists. The per-segment path slices gather-free [B, seg, span] spans
(dsp/dft.py::segment_spans) and runs the uniform GEMM frontends with
segments flattened into the batch axis -- exact math, but with extra
materialization passes, so 'auto' keeps off-grid builds on the gather and
``segment_frontend='per_segment'`` opts in.

These tests pin (a) the routing -- auto->gather off-grid, flat on uniform
grids, per_segment only on opt-in; (b) exact agreement of the opt-in path
with the gather formulation in f64, including the per-segment prev-smooth
recurrence; and (c) the span-slicing helper against a direct gather.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from auditory_tpu.config import SndEnvConfig
from auditory_tpu.pipeline.sndenv import SndEnv
from tests.conftest import tone

OUTS = ("power_segment", "log_power_segment", "mel_fbank_segment",
        "step_valid")


def test_routing_22050_auto_is_gather():
    """'auto' = the measured rule: off-grid builds stay on the gather."""
    env = SndEnv(SndEnvConfig(), 22050, outputs=OUTS)
    t = env.timing
    assert t.stride_samples % t.step_samples != 0  # 2205 % 221
    env._build(3 * 22050, 0)
    assert env._frontend_structure == "gather"


def test_routing_22050_opt_in_per_segment():
    env = SndEnv(SndEnvConfig(), 22050, outputs=OUTS,
                 segment_frontend="per_segment")
    env._build(3 * 22050, 0)
    assert env._frontend_structure == "per_segment"


def test_routing_commensurate_stays_flat():
    """The uniform-grid fast path is untouched by the gate (and
    'per_segment' never hijacks a commensurate grid -- flat wins there)."""
    for sf in ("auto", "per_segment"):
        env = SndEnv(SndEnvConfig(), 16000, outputs=OUTS,
                     segment_frontend=sf)
        env._build(16000, 0)
        assert env._frontend_structure == "flat", sf


def test_routing_forced_gather_on_uniform_grid():
    """'gather' forces the probe baseline even where flat would win."""
    env = SndEnv(SndEnvConfig(), 16000, outputs=OUTS,
                 segment_frontend="gather")
    env._build(16000, 0)
    assert env._frontend_structure == "gather"


def test_bad_segment_frontend_refused():
    with pytest.raises(ValueError, match="segment_frontend"):
        SndEnv(SndEnvConfig(), 16000, outputs=OUTS, segment_frontend="nope")


def test_routing_prev_smooth_auto_is_gather():
    """prev_smooth breaks the shared-window equivalence (dft/dft.go:67-69
    is a per-segment recurrence); 'auto' keeps it on the gather too."""
    cfg = SndEnvConfig()
    cfg = dataclasses.replace(
        cfg, dft=dataclasses.replace(cfg.dft, prev_smooth=0.5)
    )
    env = SndEnv(cfg, 16000, outputs=OUTS)
    env._build(16000, 0)
    assert env._frontend_structure == "gather"
    env2 = SndEnv(cfg, 16000, outputs=OUTS, segment_frontend="per_segment")
    env2._build(16000, 0)
    assert env2._frontend_structure == "per_segment"


@pytest.mark.parametrize("sr,prev_smooth", [
    (22050, 0.0),   # non-commensurate stride/step
    (22050, 0.3),   # ... plus the smoothing recurrence
    (16000, 0.5),   # commensurate but smoothing forces off the flat grid
])
def test_per_segment_matches_gather_f64(sr, prev_smooth):
    """Exact math: the opt-in per-segment GEMM formulation must agree with
    the gather formulation to f64 reassociation noise on power, log-power
    and mel, for every uniform spectrum method."""
    cfg = SndEnvConfig()
    if prev_smooth:
        cfg = dataclasses.replace(
            cfg, dft=dataclasses.replace(cfg.dft, prev_smooth=prev_smooth)
        )
    dur = 0.35  # 3+ segments with borders
    sig = tone(1234.5, dur, sr) + 0.01 * np.random.default_rng(7).normal(
        size=int(dur * sr)
    )
    sig = sig.astype(np.float64)

    for method in ("frames", "conv", "windowed"):
        env = SndEnv(cfg, sr, dtype=jnp.float64, spectrum_method=method,
                     outputs=OUTS, segment_frontend="per_segment")
        out = env.process(env.pad(sig))
        assert env._frontend_structure == "per_segment", method

        genv = SndEnv(cfg, sr, dtype=jnp.float64, spectrum_method=method,
                      outputs=OUTS)
        gout = genv.process(genv.pad(sig))
        assert genv._frontend_structure == "gather"

        for key in ("power_segment", "log_power_segment",
                    "mel_fbank_segment"):
            a = np.asarray(getattr(out, key))
            b = np.asarray(getattr(gout, key))
            np.testing.assert_allclose(a, b, rtol=1e-11, atol=1e-13,
                                       err_msg=f"{method}/{key}")


def test_segment_spans_matches_gather():
    """segment_spans == direct slicing with zero-fill on both borders."""
    from auditory_tpu.dsp.dft import segment_spans

    rng = np.random.default_rng(0)
    b, s = 3, 500
    sig = rng.normal(size=(b, s))
    for stride, span, offset0, nseg in [
        (100, 140, -30, 5),   # left zero-fill + right overrun
        (100, 95, 0, 5),      # span < stride
        (73, 211, -5, 6),     # span ~3x stride, odd sizes
        (120, 120, 40, 4),    # positive offset
    ]:
        got = np.asarray(segment_spans(jnp.asarray(sig), stride, span,
                                       offset0, nseg))
        want = np.zeros((b, nseg, span))
        for g in range(nseg):
            for i in range(span):
                j = offset0 + g * stride + i
                if 0 <= j < s:
                    want[:, g, i] = sig[:, j]
        np.testing.assert_array_equal(got, want, err_msg=str((stride, span,
                                                              offset0, nseg)))
