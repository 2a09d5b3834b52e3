"""Host design constants vs the literal oracle: mel triangles, DCT-I, gabors."""

import numpy as np
import pytest

from auditory_tpu.config import FilterBank, GaborSet, GaborSpec, default_gabor_specs
from auditory_tpu.dsp import design
from auditory_tpu.refemu import goref


@pytest.mark.parametrize(
    "sr,win,nf,lo,hi",
    [
        (16000, 400, 32, 0.0, 8000.0),
        (44100, 1102, 32, 0.0, 8000.0),
        (16000, 400, 26, 300.0, 4000.0),
        (44100, 1102, 40, 120.0, 10000.0),
        (16000, 400, 64, 0.0, 8000.0),  # narrow filters -> NaN quirk territory
    ],
)
def test_mel_design_matches_oracle(sr, win, nf, lo, hi):
    fb = FilterBank(n_filters=nf, lo_hz=lo, hi_hz=hi)
    des = design.mel_design(fb, win, sr)
    bin_pts, hz_pts, tri = goref.init_filters(fb, win, sr)
    np.testing.assert_array_equal(des.bin_pts, bin_pts)
    np.testing.assert_allclose(des.hz_pts, hz_pts, rtol=1e-12)

    # compare the dense matrix row-by-row against the oracle's per-filter
    # weight vectors at the bins FilterDft would touch
    n_bins = win // 2 + 1
    for f in range(nf):
        bmin, bmax = int(bin_pts[f]), int(bin_pts[f + 2])
        dense_row = des.weights[f]
        # outside [bmin, bmax] the dense matrix must be exactly zero
        outside = np.ones(n_bins, dtype=bool)
        outside[bmin : bmax + 1] = False
        assert np.all(dense_row[outside] == 0)
        for fi, b in enumerate(range(bmin, bmax + 1)):
            ref = tri[f, fi]
            got = dense_row[b]
            if np.isnan(ref):
                assert np.isnan(got), (f, b)
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


def test_mel_nan_quirk_reproduced():
    """Many filters at low sample resolution force adjacent mel points into
    the same bin -> 0/0 NaN weights (mel/mel.go:99-116)."""
    fb = FilterBank(n_filters=80, lo_hz=0.0, hi_hz=4000.0)
    des = design.mel_design(fb, 256, 8000)
    _, _, tri = goref.init_filters(fb, 256, 8000)
    assert np.isnan(tri).any(), "expected the oracle to produce NaN weights"
    assert np.isnan(des.weights).any(), "dense design must reproduce the NaN quirk"


def test_dct1_matrix_matches_oracle_and_scipy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=32)
    m = design.dct1_matrix(32)
    np.testing.assert_allclose(m @ x, goref.dct1(x), rtol=1e-12)
    scipy = pytest.importorskip("scipy.fft")
    np.testing.assert_allclose(m @ x, scipy.dct(x, type=1), rtol=1e-10)


def test_dft_matrices_match_fft():
    rng = np.random.default_rng(1)
    for n in (400, 1102, 37):
        w = rng.normal(size=n)
        c, s = design.dft_matrices(n)
        coefs = np.fft.rfft(w)
        np.testing.assert_allclose(w @ c, coefs.real, atol=1e-9)
        np.testing.assert_allclose(w @ s, coefs.imag, atol=1e-9)


@pytest.mark.parametrize("distribute", [False, True])
@pytest.mark.parametrize(
    "specs",
    [
        default_gabor_specs(phases=(0.0, 1.5708)),
        default_gabor_specs(phases=(0.0,)),
        (GaborSpec(wavelen=1.5, circular=True, sigma_width=0.6),),
        (
            GaborSpec(wavelen=2.0, orientation=0, sigma_width=0.5, sigma_length=0.3),
            GaborSpec(wavelen=2.0, orientation=0, sigma_width=0.5, sigma_length=0.3),
            GaborSpec(wavelen=2.0, orientation=90, sigma_width=0.5, sigma_length=0.3),
            GaborSpec(off=True, wavelen=2.0, orientation=45, sigma_width=0.5,
                      sigma_length=0.3),
        ),
    ],
)
def test_gabor_render_matches_oracle(distribute, specs):
    for sx, sy in [(9, 9), (8, 8), (8, 6)]:
        gset = GaborSet(
            size_x=sx, size_y=sy, stride_x=3, stride_y=3, gain=2.0,
            distribute=distribute, specs=tuple(specs),
        )
        got = design.gabor_filters(gset)
        ref = goref.gabor_to_tensor(gset.active_specs(), gset)
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)


def test_gabor_renorm_halves():
    gset = GaborSet(
        size_x=9, size_y=9, stride_x=3, stride_y=3,
        specs=default_gabor_specs(phases=(0.0,)),
    )
    f = design.gabor_filters(gset)
    pos = np.where(f > 0, f, 0).sum(axis=(1, 2))
    neg = np.where(f < 0, f, 0).sum(axis=(1, 2))
    np.testing.assert_allclose(pos, 1.0, rtol=1e-9)
    np.testing.assert_allclose(neg, -1.0, rtol=1e-9)


def test_delta_operator_matches_cumsum_reference():
    """The delta linear operator (one matmul) must equal the cumsum
    formulation of the reference recurrence -- including exact NaN
    propagation through the mel NaN-triangle quirk."""
    import jax.numpy as jnp

    from auditory_tpu.dsp.mel import mfcc_deltas, mfcc_deltas_reference

    rng = np.random.default_rng(3)
    for steps, ncoef, npn in ((14, 13, 2), (9, 7, 3), (5, 4, 1), (3, 2, 5)):
        for mode in ("sndenv", "gaborview"):
            x = rng.normal(size=(2, steps, ncoef))
            a = np.asarray(mfcc_deltas(jnp.asarray(x), npn, mode))
            b = np.asarray(mfcc_deltas_reference(jnp.asarray(x), npn, mode))
            np.testing.assert_allclose(
                a, b, atol=1e-11, err_msg=f"{steps},{ncoef},{npn},{mode}"
            )
            # NaN quirk: poison one source entry; the NaN footprint of both
            # formulations must be IDENTICAL (matmul zero-weights must not
            # spread it, cancelled-but-touched terms must)
            xn = x.copy()
            xn[0, steps // 2, ncoef // 2] = np.nan
            an = np.asarray(mfcc_deltas(jnp.asarray(xn), npn, mode))
            bn = np.asarray(mfcc_deltas_reference(jnp.asarray(xn), npn, mode))
            np.testing.assert_array_equal(np.isnan(an), np.isnan(bn))
            m = ~np.isnan(an)
            np.testing.assert_allclose(an[m], bn[m], atol=1e-11)


def test_gabor_kernel_larger_than_plane_raises():
    """Both axes must reject kernels larger than the mel plane: the
    reference silently writes all-zero output when the filter is wider than
    the matrix (gabor.go:231-236) and would panic on a taller one
    (gabor.go:264-277); XLA would instead convolve an implicitly padded
    plane -- we raise a loud ValueError on either axis (documented
    deviation at dsp/gabor.py::convolve)."""
    import jax.numpy as jnp
    import pytest

    from auditory_tpu.config import GaborSet, default_gabor_specs
    from auditory_tpu.dsp.design import gabor_filters
    from auditory_tpu.dsp.gabor import convolve

    mel = jnp.zeros((32, 14), jnp.float32)
    for sx, sy, axis in ((99, 9, "width"), (9, 99, "height")):
        gset = GaborSet(size_x=sx, size_y=sy, stride_x=3, stride_y=3,
                        gain=2.0, specs=default_gabor_specs(phases=(0.0,)))
        with pytest.raises(ValueError, match=axis):
            convolve(mel, gabor_filters(gset), gset)


def test_clamp_mel_to_nyquist():
    """The shared bench/tool helper: lowers hi_hz to sr/2 only when the
    default exceeds Nyquist (reference default HiHz=8000, mel.go:173)."""
    from auditory_tpu.config import SndEnvConfig, clamp_mel_to_nyquist

    cfg = SndEnvConfig()
    assert clamp_mel_to_nyquist(cfg, 16000) is cfg  # 8000 == Nyquist: keep
    low = clamp_mel_to_nyquist(cfg, 8000)
    assert low.mel.fbank.hi_hz == 4000.0
    assert low.mel.fbank.n_filters == cfg.mel.fbank.n_filters


def test_gabor_gemm_matches_conv():
    """The static-patch GEMM lowering (convolve(method='gemm')) must be
    bit-identical to the conv lowering at f64 across geometries, including
    NaN inputs (the 0.5 substitution happens before either contraction) and
    the 4-D out_pools clamping; 'conv' stays the default."""
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from auditory_tpu.config import GaborSet, default_gabor_specs
    from auditory_tpu.dsp.design import gabor_filters
    from auditory_tpu.dsp.gabor import convolve

    gset = GaborSet(size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
                    specs=default_gabor_specs(phases=(0.0, 1.5708)))
    filts = jnp.asarray(gabor_filters(gset))
    rng = np.random.default_rng(7)
    for shape, pools in [((3, 4, 32, 14), None), ((5, 32, 14), None),
                         ((2, 3, 40, 20), None), ((2, 2, 32, 14), (4, 2))]:
        x = rng.standard_normal(shape)
        x.flat[::83] = np.nan
        xj = jnp.asarray(x)
        a = convolve(xj, filts, gset, out_pools=pools, method="conv")
        b = convolve(xj, filts, gset, out_pools=pools, method="gemm")
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # degenerate out_pools (zero positions): both lowerings emit the
    # same empty-axis shape instead of the gemm path crashing on an
    # empty stack
    for pools0 in [(0, 2), (4, 0)]:
        a = convolve(jnp.zeros((2, 32, 14)), filts, gset,
                     out_pools=pools0, method="conv")
        b = convolve(jnp.zeros((2, 32, 14)), filts, gset,
                     out_pools=pools0, method="gemm")
        assert a.shape == b.shape and 0 in a.shape
    with pytest.raises(ValueError, match="method"):
        convolve(jnp.zeros((2, 32, 14)), filts, gset, method="winograd")
