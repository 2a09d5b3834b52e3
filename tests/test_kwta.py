"""Functional tests for the FFFB kWTA + neighbor-inhibition stage.

No bit-level oracle exists (the reference depends on external, unvendored
packages emer/vision/kwta + emer/leabra/fffb), so these tests check the
documented behavioral contract: sparsification, winner preservation,
monotonicity in gi, and inhibition geometry.
"""

import dataclasses

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from auditory_tpu.config import KWTAParams, NeighInhibParams
from auditory_tpu.nn.kwta import kwta_layer, kwta_pool, xx1
from auditory_tpu.nn.neigh_inhib import inhib4, orthogonal_offsets


def rand_acts(shape, seed=0, scale=1.0):
    r = np.random.default_rng(seed)
    return jnp.asarray(np.abs(r.normal(scale=scale, size=shape)), dtype=jnp.float32)


def test_xx1_monotone_and_bounded():
    p = KWTAParams()
    x = jnp.linspace(-1.0, 5.0, 301)
    y = xx1(p, x)
    assert float(y.min()) >= 0.0
    assert float(y.max()) < 1.0
    assert np.all(np.diff(np.asarray(y)) >= -1e-7)
    assert float(xx1(p, jnp.asarray(-1.0))) == 0.0


def test_kwta_layer_sparsifies_and_keeps_winners():
    p = KWTAParams()
    raw = rand_acts((16, 32), seed=1)
    out = kwta_layer(p, raw)
    assert out.shape == raw.shape
    frac_active = float((out > 0.1).mean())
    assert frac_active < 0.5, "kwta should sparsify"
    # strongest input must remain among the active outputs
    i = jnp.unravel_index(jnp.argmax(raw), raw.shape)
    assert float(out[i]) == float(out.max())


def test_kwta_gi_monotonicity():
    raw = rand_acts((8, 24), seed=2)
    lo = KWTAParams(lay_fffb=dataclasses.replace(KWTAParams().lay_fffb, gi=0.8))
    hi = KWTAParams(lay_fffb=dataclasses.replace(KWTAParams().lay_fffb, gi=3.0))
    act_lo = float((kwta_layer(lo, raw) > 0.1).mean())
    act_hi = float((kwta_layer(hi, raw) > 0.1).mean())
    assert act_hi <= act_lo, "more inhibition => sparser output"


def test_kwta_off_is_identity_and_zeros_stay_zero():
    p = KWTAParams(on=False)
    raw = rand_acts((4, 6), seed=3)
    np.testing.assert_array_equal(np.asarray(kwta_layer(p, raw)), np.asarray(raw))
    # EXACT zeros under default params: the packed on/off transfer fold
    # depends on it (_onoff_fold_exact holds for nvar=0.01)
    z = kwta_layer(KWTAParams(), jnp.zeros((4, 6), jnp.float32))
    assert float(jnp.abs(z).max()) == 0.0


def test_kwta_pool_localizes_competition():
    """With pool-level inhibition, a weak unit in a quiet pool can stay more
    active than the same-strength unit in a pool with a dominant winner."""
    p = KWTAParams()
    raw = np.zeros((2, 1, 2, 4), dtype=np.float32)
    raw[0, 0, 0, 0] = 2.0  # dominant winner in pool 0
    raw[0, 0, 0, 1] = 0.6  # weak unit in the loud pool
    raw[1, 0, 0, 1] = 0.6  # same-strength unit in quiet pool 1
    out = np.asarray(kwta_pool(p, jnp.asarray(raw)))
    assert out[1, 0, 0, 1] >= out[0, 0, 0, 1]


def test_kwta_ext_gi_suppresses():
    p = KWTAParams()
    raw = rand_acts((6, 8), seed=4)
    base = np.asarray(kwta_layer(p, raw))
    eg = jnp.full(raw.shape, 2.0, dtype=jnp.float32)
    suppressed = np.asarray(kwta_layer(p, raw, eg))
    assert suppressed.sum() < base.sum()


def test_kwta_jit_and_fixed_point():
    p = KWTAParams()
    raw = rand_acts((8, 8), seed=5)
    f = jax.jit(lambda r: kwta_layer(p, r))
    o1 = np.asarray(f(raw))
    # jit vs eager at MATCHED iterations: tight (a jit-only numeric bug
    # must not hide behind settledness slack)
    np.testing.assert_allclose(o1, np.asarray(kwta_layer(p, raw)), atol=1e-6)
    # fixed point: doubling iterations barely moves the settled dynamics
    more = dataclasses.replace(p, iters=40)
    o2 = np.asarray(kwta_layer(more, raw))
    np.testing.assert_allclose(o1, o2, atol=0.05)


def test_orthogonal_offsets():
    offs = orthogonal_offsets([0.0, 45.0, 90.0, 135.0])
    assert offs.tolist() == [[1, 0], [1, -1], [0, -1], [-1, -1]]


def test_inhib4_geometry():
    params = NeighInhibParams(on=True, gi=0.6)
    act = np.zeros((5, 5, 2, 4), dtype=np.float32)
    act[2, 2, 0, 0] = 1.0  # horizontal filter at center
    eg = np.asarray(inhib4(params, jnp.asarray(act), [0.0, 45.0, 90.0, 135.0]))
    # orientation 0 -> orthogonal neighbors are (y+-1, x): they get inhibited
    assert eg[1, 2, 0, 0] == np.float32(0.6)
    assert eg[3, 2, 0, 0] == np.float32(0.6)
    # non-orthogonal neighbor and other features untouched
    assert eg[2, 1, 0, 0] == 0.0
    assert eg[1, 2, 0, 1] == 0.0
    # off => zeros
    off = inhib4(NeighInhibParams(on=False), jnp.asarray(act), [0.0, 45, 90, 135])
    assert float(jnp.abs(off).max()) == 0.0


def test_inhib4_border_zero_fill():
    params = NeighInhibParams(on=True, gi=1.0)
    act = np.zeros((3, 3, 2, 4), dtype=np.float32)
    act[0, 0, 1, 2] = 1.0  # vertical filter at corner; orth neighbors (y, x+-1)
    eg = np.asarray(inhib4(params, jnp.asarray(act), [0.0, 45.0, 90.0, 135.0]))
    assert eg[0, 1, 1, 2] == 1.0
    # the roll wrap-around must be zero-filled, not wrapped
    assert eg[0, 2, 1, 2] == 0.0


def test_kwta_return_inhibs():
    p = KWTAParams()
    raw = rand_acts((4, 1, 2, 4), seed=6)
    act, inhibs = kwta_pool(p, raw, return_inhibs=True)
    assert act.shape == raw.shape
    assert float(inhibs["layer"]["gi"]) > 0
    assert inhibs["pool"]["gi"].shape == (4, 1, 1, 1)


# ---------------------------------------------------------------------------
# Quantitative contract: the behavioral port has
# no oracle, so pin the sparsity level, the settle convergence, and a frozen
# activation snapshot. A ~20% sparsity regression must fail these.
# ---------------------------------------------------------------------------

# measured active fractions (>0.1) of the default 4-D pooled config on
# |N(0,1)| inputs of shape (6, 4, 2, 4), seeds 0..4
_PINNED_POOL_FRACS = [0.1562, 0.1458, 0.1510, 0.1719, 0.1667]


def test_kwta_pinned_sparsity():
    p = KWTAParams()
    for seed, expect in enumerate(_PINNED_POOL_FRACS):
        raw = rand_acts((6, 4, 2, 4), seed=seed)
        frac = float((np.asarray(kwta_pool(p, raw)) > 0.1).mean())
        # +-0.02 absolute (~12-14% relative of the ~0.15 pinned levels):
        # a 20% relative sparsity shift moves frac by >= 0.029 and fails
        assert abs(frac - expect) < 0.02, (seed, frac, expect)


def test_kwta_settle_convergence():
    """Dynamics must be settled by the default iteration count: the last
    iteration's max |delta act| is below del_act_thr (the upstream
    early-stop criterion the fixed-iteration jit variant replaces)."""
    p = KWTAParams()
    p_prev = dataclasses.replace(p, iters=p.iters - 1)
    for seed in range(3):
        raw = rand_acts((6, 4, 2, 4), seed=seed)
        a_prev = np.asarray(kwta_pool(p_prev, raw))
        a_fin = np.asarray(kwta_pool(p, raw))
        last_delta = float(np.abs(a_fin - a_prev).max())
        assert last_delta < p.del_act_thr, (seed, last_delta)


def test_kwta_golden_snapshot():
    """Frozen activation snapshot (tests/goldens/kwta_golden.npz): any
    change to the FFFB/XX1 dynamics shows up as a diff here. The golden was
    frozen at the round-2 settings (iters=20, fit degrees (24, 16)), pinned
    here explicitly so the snapshot keeps guarding the DYNAMICS even as the
    error-budgeted defaults evolve; the tuned defaults are additionally
    checked against the same golden at the documented budget tolerance
    (fit err 8e-5 + 4 unsettled iterations ~ 1e-2, see config.KWTAParams)."""
    import os

    g = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "kwta_golden.npz"))
    p = dataclasses.replace(KWTAParams(), iters=20, xx1_fit_degrees=(24, 16))
    pool = np.asarray(kwta_pool(p, jnp.asarray(g["raw4"])))
    layer = np.asarray(kwta_layer(p, jnp.asarray(g["raw2"])))
    np.testing.assert_allclose(pool, g["pool"], atol=2e-3)
    np.testing.assert_allclose(layer, g["layer"], atol=2e-3)
    # tuned defaults: same dynamics within the documented error budget
    pd = np.asarray(kwta_pool(KWTAParams(), jnp.asarray(g["raw4"])))
    ld = np.asarray(kwta_layer(KWTAParams(), jnp.asarray(g["raw2"])))
    np.testing.assert_allclose(pd, g["pool"], atol=1.2e-2)
    np.testing.assert_allclose(ld, g["layer"], atol=1.2e-2)


@pytest.mark.parametrize(
    "degrees,atol,mono_tol",
    [
        # tuned defaults: fit err 8e-5 (budget 1e-4); ripples of that
        # amplitude in the near-flat left tail bound the monotone slack
        ((16, 10), 3e-4, 1e-4),
        # legacy high-degree fit: essentially exact
        ((24, 16), 2e-4, 1e-6),
    ],
)
def test_xx1_cheb_matches_dense_convolution(degrees, atol, mono_tol):
    """The device Chebyshev evaluation must track the dense
    gaussian-convolved reference (_noisy_xx1_table) within the degree
    pair's documented error budget and remain monotone (up to fit-error
    ripple) over the full transition band."""
    from auditory_tpu.nn.kwta import _noisy_xx1_table

    p = dataclasses.replace(KWTAParams(), xx1_fit_degrees=degrees)
    x0, x1, ys = _noisy_xx1_table(p.xx1_gain, p.xx1_nvar, n=4096)
    xs = np.linspace(x0, x1, 4096)
    got = np.asarray(xx1(p, jnp.asarray(xs, jnp.float32)))
    # base 2e-4: the two references use different gaussian quadratures
    # (table: +-4sigma/257 pts; fit: +-5sigma/2049 pts) whose truncation
    # difference is ~1.3e-4; the fit error adds the rest
    np.testing.assert_allclose(got, ys, atol=atol)
    assert np.all(np.diff(got) >= -mono_tol)
    assert np.all(got >= 0.0)  # ripple is clamped: never negative
    # clean XX1 above the band, zero below
    assert float(xx1(p, jnp.asarray(x0 - 0.01))) == 0.0
    hi = 2.0 * x1
    g = p.xx1_gain * hi
    assert float(xx1(p, jnp.asarray(hi))) == pytest.approx(g / (g + 1.0), rel=1e-6)


def test_onoff_fold_exact_guard():
    """The packed-transfer on/off fold must be disabled exactly when the
    noisy-XX1 shoulder can lift zero-drive units off zero
    (a code-review finding)."""
    import dataclasses as dc

    from auditory_tpu.pipeline.batch import _onoff_fold_exact

    assert _onoff_fold_exact(KWTAParams())           # nvar=0.01: safe
    assert _onoff_fold_exact(KWTAParams(on=False))   # kwta off: trivially
    assert not _onoff_fold_exact(KWTAParams(xx1_nvar=0.03))
    # and the condition matches the dynamics: zero input stays zero iff safe
    for nvar, expect_zero in ((0.01, True), (0.05, False)):
        p = dc.replace(KWTAParams(), xx1_nvar=nvar)
        raw = np.zeros((1, 1, 2, 4), dtype=np.float32)
        raw[0, 0, 0, :] = 0.35  # moderate drive so gi stays small
        out = np.asarray(kwta_pool(p, jnp.asarray(raw)))
        off_zero = bool(np.all(out[0, 0, 1] == 0.0))
        assert off_zero == expect_zero, (nvar, out[0, 0, 1])


def test_xx1_nvar_zero_is_clean_limit():
    """xx1_nvar=0 (noise off) must yield the exact clean XX1, not NaN."""
    p = dataclasses.replace(KWTAParams(), xx1_nvar=0.0)
    from auditory_tpu.nn.kwta import xx1

    d = jnp.asarray(np.linspace(-0.1, 0.5, 101))
    y = np.asarray(xx1(p, d))
    assert np.all(np.isfinite(y))
    g = p.xx1_gain * np.asarray(d)
    clean = np.where(np.asarray(d) > 0, g / (g + 1.0), 0.0)
    np.testing.assert_allclose(y, clean, rtol=1e-6)
    # and the full settle stays finite
    raw = rand_acts((4, 4, 2, 4), seed=0)
    out = np.asarray(kwta_pool(p, raw))
    assert np.all(np.isfinite(out))
