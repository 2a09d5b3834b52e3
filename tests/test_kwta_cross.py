"""Dual-derivation cross-check of the kWTA/FFFB stage.

``nn/kwta.py`` (production: f32, Chebyshev/Clenshaw XX1, fixed-iteration
scan) is compared against ``refemu/kwtaref.py`` (independent: f64, lookup
table + linear interp built by adaptive Gauss-Kronrod quadrature, scalar
early-stop loop). The two share no code and no numerical method; agreement
bounds measured here are frozen in docs/PARITY.md. Reference usage of the
stage: sound/sndenv.go:303-323 (external unvendored deps -- no true oracle).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp

from auditory_tpu.config import KWTAParams
from auditory_tpu.nn.kwta import kwta_layer, kwta_pool, xx1
from auditory_tpu.refemu.kwtaref import (
    kwta_layer_ref,
    kwta_pool_ref,
    noisy_xx1_ref,
)


def rand_acts(shape, seed=0, scale=1.0):
    r = np.random.default_rng(seed)
    return np.abs(r.normal(scale=scale, size=shape)).astype(np.float32)


def test_xx1_two_derivations_agree():
    """Chebyshev/Clenshaw vs table/linear-interp noisy XX1: <= 2.5e-4 over
    the full transition band (measured 1.3e-4 -- dominated by the two
    quadratures' gaussian truncation difference, not either evaluator)."""
    p = KWTAParams()
    lo, hi = -6.0 * p.xx1_nvar, 0.3
    xs = np.linspace(lo, hi, 4001)
    ref = noisy_xx1_ref(p, xs)
    got = np.asarray(xx1(p, jnp.asarray(xs, jnp.float32)))
    assert np.abs(got - ref).max() < 2.5e-4
    # clean limit: both reduce to the exact clean XX1
    p0 = dataclasses.replace(p, xx1_nvar=0.0)
    ref0 = noisy_xx1_ref(p0, xs)
    got0 = np.asarray(xx1(p0, jnp.asarray(xs, jnp.float32)))
    np.testing.assert_allclose(got0, ref0, atol=1e-6)


def test_settle_matched_iterations_grid():
    """At MATCHED iteration counts the two settles agree across the config
    grid: <= 1.5e-4 at the tuned default fit degrees (measured 2e-5,
    dominated by the (16, 10) fit's 8e-5 budget) -- this isolates the FFFB
    arithmetic + XX1 evaluator agreement from the iteration policy."""
    base = KWTAParams()
    grid = [
        base,
        dataclasses.replace(
            base, lay_fffb=dataclasses.replace(base.lay_fffb, gi=0.8)
        ),
        dataclasses.replace(
            base, lay_fffb=dataclasses.replace(base.lay_fffb, gi=3.0)
        ),
        dataclasses.replace(
            base, pool_fffb=dataclasses.replace(base.pool_fffb, gi=1.2)
        ),
        dataclasses.replace(base, xx1_nvar=0.0),
    ]
    for ci, p in enumerate(grid):
        for seed in range(2):
            raw = rand_acts((6, 4, 2, 4), seed=seed)
            ref = kwta_pool_ref(p, raw, max_cycles=p.iters, early_stop=False)
            got = np.asarray(kwta_pool(p, jnp.asarray(raw)))
            dev = np.abs(got - ref).max()
            assert dev < 1.5e-4, (ci, seed, dev)
    # at the legacy high-degree fit the agreement is f32-roundoff-grade
    # (measured ~2e-6): the looser default bound above is purely the
    # documented (16, 10) fit budget, not a dynamics deviation
    p_hi = dataclasses.replace(base, xx1_fit_degrees=(24, 16))
    raw = rand_acts((6, 4, 2, 4), seed=0)
    ref = kwta_pool_ref(p_hi, raw, max_cycles=p_hi.iters, early_stop=False)
    got = np.asarray(kwta_pool(p_hi, jnp.asarray(raw)))
    assert np.abs(got - ref).max() < 1e-5
    # layer variant + external inhibition
    p = base
    raw = rand_acts((8, 16), seed=3)
    eg = np.full(raw.shape, 0.3, dtype=np.float32)
    ref = kwta_layer_ref(p, raw, ext_gi=eg.astype(np.float64),
                         max_cycles=p.iters, early_stop=False)
    got = np.asarray(kwta_layer(p, jnp.asarray(raw), jnp.asarray(eg)))
    assert np.abs(got - ref).max() < 1.5e-4


def test_settle_early_stop_policy_bound():
    """The upstream EARLY-STOP (max |delta act| < del_act_thr) vs our fixed
    ``iters`` count: <= 0.015 absolute activation deviation (measured
    8.8e-3) -- the fixed-iteration run is the MORE settled of the two, and
    the gap sits far inside the 0.02 pinned-sparsity tolerance."""
    p = KWTAParams()
    worst = 0.0
    for seed in range(3):
        raw = rand_acts((6, 4, 2, 4), seed=seed)
        ref = kwta_pool_ref(p, raw, early_stop=True)
        got = np.asarray(kwta_pool(p, jnp.asarray(raw)))
        worst = max(worst, float(np.abs(got - ref).max()))
        # and the early-stopped reference yields the SAME active set,
        # checked for EVERY seed (not just the loop's last leftovers)
        np.testing.assert_array_equal(ref > 0.1, got > 0.1)
    assert worst < 0.015, worst
