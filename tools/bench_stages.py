"""Incremental stage-cost profile of the default pipeline on the current
backend: times the same batch with progressively larger output selections so
XLA's dead-code elimination isolates each stage's marginal cost.

    PYTHONPATH=. python tools/bench_stages.py [--batch N] [--seconds S]

Prints one JSON line per variant:
  mel_only       spectrum frontend + mel matmul (the floor)
  mel_mfcc       + DCT, energy, delta/delta-delta operators
  mel_gabor      + gabor conv, on/off split (no MFCC)
  features       the bench.py default output set
  features_kwta  + the FFFB/kWTA settle
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rate", type=int, default=16000,
                    help="sample rate; 44100 profiles the 1102-pt-window "
                    "geometry")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from auditory_tpu.config import (
        GaborSet, SndEnvConfig, clamp_mel_to_nyquist, default_gabor_specs,
    )
    from auditory_tpu.pipeline.batch import BatchedSndEnv, bucket_length
    from auditory_tpu.pipeline.sndenv import SndEnv
    from auditory_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    sr = args.rate
    cfg = SndEnvConfig(
        gabor=GaborSet(
            size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
            specs=default_gabor_specs(phases=(0.0, 1.5708)),
        )
    )
    cfg = clamp_mel_to_nyquist(cfg, sr)
    cfg_nok = dataclasses.replace(cfg, kwta=dataclasses.replace(cfg.kwta, on=False))

    mfcc = ("mfcc_segment", "mfcc_deltas", "mfcc_delta_deltas", "energy")
    gabor = ("gabor_raw", "gabor_kwta")
    variants = [
        # raw frontend without log/mel (XLA DCEs them): splits the
        # conv/frames GEMM from the elementwise tail at small geometries
        ("power_only", cfg_nok, ("power_segment", "step_valid")),
        ("mel_only", cfg_nok, ("mel_fbank_segment", "step_valid")),
        ("mel_mfcc_nodeltas", cfg_nok,
         ("mel_fbank_segment", "step_valid", "mfcc_segment", "energy")),
        ("mel_mfcc", cfg_nok, ("mel_fbank_segment", "step_valid") + mfcc),
        ("mel_gabor", cfg_nok, ("mel_fbank_segment", "step_valid") + gabor),
        ("features", cfg_nok, ("mel_fbank_segment", "step_valid") + mfcc + gabor),
        ("features_kwta", cfg, ("mel_fbank_segment", "step_valid") + mfcc + gabor),
    ]

    rng = np.random.default_rng(0)
    for name, c, outs in variants:
        env = SndEnv(c, sr, dtype=jnp.float32, outputs=outs)
        benv = BatchedSndEnv(env)
        n = bucket_length(int(args.seconds * sr), env.timing)
        t = np.arange(n) / sr
        base = (0.1 * np.sin(2 * np.pi * 180 * t)
                + 0.05 * np.sin(2 * np.pi * 1200 * t))
        signals = (
            base[None, :] + 0.02 * rng.standard_normal((args.batch, n))
        ).astype(np.float32)
        lengths = rng.integers(
            int(0.8 * n), n + 1, size=args.batch
        ).astype(np.int32)
        sd = jax.device_put(jnp.asarray(signals))
        ld = jax.device_put(jnp.asarray(lengths))
        fn = benv.process_fn(n, 0)
        for _ in range(3):
            out, _ = fn(sd, ld)
            jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out, _ = fn(sd, ld)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.iters
        print(json.dumps({
            "variant": name,
            "ms_per_batch": round(dt * 1e3, 3),
            "rtf": round(float(lengths.sum()) / sr / dt, 1),
        }))


if __name__ == "__main__":
    main()
