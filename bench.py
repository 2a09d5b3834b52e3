"""Benchmark: batched TIMIT-style 16 kHz mel+gabor extraction throughput.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "audio_sec_per_sec_per_chip",
   "vs_baseline": N, "platform": "...", "device_kind": "...",
   "device_count": N, ...}

The metric is the BASELINE.json north-star: real-time factor (seconds of
audio processed per wall second per chip) of the full default pipeline --
window gather, DFT power, log power, mel filterbank, MFCC + deltas, gabor
convolution with on/off rectification -- on a batch of synthetic 16 kHz
utterances with TIMIT-like durations. Baseline target: 5000x per chip.

kWTA is excluded from the headline (the north-star names mel+gabor
extraction); pass --kwta to include it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def metric_name(args) -> str:
    """The self-describing metric id of the JSON line."""
    return (
        ("timit16k_mel_gabor_rtf" if args.rate == 16000
         else f"mel_gabor_rtf_{args.rate}hz")
        + ("_kwta" if args.kwta else "")
        + ("" if args.outputs == "features" else f"_{args.outputs}")
        + {"highest": "", "high": "_high", "default": "_fast"}[args.precision]
        + ("" if args.frontend == "auto" else f"_{args.frontend}")
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512, help="utterances per step")
    ap.add_argument("--seconds", type=float, default=3.0, help="utterance length")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument(
        "--repeats", type=int, default=5,
        help="timed repeats of the --iters loop; the JSON line reports the "
        "median as `value` plus min/max so the spread is visible",
    )
    ap.add_argument("--kwta", action="store_true", help="include kWTA settle")
    ap.add_argument(
        "--outputs", choices=("full", "features", "melgabor"),
        default="features",
        help="full = every reference tensor incl. the power/log-power "
        "visualization matrices; features = mel+MFCC(+deltas)+energy+gabor "
        "(what training consumers read); melgabor = mel+gabor only",
    )
    ap.add_argument("--f64", action="store_true")
    ap.add_argument(
        "--rate", type=int, default=16000,
        help="sample rate; 44100 gives the 1102-pt-window geometry "
        "(reported with a _44k1-style metric suffix, never the headline)",
    )
    ap.add_argument(
        "--fast", action="store_true",
        help="shorthand for --precision default; reported with a _fast "
        "metric suffix, never as the headline",
    )
    ap.add_argument(
        "--frontend",
        choices=("auto", "conv", "frames", "windowed", "factored"),
        default="auto",
        help="spectrum frontend override (auto = the dispatch rule); "
        "factored exists only for composite windows. Reported with "
        "a _<frontend> metric suffix when not auto",
    )
    ap.add_argument(
        "--precision", choices=("highest", "high", "default"),
        default="highest",
        help="contraction precision tier: highest = full f32 (the "
        "headline), high (_high suffix) and default (same as --fast; "
        "_fast suffix) may run f32 products in TF32 on a GPU",
    )
    args = ap.parse_args()
    if args.fast:
        if args.precision != "highest":
            ap.error("--fast is shorthand for --precision default; "
                     "pass one or the other, not both")
        args.precision = "default"

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
    if not args.kwta:
        cfg = dataclasses.replace(
            cfg, kwta=dataclasses.replace(cfg.kwta, on=False)
        )

    outputs = {
        "full": None,
        "features": (
            "mel_fbank_segment", "mfcc_segment", "mfcc_deltas",
            "mfcc_delta_deltas", "energy", "gabor_raw", "gabor_kwta",
            "step_valid",
        ),
        "melgabor": ("mel_fbank_segment", "gabor_raw", "gabor_kwta", "step_valid"),
    }[args.outputs]
    env = SndEnv(
        cfg, sr, dtype=jnp.float64 if args.f64 else jnp.float32,
        outputs=outputs,
        matmul_precision=args.precision,
        spectrum_method=None if args.frontend == "auto" else args.frontend,
    )
    benv = BatchedSndEnv(env)

    rng = np.random.default_rng(0)
    n = bucket_length(int(args.seconds * sr), env.timing)
    # TIMIT-like content: speech-band noise + tones, variable true lengths
    t = np.arange(n) / sr
    base = 0.1 * np.sin(2 * np.pi * 180 * t) + 0.05 * np.sin(2 * np.pi * 1200 * t)
    signals = (
        base[None, :] + 0.02 * rng.standard_normal((args.batch, n))
    ).astype(np.float32)
    lengths = rng.integers(int(0.8 * n), n + 1, size=args.batch).astype(np.int32)

    signals_d = jax.device_put(jnp.asarray(signals))
    lengths_d = jax.device_put(jnp.asarray(lengths))
    fn = benv.process_fn(n, 0)

    for _ in range(args.warmup):
        out, _ = fn(signals_d, lengths_d)
        jax.block_until_ready(out)

    # pipelined throughput: enqueue all steps, block once at the end;
    # repeat the timed loop so the reported number carries its spread
    audio_seconds = float(lengths.sum()) / sr * args.iters
    rtfs = []
    for _ in range(max(1, args.repeats)):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out, _ = fn(signals_d, lengths_d)
        jax.block_until_ready(out)
        rtfs.append(audio_seconds / (time.perf_counter() - t0))
    rtf = float(np.median(rtfs))
    devs = jax.devices()
    baseline = 5000.0
    print(
        json.dumps(
            {
                "metric": metric_name(args),
                "value": round(rtf, 1),
                "unit": "audio_sec_per_sec_per_chip",
                "vs_baseline": round(rtf / baseline, 3),
                "min": round(min(rtfs), 1),
                "max": round(max(rtfs), 1),
                "repeats": len(rtfs),
                "precision": args.precision,
                "platform": devs[0].platform,
                "device_kind": devs[0].device_kind,
                "device_count": len(devs),
            }
        )
    )


if __name__ == "__main__":
    main()
