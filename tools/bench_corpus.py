"""Corpus end-to-end benchmark: N synthetic TIMIT-like WAVs through
CorpusRunner (decode -> device -> npz), reporting warm RTF and a serialized
per-stage breakdown (decode / device compute / device->host transfer / write)
so the overlap win is measurable.

Usage: PYTHONPATH=. python tools/bench_corpus.py [--files 400] ...
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

import numpy as np


def make_corpus(d: str, n_files: int, sr: int, rng: np.random.Generator):
    from auditory_tpu.io.wav import float_to_wave, write_wav

    # rate-specific subdir: reusing a stale corpus written at another rate
    # would make every file fail decode while the bench still printed stats
    d = os.path.join(d, str(sr))
    os.makedirs(d, exist_ok=True)
    paths = []
    total_sec = 0.0
    for i in range(n_files):
        dur = float(rng.uniform(2.0, 4.0))
        n = int(dur * sr)
        t = np.arange(n) / sr
        f0 = float(rng.uniform(120, 260))
        sig = (
            0.2 * np.sin(2 * np.pi * f0 * t)
            + 0.1 * np.sin(2 * np.pi * 8 * f0 * t)
            + 0.02 * rng.standard_normal(n)
        )
        sig = np.clip(sig, -1, 1)
        p = os.path.join(d, f"utt{i:04d}.wav")
        if not os.path.exists(p):
            write_wav(p, float_to_wave(sig, sr))
        paths.append(p)
        total_sec += dur
    return paths, total_sec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--files", type=int, default=400)
    ap.add_argument("--rate", type=int, default=16000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--corpus-dir", default="/tmp/bench_corpus")
    ap.add_argument("--out-dir", default="/tmp/bench_corpus_out")
    ap.add_argument("--kwta", action="store_true")
    ap.add_argument("--transfer", choices=("auto", "float32"), default="auto")
    ap.add_argument("--f16", action="store_true",
                    help="cast saved features to float16 on device")
    ap.add_argument("--int8", action="store_true",
                    help="int8 per-channel quantized transfer (lossy)")
    ap.add_argument("--stages", action="store_true",
                    help="also time the stages serialized (no overlap)")
    ap.add_argument("--save-keys", default=None,
                    help="comma-separated output keys to save (default "
                    "mel_fbank_segment,gabor_kwta). power_segment,"
                    "log_power_segment at 44.1 kHz is the byte-bound "
                    "transfer regime (tens of MB/batch): the f32/f16/int8 "
                    "crossover measurement")
    ap.add_argument("--runs", type=int, default=2,
                    help="end-to-end runs (first run warms the jit cache)")
    args = ap.parse_args()

    import dataclasses

    import jax

    from auditory_tpu.config import GaborSet, SndEnvConfig, default_gabor_specs
    from auditory_tpu.pipeline.batch import CorpusRunner
    from auditory_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    rng = np.random.default_rng(42)
    paths, total_sec = make_corpus(args.corpus_dir, args.files, args.rate, rng)
    print(f"corpus: {len(paths)} files, {total_sec:.1f} audio-sec")

    cfg = SndEnvConfig(
        gabor=GaborSet(
            size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
            specs=default_gabor_specs(phases=(0.0, 1.5708)),
        )
    )
    if not args.kwta:
        cfg = dataclasses.replace(
            cfg, kwta=dataclasses.replace(cfg.kwta, on=False)
        )

    import jax.numpy as jnp

    save_kw = {}
    if args.save_keys:
        save_kw["save_keys"] = tuple(args.save_keys.split(","))

    def fresh_runner():
        return CorpusRunner(
            cfg, args.rate, batch_size=args.batch_size,
            transfer=args.transfer,
            transfer_dtype=(
                jnp.int8 if args.int8
                else jnp.float16 if args.f16 else None
            ),
            **save_kw,
        )

    results = {}
    for run in range(args.runs):
        shutil.rmtree(args.out_dir, ignore_errors=True)
        runner = fresh_runner()
        t0 = time.perf_counter()
        stats = runner.run(paths, args.out_dir)
        dt = time.perf_counter() - t0
        tag = "cold" if run == 0 else f"warm{run}"
        results[tag] = {
            "rtf": round(stats.rtf, 1),
            "wall_s": round(dt, 2),
            "files_done": stats.files_done,
        }
        print(f"{tag}: rtf={stats.rtf:.1f} wall={dt:.2f}s")

    if args.stages:
        # serialized stage costs (upper bounds for each stage in isolation)
        runner = fresh_runner()
        t0 = time.perf_counter()
        decoded = list(runner._decode_many(paths))
        t_decode = time.perf_counter() - t0
        sigs = [(p, s, d) for p, s, d, e in decoded if e is None]
        print(f"stage decode: {t_decode:.2f}s ({len(sigs)} ok)")

        from auditory_tpu.pipeline.batch import bucket_length

        buckets = {}
        for p, s, d in sigs:
            bl = bucket_length(len(s), runner.env.timing,
                               quantum=runner._bucket_quantum)
            # key by (length, int16-mode) exactly like run(): mixing modes
            # in one batch would put float32 signals into an int16 array
            buckets.setdefault((bl, d is not None), []).append((p, s, d))
        # device compute only (dispatch all, block once) -- at the SAME
        # batch_size run() uses, so no fresh giant-batch compiles
        outs = []
        t0 = time.perf_counter()
        for (bl, _), items in buckets.items():
            for lo in range(0, len(items), runner.batch_size):
                outs.append(
                    runner._dispatch(items[lo: lo + runner.batch_size],
                                     bl, 0)[1]
                )
        for o in outs:
            jax.block_until_ready(o[0].data)
        t_compute = time.perf_counter() - t0
        print(f"stage device (put+compute+block): {t_compute:.2f}s "
              f"({len(buckets)} buckets)")

        t0 = time.perf_counter()
        hosts = []
        for o in outs:
            hosts.append(o[0].unpack())
        t_xfer = time.perf_counter() - t0
        nbytes = sum(v.nbytes for h in hosts for v in h.values())
        print(f"stage transfer: {t_xfer:.2f}s ({nbytes/1e6:.1f} MB)")

        shutil.rmtree(args.out_dir, ignore_errors=True)
        os.makedirs(args.out_dir, exist_ok=True)
        t0 = time.perf_counter()
        idx = 0
        for (bl, items), host in zip(buckets.items(), hosts):
            for i, (p, s, d) in enumerate(items):
                rec = {k: v[i] for k, v in host.items()}
                np.savez(os.path.join(args.out_dir, f"w{idx}.npz"), **rec)
                idx += 1
        t_write = time.perf_counter() - t0
        print(f"stage write: {t_write:.2f}s ({idx} files)")
        results["stages"] = {
            "decode_s": round(t_decode, 2),
            "device_s": round(t_compute, 2),
            "transfer_s": round(t_xfer, 2),
            "write_s": round(t_write, 2),
            "out_mb": round(nbytes / 1e6, 1),
        }

    results["audio_seconds"] = round(total_sec, 1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
