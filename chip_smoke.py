"""End-to-end smoke run of the batched auditory frontend on an NVIDIA GPU.

Usage::

    python chip_smoke.py          # phases 1-6 on one card
    python chip_smoke.py --four   # 4-card data/segment parallelism vs one card

One process drives the card; the CPU reference runs in the same process
(``jax.devices("cpu")``), so no second process competes for device memory.
Phases (one card):

1. batch     -- BatchedSndEnv at B=512 x 3 s, 16 kHz, kWTA off and on,
                compared with the same program on the CPU in f32
2. tiers     -- the 'high' and 'default' matmul precision tiers, graded
3. frontends -- conv / frames / windowed spectrum frontends timed at
                400/160 (16 kHz) and 1103/441 (44.1 kHz)
4. corpus    -- CorpusRunner over 64 seeded WAVs with the native decoder
5. serving   -- MultiStreamOnline with 64 streams vs offline SndEnv
6. f64       -- ``cli process --f64`` on the card vs the float64 oracle

Every timing is printed beside the card's name and power limit. The last
line of standard output is one JSON object; any failed check raises, so
the script exits non-zero without printing it. Without a GPU it refuses
to run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 16000

# the corpus feature set bench.py reports (its --outputs features)
FEATURES = (
    "mel_fbank_segment", "mfcc_segment", "mfcc_deltas", "mfcc_delta_deltas",
    "energy", "gabor_raw", "gabor_kwta", "step_valid",
)

# f32 device-vs-CPU bounds at precision 'highest': (bound, relative_to_peak).
# power is linear in signal x basis, so it is graded relative to its peak.
# Both sides round each 400-term DFT sum in f32, each in its own order:
# roundoff of order sqrt(400) * 2^-24 ~ 1.2e-6 on re and im, ~2.4e-6 on
# power, per side. 4e-6 allows two such sides (the CPU's windowed frontend
# alone is 0.85e-6 from the float64 power on these signals). log-mel's
# absolute error is the relative error of the mel sum, largest at the
# quietest bins; gabor is linear in the log-mel plane; kWTA's settle
# dynamics amplify roundoff (the slack of the sharded-vs-unsharded tests).
BOUNDS = {
    "power_segment": (4e-6, True),
    "mel_fbank_segment": (3e-4, False),
    "gabor_raw": (3e-4, True),
    "gabor_kwta": (1e-4, False),
}

# float64 device-vs-oracle bound (the CPU parity gate); gabor compares
# against the oracle's float32 output tensor, hence its own slack
F64_BOUND = 1e-5
F64_GABOR_BOUND = 1e-4


class CheckFailed(AssertionError):
    """A measured deviation exceeded its bound."""


# ---------------------------------------------------------------- helpers


def require_gpu(min_count: int = 1):
    """The accelerator devices, or SystemExit when JAX finds no GPU (no
    fallback to the CPU) or fewer than ``min_count`` cards."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, JAX found {devs[0].platform!r}"
        )
    if len(devs) < min_count:
        raise SystemExit(
            f"chip_smoke: needs {min_count} GPUs, JAX found {len(devs)}"
        )
    return devs


def card_label() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform, "kind": d.device_kind,
            "count": len(devices),
        },
    })


def deviation(got, ref, relative_to_peak: bool) -> float:
    """Max |got - ref| (over positions where ref is finite), divided by
    max |ref| when ``relative_to_peak``. NaN positions must agree: the mel
    filterbank's 0/0 triangle weights are a reference quirk, not noise."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        raise CheckFailed(f"shape {got.shape} != reference {ref.shape}")
    nan_g, nan_r = np.isnan(got), np.isnan(ref)
    if not np.array_equal(nan_g, nan_r):
        return float("inf")
    if not np.isfinite(got[~nan_g]).all():
        return float("inf")
    fin = ~nan_r
    if not fin.any():
        return 0.0
    d = float(np.max(np.abs(got[fin] - ref[fin])))
    if relative_to_peak:
        d /= max(float(np.max(np.abs(ref[fin]))), 1e-30)
    return d


def check(tag: str, got, ref, bound: float, relative_to_peak: bool) -> float:
    """Print the deviation beside its bound; raise CheckFailed beyond it."""
    d = deviation(got, ref, relative_to_peak)
    kind = "rel-to-peak" if relative_to_peak else "abs"
    ok = d <= bound
    print(f"  {tag}: max {kind} dev {d:.3e} (bound {bound:g})"
          f"{'' if ok else '  FAIL'}", flush=True)
    if not ok:
        raise CheckFailed(f"{tag}: {d:.3e} > {bound:g}")
    return d


def check_close(tag: str, got, ref, atol: float, rtol: float) -> float:
    """|got - ref| <= atol + rtol*|ref| elementwise; prints the max abs
    deviation and the worst share of the allowance."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        raise CheckFailed(f"{tag}: shape {got.shape} != {ref.shape}")
    if not np.array_equal(np.isnan(got), np.isnan(ref)):
        raise CheckFailed(f"{tag}: NaN positions differ")
    fin = ~np.isnan(ref)
    diff = np.abs(got[fin] - ref[fin])
    allow = atol + rtol * np.abs(ref[fin])
    with np.errstate(divide="ignore", invalid="ignore"):
        share = float(np.max(np.where(diff == 0, 0.0, diff / allow),
                             initial=0.0))
    ok = share <= 1.0
    print(f"  {tag}: max abs dev {float(np.max(diff, initial=0)):.3e} "
          f"(bound atol {atol:g} + rtol {rtol:g}*|ref|, {share:.2f} of it)"
          f"{'' if ok else '  FAIL'}", flush=True)
    if not ok:
        raise CheckFailed(f"{tag}: {share:.2f} of the allowance")
    return share


def time_ms(fn, *args, warmup: int = 2, repeats: int = 5):
    """Median and min wall ms of ``fn(*args)`` to completion."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)), float(min(times))


def bench_cfg(kwta: bool, sample_rate: int = SR):
    """bench.py's configuration: processspeech gabor bank, 2-D layout."""
    from auditory_tpu.config import (
        GaborSet, SndEnvConfig, clamp_mel_to_nyquist, default_gabor_specs,
    )

    cfg = SndEnvConfig(
        gabor=GaborSet(
            size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
            specs=default_gabor_specs(phases=(0.0, 1.5708)),
        )
    )
    cfg = clamp_mel_to_nyquist(cfg, sample_rate)
    return dataclasses.replace(
        cfg, kwta=dataclasses.replace(cfg.kwta, on=kwta)
    )


def make_signals(b: int, n: int, sample_rate: int, seed: int = 0):
    """Broadband speech-band test signals [b, n] f32 and true lengths in
    [0.8 n, n]: a tone plus white noise reaches every DFT bin, so no bin
    escapes the precision check."""
    r = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / sample_rate
    base = (0.3 * np.sin(2 * np.pi * 1234.0 * t)).astype(np.float32)
    sigs = base[None] + np.float32(0.1) * r.standard_normal(
        (b, n), dtype=np.float32
    )
    lens = r.integers(int(0.8 * n), n + 1, size=b).astype(np.int32)
    lens[0] = n
    return sigs, lens


def _run_batched(env, device, sigs, lens, mesh=None):
    import jax

    from auditory_tpu.pipeline.batch import BatchedSndEnv

    with jax.default_device(device):
        res = BatchedSndEnv(env, mesh=mesh).process(sigs, lens)
        return jax.block_until_ready(res)


def _host(out, keys):
    return {k: np.asarray(getattr(out, k)) for k in keys}


# ----------------------------------------------------------------- phases


def phase_batch(dev, cpu, label, batch=512, seconds=3.0, rows=8):
    """Phase 1: the corpus batch at full width, kWTA off and on, plus an
    f32 comparison with the same program on the CPU."""
    import jax
    import jax.numpy as jnp

    from auditory_tpu.pipeline.batch import BatchedSndEnv, bucket_length
    from auditory_tpu.pipeline.sndenv import SndEnv

    n = bucket_length(int(seconds * SR), SndEnv(bench_cfg(False), SR).timing)
    sigs, lens = make_signals(batch, n, SR)
    print(f"phase batch: B={batch} x {n} samples "
          f"({sigs.nbytes / 1e6:.0f} MB in), highest [{label}]", flush=True)
    ref_env = SndEnv(bench_cfg(True), SR, dtype=jnp.float32)
    ref, _ = _run_batched(ref_env, cpu, sigs[:rows], lens[:rows])
    ref = _host(ref, ("power_segment",) + FEATURES)

    for kwta in (False, True):
        env = SndEnv(bench_cfg(kwta), SR, dtype=jnp.float32, outputs=FEATURES)
        fn = BatchedSndEnv(env).process_fn(n, 0)
        with jax.default_device(dev):
            s_d = jax.device_put(sigs, dev)
            l_d = jax.device_put(lens, dev)
            out, _ = jax.block_until_ready(fn(s_d, l_d))
            med, best = time_ms(fn, s_d, l_d)
        audio_s = float(lens.sum()) / SR
        print(f"  kwta={'on' if kwta else 'off'}: {med:.2f} ms/batch median "
              f"(min {best:.2f}), {audio_s / (med / 1e3):.0f} audio s/s "
              f"[{label}]", flush=True)
        for k in FEATURES:
            v = np.asarray(getattr(out, k))
            if v.shape[0] != batch:
                raise CheckFailed(f"{k}: batch axis {v.shape[0]} != {batch}")
        head = {k: np.asarray(getattr(out, k))[:rows] for k in FEATURES}
        for k in ("mel_fbank_segment", "gabor_raw") + (
            ("gabor_kwta",) if kwta else ()
        ):
            check(f"B={batch} rows 0-{rows - 1} {k} vs CPU f32", head[k],
                  ref[k], *BOUNDS[k])

    # every output (incl. the power visualization tensor) on a slice
    full_env = SndEnv(bench_cfg(True), SR, dtype=jnp.float32)
    got, _ = _run_batched(full_env, dev, sigs[:rows], lens[:rows])
    got = _host(got, ("power_segment",) + FEATURES)
    for k, (bound, rel) in BOUNDS.items():
        check(f"{rows}-row {k} vs CPU f32", got[k], ref[k], bound, rel)
    return sigs[:rows], lens[:rows], ref


def phase_tiers(dev, label, sigs, lens, ref):
    """Phase 2: grade the reduced-precision tiers against the CPU f32
    reference (printed, not asserted: a tier's grade is the card's)."""
    import jax.numpy as jnp

    from auditory_tpu.pipeline.sndenv import SndEnv

    print(f"phase tiers: {sigs.shape[0]} rows vs CPU f32 [{label}]",
          flush=True)
    grades = {}
    for tier in ("high", "default"):
        env = SndEnv(bench_cfg(True), SR, dtype=jnp.float32,
                     matmul_precision=tier)
        out, _ = _run_batched(env, dev, sigs, lens)
        grades[tier] = {}
        for k, (_, rel) in BOUNDS.items():
            v = np.asarray(getattr(out, k))
            if v.shape != ref[k].shape:
                raise CheckFailed(f"{tier} {k}: shape {v.shape}")
            d = deviation(v, ref[k], rel)
            grades[tier][k] = d
            print(f"  {tier}: {k} max {'rel-to-peak' if rel else 'abs'} dev "
                  f"{d:.3e}", flush=True)
    return grades


def phase_frontends(dev, cpu, label, batch=512, seconds=3.0, rows=8,
                    rates=(16000, 44100), repeats=5):
    """Phase 3: the three XLA spectrum frontends, bare and inside the
    feature pipeline, at each geometry; each bare frontend is checked
    against the CPU conv frontend on the first rows."""
    import jax
    import jax.numpy as jnp

    from auditory_tpu.dsp import dft
    from auditory_tpu.pipeline.batch import BatchedSndEnv, bucket_length
    from auditory_tpu.pipeline.sndenv import SndEnv

    fronts = {
        "conv": dft.power_spectrum_conv,
        "frames": dft.power_spectrum_frames,
        "windowed": dft.power_spectrum_windows,
    }
    timings = {}
    for sr in rates:
        cfg = bench_cfg(False, sr)
        env0 = SndEnv(cfg, sr, dtype=jnp.float32)
        t = env0.timing
        n = bucket_length(int(seconds * sr), t)
        flat, _, _ = env0._window_grid(max(env0.seg_cnt(n), 0), 0)
        off0, n_win = int(flat[0]), int(flat.shape[0])
        sigs, lens = make_signals(batch, n, sr, seed=1)
        geo = f"{t.win_samples}/{t.step_samples}"
        pick = dft.preferred_spectrum_frontend(t.step_samples, t.win_samples)
        print(f"phase frontends: {geo} ({sr} Hz), B={batch} x {n}, "
              f"{n_win} windows, rule picks {pick} [{label}]", flush=True)

        def bare(name, basis):
            f = fronts[name]
            return jax.jit(lambda s: f(s, basis, t.step_samples, off0, n_win,
                                       precision="highest"))

        # f32 roundoff of each DFT sum grows with its length: the power
        # bound was set at the 400-sample window, so scale it by W/400
        bound, rel = BOUNDS["power_segment"]
        bound *= max(1.0, t.win_samples / 400)
        with jax.default_device(cpu):
            basis_c = tuple(jnp.asarray(b, jnp.float32) for b in env0.dft_basis)
            ref = np.asarray(bare("conv", basis_c)(jnp.asarray(sigs[:rows])))
        with jax.default_device(dev):
            basis_d = tuple(jax.device_put(jnp.asarray(b, jnp.float32), dev)
                            for b in env0.dft_basis)
            s_d = jax.device_put(sigs, dev)
            l_d = jax.device_put(lens, dev)
            for name in fronts:
                f = bare(name, basis_d)
                p = np.asarray(f(s_d)[:rows])
                check(f"{geo} {name} power vs CPU conv", p, ref, bound, rel)
                fe_ms, _ = time_ms(f, s_d, repeats=repeats)
                env = SndEnv(cfg, sr, dtype=jnp.float32, outputs=FEATURES,
                             spectrum_method=name)
                fn = BatchedSndEnv(env).process_fn(n, 0)
                pipe_ms, _ = time_ms(fn, s_d, l_d, repeats=repeats)
                timings[(geo, name)] = (fe_ms, pipe_ms)
                print(f"  {geo} {name}: frontend {fe_ms:.2f} ms/batch, "
                      f"feature pipeline {pipe_ms:.2f} ms/batch (median of "
                      f"{repeats}) [{label}]", flush=True)
    return timings


def _write_wavs(d, count, seed):
    from auditory_tpu.io.wav import float_to_wave, write_wav

    r = np.random.default_rng(seed)
    paths, sigs = [], []
    for i in range(count):
        n = int(r.uniform(1.0, 5.0) * SR)
        t = np.arange(n) / SR
        f0 = r.uniform(100.0, 300.0)
        sig = (0.3 * np.sin(2 * np.pi * f0 * t)
               + 0.1 * np.sin(2 * np.pi * 7.3 * f0 * t)
               + 0.05 * r.standard_normal(n))
        p = os.path.join(d, f"utt{i:03d}.wav")
        write_wav(p, float_to_wave(sig, SR, bit_depth=16))
        paths.append(p)
    return paths


def phase_corpus(dev, label, files=64, build_native=True):
    """Phase 4: CorpusRunner over seeded int16 WAVs (1-5 s) with the native
    decoder, checked against BatchedSndEnv on the same decoded signals."""
    import jax
    import jax.numpy as jnp

    from auditory_tpu.io import native
    from auditory_tpu.io.wav import load_wav
    from auditory_tpu.pipeline.batch import CorpusRunner, bucket_length
    from auditory_tpu.pipeline.sndenv import SndEnv

    if build_native:
        subprocess.run(["make", "-s", "-C", os.path.join(ROOT, "csrc")],
                       check=True, timeout=600)
        if not native.available():
            raise CheckFailed("native decoder built but not loadable")
    decoder = (
        "native int16" if native.available() and native.has_i16()
        else "native float" if native.available() else "python"
    )
    cfg = bench_cfg(True)
    with tempfile.TemporaryDirectory() as tmp, jax.default_device(dev):
        paths = _write_wavs(tmp, files, seed=4)
        out_dir = os.path.join(tmp, "out")
        runner = CorpusRunner(cfg, SR, batch_size=64)
        t0 = time.perf_counter()
        stats = runner.run(paths, out_dir)
        wall = time.perf_counter() - t0
        print(f"phase corpus: {stats.files_done} files "
              f"({stats.audio_seconds:.1f} audio s) in {wall:.2f} s "
              f"incl. compile, decoder {decoder} [{label}]", flush=True)
        if stats.files_done != files or stats.files_failed:
            raise CheckFailed(f"corpus: {stats.files_done} done, "
                              f"{stats.files_failed} failed")

        # reference: the same signals, float-decoded, through one batch
        env = SndEnv(cfg, SR, dtype=jnp.float32,
                     outputs=("mel_fbank_segment", "gabor_kwta"),
                     feature_stats=True)
        padded = [env.pad(load_wav(p).sound_to_tensor(dtype=np.float32))
                  for p in paths]
        n = bucket_length(max(len(s) for s in padded), env.timing)
        sigs = np.zeros((files, n), np.float32)
        lens = np.array([len(s) for s in padded], np.int32)
        for i, s in enumerate(padded):
            sigs[i, : len(s)] = s
        out, _, mom = _run_batched(env, dev, sigs, lens)
        ref = _host(out, ("mel_fbank_segment", "gabor_kwta"))
        for i in (0, files // 3, files - 1):
            got = np.load(os.path.join(out_dir, f"utt{i:03d}.npz"))
            seg = env.seg_cnt(int(lens[i]))
            check(f"utt{i:03d}.npz mel_fbank_segment", got["mel_fbank_segment"],
                  ref["mel_fbank_segment"][i, :seg],
                  *BOUNDS["mel_fbank_segment"])
            check(f"utt{i:03d}.npz gabor_kwta", got["gabor_kwta"],
                  ref["gabor_kwta"][i, :seg], *BOUNDS["gabor_kwta"])
        with open(os.path.join(out_dir, "feature_stats.json")) as f:
            fs = json.load(f)
        cnt = float(np.asarray(mom["count"]))
        if fs["count_steps"] != cnt:
            raise CheckFailed(f"count_steps {fs['count_steps']} != {cnt}")
        mean = np.asarray(mom["sum"], np.float64) / cnt
        var = np.asarray(mom["sumsq"], np.float64) / cnt - mean**2
        check_close("feature_stats mel_mean", fs["mel_mean"], mean,
                    atol=1e-6, rtol=1e-5)
        check_close("feature_stats mel_std", fs["mel_std"],
                    np.sqrt(np.maximum(var, 0.0)), atol=1e-6, rtol=1e-4)
    return decoder


def phase_serving(dev, label, streams=64, seconds=2.0, chunk_ms=100):
    """Phase 5: MultiStreamOnline fed in 100 ms chunks, closed and drained,
    checked stream by stream against offline SndEnv."""
    import jax
    import jax.numpy as jnp

    from auditory_tpu.pipeline.online import MultiStreamOnline
    from auditory_tpu.pipeline.sndenv import SndEnv

    keys = ("mel_fbank_segment", "gabor_kwta", "step_valid")
    cfg = bench_cfg(True)
    r = np.random.default_rng(5)
    n = int(seconds * SR)
    chunk = int(chunk_ms * SR / 1000)
    sigs = (0.3 * np.sin(2 * np.pi * r.uniform(150, 900, (streams, 1))
                         * np.arange(n) / SR)
            + 0.1 * r.standard_normal((streams, n))).astype(np.float32)
    got = {i: {} for i in range(streams)}
    poll_ms = []
    with jax.default_device(dev):
        ms = MultiStreamOnline(cfg, SR, n_streams=streams, outputs=keys)
        for c in range(0, n, chunk):
            for i in range(streams):
                ms.feed(i, sigs[i, c : c + chunk])
            t0 = time.perf_counter()
            res = ms.poll()
            poll_ms.append(1e3 * (time.perf_counter() - t0))
            for i, k, o in res:
                got[i][k] = o
        for i in range(streams):
            ms.close(i)
        for i, k, o in ms.drain():
            got[i][k] = o
        env = SndEnv(cfg, SR, dtype=jnp.float32, outputs=keys)
        offline = [
            jax.block_until_ready(env.process(env.pad(sigs[i])))
            for i in range(streams)
        ]
    steady = sorted(poll_ms[2:]) or sorted(poll_ms)
    print(f"phase serving: {streams} streams x {seconds:g} s in {chunk_ms} ms "
          f"chunks, {len(poll_ms)} polls, poll median "
          f"{steady[len(steady) // 2]:.2f} ms (after 2 warm-up polls) "
          f"[{label}]", flush=True)
    worst = {"mel_fbank_segment": 0.0, "gabor_kwta": 0.0}
    for i in range(streams):
        n_off = offline[i].mel_fbank_segment.shape[0]
        if sorted(got[i]) != list(range(n_off)):
            raise CheckFailed(f"stream {i}: segments {sorted(got[i])} != "
                              f"{n_off} offline")
        for k in worst:
            bound, rel = BOUNDS[k]
            ref = np.asarray(getattr(offline[i], k))
            d = deviation(np.stack([got[i][s][k] for s in range(n_off)]),
                          ref, rel)
            worst[k] = max(worst[k], d)
    for k, d in worst.items():
        bound, rel = BOUNDS[k]
        print(f"  all streams {k} vs offline SndEnv: max "
              f"{'rel-to-peak' if rel else 'abs'} dev {d:.3e} "
              f"(bound {bound:g})", flush=True)
        if not d <= bound:
            raise CheckFailed(f"serving {k}: {d:.3e} > {bound:g}")
    return worst


def phase_f64(label, seconds=1.5):
    """Phase 6: ``cli process --f64`` (float64 + complex128 FFT on the
    device JAX picks) against the float64 Go-semantics oracle. Turns x64
    on for the rest of the process, so it runs last."""
    from types import SimpleNamespace

    import jax

    from auditory_tpu import cli
    from auditory_tpu.io.wav import float_to_wave, load_wav, write_wav
    from auditory_tpu.refemu.goref import SndEnvRef

    r = np.random.default_rng(6)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    sig = (0.4 * np.sin(2 * np.pi * 440.0 * t)
           + 0.2 * np.sin(2 * np.pi * 2500.0 * t)
           + 0.05 * r.standard_normal(n))
    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "tone.wav")
        npz = os.path.join(tmp, "out.npz")
        write_wav(wav, float_to_wave(sig, SR, bit_depth=16))
        t0 = time.perf_counter()
        rc = cli.main(["process", wav, "--f64", "--out", npz])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise CheckFailed(f"cli process --f64 returned {rc}")
        out = dict(np.load(npz))
        x = load_wav(wav).sound_to_tensor(dtype=np.float64)
    platform = jax.default_backend()
    print(f"phase f64: cli process --f64 on {platform}, {wall:.2f} s incl. "
          f"compile [{label}]", flush=True)
    if out["power_segment"].dtype != np.float64:
        raise CheckFailed(f"--f64 produced {out['power_segment'].dtype}")

    defaults = SimpleNamespace(
        win_ms=25.0, step_ms=10.0, segment_ms=100.0, stride_ms=100.0,
        border_steps=2, window_fn=None, mel_filters=32, hi_hz=8000.0,
        no_mfcc=False, no_kwta=False, gabor_size=9, gabor_stride=3,
        gabor_gain=2.0, gabor_phases=2,
    )
    ref = SndEnvRef(cli._build_cfg(defaults))
    ref.init(x, SR)
    ref.init(ref.pad(x), SR)
    keys = ("power_segment", "log_power_segment", "mel_fbank_segment",
            "energy", "mfcc_segment", "mfcc_deltas", "mfcc_delta_deltas")
    n_seg = max(ref.seg_cnt, 0)
    if out["power_segment"].shape[0] != n_seg:
        raise CheckFailed(f"{out['power_segment'].shape[0]} segments != "
                          f"oracle {n_seg}")
    worst = dict.fromkeys(list(keys) + ["gabor_raw"], 0.0)
    for seg in range(n_seg):
        ref.process_segment(seg)
        for k in keys:
            worst[k] = max(worst[k], deviation(out[k][seg], getattr(ref, k),
                                               False))
        worst["gabor_raw"] = max(worst["gabor_raw"], deviation(
            out["gabor_raw"][seg], ref.apply_gabor(), False))
    for k, d in worst.items():
        bound = F64_GABOR_BOUND if k == "gabor_raw" else F64_BOUND
        print(f"  {k} vs f64 oracle: max abs dev {d:.3e} (bound {bound:g})",
              flush=True)
        if not d <= bound:
            raise CheckFailed(f"f64 {k}: {d:.3e} > {bound:g}")
    return worst


def phase_four(devs, label, batch=512, seconds=3.0, long_seconds=600.0):
    """4-card phase: data parallelism over utterances with the per-band
    stats all-reduce, and segment-axis parallelism over one long
    utterance, each compared with the same program on one card."""
    import jax
    import jax.numpy as jnp

    from auditory_tpu.parallel.mesh import make_mesh
    from auditory_tpu.pipeline.batch import bucket_length
    from auditory_tpu.pipeline.sndenv import SndEnv

    devs = list(devs[:4])
    mesh = make_mesh(devs)
    cfg = bench_cfg(True)
    env = SndEnv(cfg, SR, dtype=jnp.float32, outputs=FEATURES,
                 feature_stats=True)
    n = bucket_length(int(seconds * SR), env.timing)
    sigs, lens = make_signals(batch, n, SR, seed=2)
    print(f"phase four: DP over {len(devs)} cards, B={batch} x {n} samples "
          f"[{label}]", flush=True)
    out, sv, mom = _run_batched(env, devs[0], sigs, lens, mesh=mesh)
    placed = {s.device for s in out.mel_fbank_segment.addressable_shards}
    spec = tuple(out.mel_fbank_segment.sharding.spec)
    rows = out.mel_fbank_segment.addressable_shards[0].data.shape[0]
    print(f"  DP output on {len(placed)} cards, spec {spec}, "
          f"{rows} rows per card", flush=True)
    if placed != set(devs) or spec[:1] != ("data",) or rows != batch // 4:
        raise CheckFailed("DP output is not batch-sharded over 4 cards")
    one, sv1, mom1 = _run_batched(env, devs[0], sigs, lens)
    if not np.array_equal(np.asarray(sv), np.asarray(sv1)):
        raise CheckFailed("DP seg_valid differs from one card")
    check_close("DP mel_fbank_segment vs one card",
                out.mel_fbank_segment, one.mel_fbank_segment, 3e-5, 1e-6)
    for k in ("mfcc_segment", "mfcc_deltas", "mfcc_delta_deltas", "energy"):
        check_close(f"DP {k} vs one card", getattr(out, k), getattr(one, k),
                    5e-3, 1e-5)
    check_close("DP gabor_kwta vs one card", out.gabor_kwta, one.gabor_kwta,
                1e-4, 0.0)
    for k, rtol in (("sum", 1e-5), ("sumsq", 1e-5), ("count", 0.0)):
        check_close(f"DP stats {k} (all-reduce) vs one card", mom[k],
                    mom1[k], 0.0 if k == "count" else 1e-3, rtol)

    # segment-axis (CP-style) sharding of one long utterance: 4k segments
    t = env.timing
    n_seg = 4 * max(1, int(long_seconds * SR) // t.stride_samples // 4)
    long_n = t.segment_samples + t.stride_samples * (n_seg - 1)
    long_sig = make_signals(1, long_n, SR, seed=3)[0]
    long_len = np.array([long_n], np.int32)
    senv = SndEnv(cfg, SR, dtype=jnp.float32, outputs=FEATURES)
    from auditory_tpu.pipeline.batch import BatchedSndEnv

    with jax.default_device(devs[0]):
        cp = BatchedSndEnv(senv, mesh=mesh, shard_axis="segment")
        sout, ssv = jax.block_until_ready(cp.process(long_sig, long_len))
    placed = {s.device for s in sout.mel_fbank_segment.addressable_shards}
    sspec = tuple(sout.mel_fbank_segment.sharding.spec)
    segs = sout.mel_fbank_segment.addressable_shards[0].data.shape[1]
    print(f"  CP: {long_n / SR:.1f} s utterance, {n_seg} segments on "
          f"{len(placed)} cards, spec {sspec}, {segs} segments per card",
          flush=True)
    if placed != set(devs) or sspec[:2] != (None, "data") or segs != n_seg // 4:
        raise CheckFailed("CP output is not segment-sharded over 4 cards")
    sone, ssv1 = _run_batched(senv, devs[0], long_sig, long_len)
    if not np.array_equal(np.asarray(ssv), np.asarray(ssv1)):
        raise CheckFailed("CP seg_valid differs from one card")
    check_close("CP mel_fbank_segment vs one card", sout.mel_fbank_segment,
                sone.mel_fbank_segment, 3e-5, 1e-6)
    check_close("CP gabor_kwta vs one card", sout.gabor_kwta,
                sone.gabor_kwta, 1e-4, 0.0)


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    devs = require_gpu(4 if args.four else 1)
    import jax

    from auditory_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    label = card_label()
    print(f"card: {label}; jax {jax.__version__}, "
          f"{len(devs)} x {devs[0].device_kind}", flush=True)
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    if args.four:
        phase_four(devs, label)
        used = devs[:4]
    else:
        dev = devs[0]
        sigs, lens, ref = phase_batch(dev, cpu, label)
        phase_tiers(dev, label, sigs, lens, ref)
        phase_frontends(dev, cpu, label)
        phase_corpus(dev, label)
        phase_serving(dev, label)
        phase_f64(label)
        used = devs[:1]
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s "
          f"[{label}]", flush=True)
    print(result_line(used), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
