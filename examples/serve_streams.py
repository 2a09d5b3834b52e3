"""Multi-stream serving demo: N concurrent audio streams, one device.

Shows the recommended production-serving setup for
:class:`auditory_tpu.pipeline.online.MultiStreamOnline`:

- select only the serving outputs (mel + gabor + validity) so XLA
  dead-code-eliminates everything else (~10x fewer poll bytes);
- pick a transfer tier (float16 halves the per-poll host copy, which is
  what caps stream capacity on a byte-bound link);
- feed arbitrary chunk sizes per stream; poll runs ONE batched device call
  for every stream with a segment pending;
- bound the per-stream buffers and pick an overload policy
  (``max_buffer_seconds`` + ``overflow='error'|'drop_oldest'``) so
  producers that outrun poll() get backpressure or bounded shedding
  instead of unbounded memory growth.

Outputs are bit-identical (f32 tier) to each stream's offline run -- the
same contract tests/test_online.py pins.

Usage: python examples/serve_streams.py [--streams 16] [--seconds 2] [--cpu]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--chunk-ms", type=float, default=100.0)
    ap.add_argument("--f16", action="store_true",
                    help="float16 poll copies (halves poll bytes)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from auditory_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()  # repeat runs skip recompilation

    from auditory_tpu.config import GaborSet, SndEnvConfig, default_gabor_specs
    from auditory_tpu.pipeline.online import MultiStreamOnline

    sr = 16000
    cfg = SndEnvConfig(
        gabor=GaborSet(
            size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
            specs=default_gabor_specs(phases=(0.0, 1.5708)),
        )
    )
    ms = MultiStreamOnline(
        cfg, sr, n_streams=args.streams,
        outputs=("mel_fbank_segment", "gabor_kwta", "step_valid"),
        transfer_dtype=jnp.float16 if args.f16 else None,
        # production overload policy: bounded buffers + backpressure (a
        # feed that would overflow raises BufferOverflow; this demo's
        # feed/poll cadence never accumulates more than one chunk)
        max_buffer_seconds=10.0, overflow="error",
    )

    rng = np.random.default_rng(0)
    chunk_n = int(sr * args.chunk_ms / 1000.0)
    n_chunks = int(args.seconds * 1000.0 / args.chunk_ms)
    freqs = rng.uniform(300, 3000, size=args.streams)

    got = {s: 0 for s in range(args.streams)}
    poll_ms = []
    pos = 0
    for _ in range(n_chunks):
        t = (pos + np.arange(chunk_n)) / sr
        pos += chunk_n
        for s in range(args.streams):
            chunk = (0.3 * np.sin(2 * np.pi * freqs[s] * t)).astype(np.float32)
            ms.feed(s, chunk)
        t0 = time.perf_counter()
        n_emitted = 0
        for s, seg_idx, out in ms.poll():
            got[s] += 1
            n_emitted += 1
            assert out["mel_fbank_segment"].ndim == 2  # [n_mel, steps]
        # only polls that actually ran the device batch count (empty polls
        # early-exit in microseconds and would skew the median)
        if n_emitted:
            poll_ms.append((time.perf_counter() - t0) * 1e3)
    for s in range(args.streams):
        ms.close(s)
    for s, seg_idx, out in ms.drain():
        got[s] += 1

    segs = sum(got.values())
    audio_sec = args.streams * args.seconds
    print(f"streams: {args.streams}, segments emitted: {segs} "
          f"({segs // args.streams}/stream)")
    if poll_ms:
        print(f"median poll: {np.median(poll_ms):.2f} ms per "
              f"{args.streams}-stream batch")
    print(f"audio processed: {audio_sec:.1f} s")
    # segs > 0 first: with zero emissions the balance check is vacuously
    # true and SERVE_OK would be a false positive
    assert segs > 0, "no segments emitted (audio shorter than one segment?)"
    assert all(v == segs // args.streams for v in got.values())
    print("SERVE_OK")


if __name__ == "__main__":
    main()
