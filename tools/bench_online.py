"""Serving-latency benchmark: single-stream OnlineSndEnv per-segment latency
and MultiStreamOnline aggregate throughput on the current backend.

    PYTHONPATH=. python tools/bench_online.py [--overload] [--capacity-table]

Prints one JSON line per scenario.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


SERVING_SR = 16000
SERVING_OUTPUTS = ("mel_fbank_segment", "gabor_kwta", "step_valid")


def serving_cfg():
    """THE serving benchmark config: one definition shared by the
    single-stream/aggregate/overload scenarios AND the capacity table, so
    the artifacts always measure the same program."""
    from auditory_tpu.config import GaborSet, SndEnvConfig, \
        default_gabor_specs

    return SndEnvConfig(
        gabor=GaborSet(
            size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
            specs=default_gabor_specs(phases=(0.0, 1.5708)),
        )
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--chunks", type=int, default=50, help="100 ms chunks fed")
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument(
        "--outputs", choices=("all", "features"), default="all",
        help="features = mel+gabor+step_valid only (the serving workload; "
        "XLA DCEs the rest and the poll copy shrinks ~10x)",
    )
    ap.add_argument("--f16", action="store_true",
                    help="float16 poll copies (multi-stream)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 quantized poll copies (multi-stream, lossy)")
    ap.add_argument("--overload", action="store_true",
                    help="also run the overload scenario: producers feed 4x "
                    "faster than real time into bounded drop_oldest buffers; "
                    "reports per-poll p50/p99 latency and drop counts")
    ap.add_argument("--poll-k", type=str, default="1",
                    help="max_segments_per_poll for the overload scenario; "
                    "a comma list (e.g. 1,4) runs the K scenarios in "
                    "interleaved epochs so drift over the run hits every K "
                    "equally and the comparison is fair")
    ap.add_argument("--pipeline-depth", type=str, default="1",
                    help="MultiStreamOnline pipeline_depth; a comma list "
                    "(e.g. 1,2) runs the scenarios interleaved (both the "
                    "aggregate and overload runs). D>=2 overlaps poll N+1's "
                    "device compute with poll N's packed host copy")
    ap.add_argument("--capacity-table", action="store_true",
                    help="ONE epoch-interleaved invocation sweeping "
                    "{64,128,256,512} streams x {f32,f16,int8} x depth "
                    "{1,2} (serving outputs); every cell sees the same "
                    "drift, so cross-cell deltas are paired-fair")
    ap.add_argument("--epochs", type=int, default=6,
                    help="capacity-table interleaved epochs")
    ap.add_argument("--cycles", type=int, default=4,
                    help="capacity-table feed+poll cycles per epoch per cell")
    ap.add_argument("--streams-list", type=str, default="64,128,256,512",
                    help="capacity-table stream counts (comma list; the "
                    "default is the official table's grid)")
    ap.add_argument("--profile-poll", action="store_true",
                    help="with --overload: time each poll phase "
                    "(gather/h2d/dispatch/compute/d2h/unpack/emit) and "
                    "report per-phase p50/p99 -- the tail-attribution "
                    "drill-down (adds a block_until_ready between "
                    "dispatch and the host copy)")
    args = ap.parse_args()

    from auditory_tpu.pipeline.online import MultiStreamOnline, OnlineSndEnv
    from auditory_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if args.capacity_table:
        return _capacity_table(args)
    sr = SERVING_SR
    chunk_n = sr // 10  # 100 ms
    cfg = serving_cfg()
    rng = np.random.default_rng(0)

    # single stream: per-100ms-chunk wall latency once steady-state
    outputs_sel = (
        None if args.outputs == "all"
        else ("mel_fbank_segment", "gabor_kwta", "step_valid")
    )
    online = OnlineSndEnv(cfg, sr, outputs=outputs_sel)
    lat = []
    for i in range(args.warmup + args.chunks):
        chunk = (0.1 * rng.standard_normal(chunk_n)).astype(np.float32)
        t0 = time.perf_counter()
        n_out = sum(1 for _ in online.feed(chunk))
        dt = time.perf_counter() - t0
        if i >= args.warmup and n_out:
            lat.append(dt)
    print(json.dumps({
        "metric": "online_single_stream_latency_ms_per_100ms_chunk",
        "value": round(float(np.median(lat)) * 1e3, 2),
        "p90_ms": round(float(np.quantile(lat, 0.9)) * 1e3, 2),
        "segments": len(lat),
    }))

    # multi-stream: aggregate real-time factor over one poll cycle
    import jax.numpy as jnp

    td = jnp.int8 if args.int8 else jnp.float16 if args.f16 else None
    depths = [int(x) for x in str(args.pipeline_depth).split(",")]
    # one instance per depth, measured in INTERLEAVED epochs (same
    # fairness design as the overload --poll-k comparison: sequential
    # depth runs would confound drift with depth).
    # Each epoch flushes its pipeline inside its own timed window — D>=2
    # pays its fill/drain at every epoch boundary (conservative) and
    # never gets free compute time while other depths hold the clock.
    mss, agg = {}, {}
    for depth in depths:
        ms = MultiStreamOnline(cfg, sr, n_streams=args.streams,
                               outputs=outputs_sel, transfer_dtype=td,
                               pipeline_depth=depth)
        # steady state: everyone buffered past the first segment
        for _ in range(args.warmup):
            for s in range(args.streams):
                ms.feed(
                    s, (0.1 * rng.standard_normal(chunk_n)).astype(np.float32)
                )
            list(ms.poll())
        ms.flush_pipeline()  # quiesce: no free warmup harvests
        mss[depth] = ms
        agg[depth] = dict(t=0.0, n=0)
    agg_epochs = 4
    agg_per_epoch = max(1, args.chunks // agg_epochs)
    for _ in range(agg_epochs):
        for depth, ms in mss.items():
            a = agg[depth]
            t0 = time.perf_counter()
            for _ in range(agg_per_epoch):
                for s in range(args.streams):
                    ms.feed(
                        s,
                        (0.1 * rng.standard_normal(chunk_n))
                        .astype(np.float32),
                    )
                a["n"] += sum(1 for _ in ms.poll())
            a["n"] += len(ms.flush_pipeline())
            a["t"] += time.perf_counter() - t0
    for depth in depths:
        a = agg[depth]
        audio_sec = agg_epochs * agg_per_epoch * args.streams * 0.1
        print(json.dumps({
            "metric": "multistream_aggregate",
            "streams": args.streams,
            "outputs": args.outputs,
            "transfer": "int8" if args.int8 else "f16" if args.f16 else "f32",
            "pipeline_depth": depth,
            "ms_per_segment": round(a["t"] / max(a["n"], 1) * 1e3, 2),
            "aggregate_rtf": round(audio_sec / a["t"], 1),
            "segments": a["n"],
        }))

    if args.overload:
        # overload: each cycle feeds 400 ms of audio per stream but polls
        # once -- drain capacity is max_segments_per_poll segments (100 ms
        # stride each) per stream per poll, so K=1 producers outrun poll()
        # 4x. Bounded 2 s buffers with drop_oldest keep per-poll cost flat;
        # the poll latency distribution under pressure is the serving
        # p50/p99. --poll-k takes a comma list (e.g. 1,4): the K
        # scenarios run in INTERLEAVED epochs so drift hits every K
        # equally and the comparison is fair.
        ks = [int(x) for x in str(args.poll_k).split(",")]
        scenarios = [(k, d) for k in ks for d in depths]
        runs = {}
        for k, d in scenarios:
            ms2 = MultiStreamOnline(
                cfg, sr, n_streams=args.streams, outputs=outputs_sel,
                transfer_dtype=td, max_buffer_seconds=2.0,
                overflow="drop_oldest", profile=args.profile_poll,
                max_segments_per_poll=k, pipeline_depth=d,
            )
            for _ in range(args.warmup):
                for s in range(args.streams):
                    ms2.feed(
                        s, (0.1 * rng.standard_normal(4 * chunk_n))
                        .astype(np.float32),
                    )
                list(ms2.poll())
            ms2.flush_pipeline()  # quiesce (see the aggregate run)
            # dropped_segments() is cumulative from stream creation;
            # snapshot after warmup so drop_frac reflects the measured
            # phase only (the warmup cycles shed segments too and would
            # bias the ratio high)
            runs[(k, d)] = dict(
                ms=ms2, lat=[], n_seg=0,
                dropped0=sum(
                    ms2.dropped_segments(s) for s in range(args.streams)
                ),
            )
        epochs = 4
        per_epoch = max(1, args.chunks // epochs)
        for _ in range(epochs):
            for kd in scenarios:
                r = runs[kd]
                for _ in range(per_epoch):
                    for s in range(args.streams):
                        r["ms"].feed(
                            s, (0.1 * rng.standard_normal(4 * chunk_n))
                            .astype(np.float32),
                        )
                    t0 = time.perf_counter()
                    r["n_seg"] += sum(1 for _ in r["ms"].poll())
                    r["lat"].append(time.perf_counter() - t0)
        # flush in-flight pipelined calls (harvest only, no new dispatch:
        # draining the overload backlog here would distort the scenario)
        # so D>=2 counts every dispatched segment
        for r in runs.values():
            if r["ms"]._inflight:
                t0 = time.perf_counter()
                r["n_seg"] += len(r["ms"].flush_pipeline())
                r["lat"].append(time.perf_counter() - t0)
        _report_overload(args, runs, scenarios)


def _capacity_table(args) -> None:
    """The serving capacity table as ONE artifact: every (streams,
    transfer, depth) cell measured in interleaved epochs within this single
    invocation, so drift over the run hits every cell equally and
    cross-cell deltas are epoch-paired and fair."""
    import time as _time

    import jax.numpy as jnp
    import numpy as np

    from auditory_tpu.pipeline.online import MultiStreamOnline

    sr = SERVING_SR
    chunk_n = sr // 10
    cfg = serving_cfg()
    outputs_sel = SERVING_OUTPUTS
    rng = np.random.default_rng(0)
    # pre-generated chunk pool: host-side rng must not sit inside the
    # timed windows (512 streams x 1600 samples x many cycles)
    pool = [
        (0.1 * rng.standard_normal(chunk_n)).astype(np.float32)
        for _ in range(101)
    ]
    streams_list = [int(x) for x in args.streams_list.split(",")]
    scenarios = [
        (s, tname, td, d)
        for s in streams_list
        for tname, td in (("f32", None), ("f16", jnp.float16),
                          ("int8", jnp.int8))
        for d in (1, 2)
    ]
    runs = {}
    for s, tname, td, d in scenarios:
        ms = MultiStreamOnline(
            cfg, sr, n_streams=s, outputs=outputs_sel, transfer_dtype=td,
            pipeline_depth=d, max_buffer_seconds=5.0,
        )
        for _ in range(args.warmup):
            for sid in range(s):
                ms.feed(sid, pool[(sid + 1) % len(pool)])
            list(ms.poll())
        ms.flush_pipeline()
        # one untimed epoch-shaped pass (cycles + flush): compiles every
        # program the timed epochs will run, incl. the flush-path buckets
        # (a cold first epoch would contaminate all 24 cells' pairings)
        for _ in range(args.cycles):
            for sid in range(s):
                ms.feed(sid, pool[sid % len(pool)])
            list(ms.poll())
        ms.flush_pipeline()
        runs[(s, tname, d)] = dict(ms=ms, epoch_t=[], epoch_n=[])
        print(json.dumps({"warmed": [s, tname, d]}), flush=True)

    ci = 0
    for _ in range(args.epochs):
        for s, tname, td, d in scenarios:
            r = runs[(s, tname, d)]
            ms = r["ms"]
            n = 0
            t0 = _time.perf_counter()
            for _ in range(args.cycles):
                for sid in range(s):
                    ms.feed(sid, pool[ci % len(pool)])
                    ci += 1
                n += sum(1 for _ in ms.poll())
            n += len(ms.flush_pipeline())  # D=2 pays its drain every epoch
            r["epoch_t"].append(_time.perf_counter() - t0)
            r["epoch_n"].append(n)

    by_cell = {}
    for s, tname, td, d in scenarios:
        r = runs[(s, tname, d)]
        t_sum, n_sum = sum(r["epoch_t"]), sum(r["epoch_n"])
        audio = args.epochs * args.cycles * s * 0.1
        # per-epoch rtf list enables paired cross-cell comparisons
        rtfs = [
            args.cycles * s * 0.1 / t for t in r["epoch_t"]
        ]
        by_cell[(s, tname, d)] = rtfs
        print(json.dumps({
            "metric": "capacity_cell",
            "streams": s, "transfer": tname, "pipeline_depth": d,
            "aggregate_rtf": round(audio / t_sum, 1),
            "ms_per_segment": round(t_sum / max(n_sum, 1) * 1e3, 3),
            "segments": n_sum,
            "epoch_rtf": [round(x, 1) for x in rtfs],
        }), flush=True)

    # paired verdicts: int8 vs f16 and D2 vs D1, per stream count
    for s in streams_list:
        for (name, a_key, b_key) in (
            ("int8_vs_f16_D1", (s, "int8", 1), (s, "f16", 1)),
            ("int8_vs_f16_D2", (s, "int8", 2), (s, "f16", 2)),
            ("D2_vs_D1_f16", (s, "f16", 2), (s, "f16", 1)),
        ):
            a, b = np.asarray(by_cell[a_key]), np.asarray(by_cell[b_key])
            deltas = (a - b) / b
            wins = int((deltas > 0).sum())
            print(json.dumps({
                "paired": name, "streams": s,
                "median_delta_pct": round(float(np.median(deltas)) * 100, 1),
                "wins": f"{wins}/{len(deltas)}",
            }), flush=True)


def _report_overload(args, runs, scenarios):
    for k, d in scenarios:
        r = runs[(k, d)]
        ms2, lat2, n_seg2 = r["ms"], r["lat"], r["n_seg"]
        dropped = sum(
            ms2.dropped_segments(s) for s in range(args.streams)
        ) - r["dropped0"]
        print(json.dumps({
            "metric": "multistream_overload_4x",
            "streams": args.streams,
            "poll_k": k,
            "pipeline_depth": d,
            "ms_per_segment": round(
                float(np.sum(lat2)) * 1e3 / max(n_seg2, 1), 3
            ),
            "poll_p50_ms": round(float(np.median(lat2)) * 1e3, 2),
            "poll_p99_ms": round(float(np.quantile(lat2, 0.99)) * 1e3, 2),
            "segments_emitted": n_seg2,
            "segments_dropped": int(dropped),
            "drop_frac": round(
                dropped / max(dropped + n_seg2, 1), 3
            ),
        }))
        if args.profile_poll and ms2.poll_phases:
            # drop the warmup polls (first poll's dispatch includes the
            # compile) so the stats reflect the steady state only
            arrs = {
                ph: np.asarray(v[args.warmup:] or v)
                for ph, v in ms2.poll_phases.items()
            }
            phases = {
                ph: {
                    "p50_ms": round(float(np.median(a)) * 1e3, 2),
                    "p99_ms": round(float(np.quantile(a, 0.99)) * 1e3, 2),
                }
                for ph, a in arrs.items()
            }
            # which phase explains the slow polls: mean share of each
            # phase inside the slowest poll decile. With pipeline_depth
            # >= 2 the phase arrays can differ in length (a poll that
            # dispatched without harvesting records only 3 phases) --
            # trim to the common prefix for the joint statistic
            n_min = min(len(a) for a in arrs.values())
            arrs = {ph: a[:n_min] for ph, a in arrs.items()}
            tot = np.sum(list(arrs.values()), axis=0)
            slow = tot >= np.quantile(tot, 0.9)
            shares = {
                ph: round(float(a[slow].sum() / tot[slow].sum()), 3)
                for ph, a in arrs.items()
            }
            print(json.dumps({
                "metric": "poll_phase_profile",
                "streams": args.streams,
                "poll_k": k,
                "pipeline_depth": d,
                "phases": phases,
                "slow_decile_share": shares,
            }))


if __name__ == "__main__":
    main()
