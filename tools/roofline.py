"""Per-geometry speed-of-light statement for the spectrum frontends.

Analytic floors for the mel frontend's dominant op -- the rectangular-
window DFT of dft/dft.go:42-59 -- on one accelerator, so measured
frontend times (``chip_smoke.py`` phase 3) can be judged against hardware
limits instead of against each other. For each frontend the floor is

    max(MAC time at the precision tier's peak rate, HBM traffic time)

over exact (unpadded) MAC counts and the f32 words each formulation must
move. Peak rates come from :data:`PEAKS`, keyed by JAX's ``device_kind``;
an unknown kind raises rather than assuming a rate.

Usage:
    python tools/roofline.py --device-kind "NVIDIA H100 80GB HBM3"
                             [--rate 48000 --win-ms 25 --step-ms 10]
                             [--batch 512 --seconds 3]
                             [--precision highest|high|default]

Pure host math -- no jax, safe to run anywhere.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from auditory_tpu.config import SndEnvConfig
from auditory_tpu.dsp.dft import factored_dft_plan, preferred_spectrum_frontend

# Peak rates per device_kind. Source: NVIDIA H100 Tensor Core GPU datasheet,
# SXM column: HBM3 3.35 TB/s; FP32 67 TFLOP/s (no tensor cores -- what the
# 'highest' tier runs); TF32 tensor core 989 TFLOP/s with sparsity, 495
# dense (what 'high' and 'default' may run).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "hbm_bytes": 3.35e12,
    },
}


def peak_rates(device_kind: str, precision: str = "highest"):
    """(MAC/s, f32 words/s) of ``device_kind`` at a precision tier."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no peak rates for device_kind {device_kind!r}; known: "
            f"{sorted(PEAKS)}"
        )
    if precision not in ("highest", "high", "default"):
        raise ValueError(f"unknown precision tier {precision!r}")
    p = PEAKS[device_kind]
    flops = p["f32_flops"] if precision == "highest" else p["tf32_flops"]
    return flops / 2, p["hbm_bytes"] / 4


def _derive(rate: int, win_ms: float, step_ms: float):
    """The pipeline's ms->samples derivation (config.Params.derive,
    mirroring sound.Params.MSecToSamples -- 44.1 kHz gives win=1103,
    which is prime; a naive round() would give 1102). ONE derivation per
    floors call; geometry() and the off-grid block both consume it."""
    cfg = SndEnvConfig()
    cfg = dataclasses.replace(
        cfg, params=dataclasses.replace(
            cfg.params, win_ms=win_ms, step_ms=step_ms)
    )
    return cfg.params.derive(rate)


def geometry(rate: int, win_ms: float, step_ms: float):
    t = _derive(rate, win_ms, step_ms)
    return t.win_samples, t.step_samples, t.win_samples // 2 + 1, \
        t.stride_samples


def _factored_macs_words(plan) -> tuple:
    """Exact MACs and materialized f32 words per window of a factored
    plan: stage-1 real DFTs over N2 subsequences, stage 2 against the
    folded twiddle matrices, the complex stage-1 intermediate written and
    read once, plus the windows tensor in the non-polyphase mode."""
    stage1 = plan.n2 * plan.n1 * 2 * plan.h1
    stage2 = 2 * plan.h1 * plan.n2 * 4 * plan.k2
    words = 2 * plan.n2 * 2 * plan.h1
    if not plan.polyphase:
        words += 2 * plan.win
    return stage1 + stage2, words


def frontend_floors(rate: int, win_ms: float = 25.0, step_ms: float = 10.0,
                    batch: int = 512, seconds: float = 3.0, *,
                    device_kind: str, precision: str = "highest") -> dict:
    """Floor times (ms) per frontend for a [batch, seconds] corpus slab on
    ``device_kind`` at a precision tier (raises KeyError for a kind
    without a :data:`PEAKS` entry)."""
    macs_per_s, words_per_s = peak_rates(device_kind, precision)
    tm = _derive(rate, win_ms, step_ms)
    win, step, k, stride = (tm.win_samples, tm.step_samples,
                            tm.win_samples // 2 + 1, tm.stride_samples)
    n_windows = int(seconds * 1000.0 / step_ms)  # per signal (grid steps)
    nw_total = batch * n_windows

    # common traffic: read the signal slab once, write the power once.
    # (The downstream mel matmul fuses; the power tensor itself may also
    # fuse into the mel contraction, so the write charge is an upper floor
    # for standalone-frontend timing.)
    in_words = batch * int(seconds * rate)
    out_words = nw_total * k
    base_words = in_words + out_words
    dense_macs = nw_total * win * 2 * k  # one W-deep dot per (window, col)

    rows = {}

    # conv: implicit GEMM; the floor charges only the ideal single read of
    # the signal (the measured gap above it is the lowering's).
    rows["conv"] = (dense_macs, base_words)

    # frames: J shifted dense GEMMs over step-frames whose blocks tile the
    # window exactly (same MACs), but the frame tensor is re-read J times.
    j = max(1, -(-win // step))
    rows["frames"] = (dense_macs, in_words * j + out_words)

    # windowed: ONE dense GEMM over gather-free materialized windows,
    # plus write+read of the [nW, W] windows tensor (2W words/window).
    rows["windowed"] = (dense_macs, base_words + 2 * win * nw_total)

    # sliced: p = ceil(W/step) interleaved pure-reshape GEMMs (p == j)
    # contracting the full chunk p*step >= W, each reading ~the whole
    # signal slab; no materialized windows tensor.
    rows["sliced"] = (nw_total * j * step * 2 * k, in_words * j + out_words)

    # factored: exact two-stage MACs plus its intermediate traffic.
    plan = factored_dft_plan(win, step, allow_dominated=True)
    if plan is not None:
        macs, words = _factored_macs_words(plan)
        rows["factored"] = (nw_total * macs, base_words + nw_total * words)

    out = {
        "rate": rate, "win": win, "step": step, "k": k,
        "batch": batch, "seconds": seconds,
        "device_kind": device_kind, "precision": precision,
        "dispatch": preferred_spectrum_frontend(step, win, precision),
        "audio_s": batch * seconds,
    }
    floors = {}
    floor_s = {}
    for name, (macs, words) in rows.items():
        t_flop = macs / macs_per_s
        t_mem = words / words_per_s
        floor_s[name] = max(t_flop, t_mem)  # unrounded, for the RTF divide
        floors[name] = {
            "flop_ms": round(1e3 * t_flop, 3),
            "mem_ms": round(1e3 * t_mem, 3),
            "floor_ms": round(1e3 * max(t_flop, t_mem), 3),
            "bound": "flop" if t_flop >= t_mem else "mem",
        }
    if plan is not None:
        floors["factored"]["split"] = f"{plan.n1}*{plan.n2}" + (
            "" if plan.polyphase else " (windowed)"
        )
    if stride % step != 0:
        # off-grid geometry (e.g. 22.05 kHz stride 2205, step 221): no
        # uniform window grid exists, so the pipeline's frontend is the
        # per-window take-along gather + dense GEMM, over seg_cnt *
        # segment_steps PER-SEGMENT windows (the border-overlap windows
        # recompute per segment). The gather reads the indexed samples
        # and writes the windows tensor (2W words/window) at peak HBM
        # bandwidth -- an ideal the gather lowering may not reach.
        n_samples = int(seconds * rate)
        seg_cnt = max((n_samples - tm.segment_samples) // stride + 1, 0)
        nw_off = batch * seg_cnt * tm.segment_steps
        t_flop = nw_off * win * 2 * k / macs_per_s
        t_mem = (in_words + nw_off * k + 2 * win * nw_off) / words_per_s
        floor_s["gather"] = max(t_flop, t_mem)
        floors["gather"] = {
            "flop_ms": round(1e3 * t_flop, 3),
            "mem_ms": round(1e3 * t_mem, 3),
            "floor_ms": round(1e3 * max(t_flop, t_mem), 3),
            "bound": "flop" if t_flop >= t_mem else "mem",
        }
        out["dispatch"] = "gather (off-grid)"
    out["floors"] = floors
    out["rtf_at_floor"] = {
        name: round(out["audio_s"] / floor_s[name])
        for name in floors
    }
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=int, default=None)
    ap.add_argument("--win-ms", type=float, default=25.0)
    ap.add_argument("--step-ms", type=float, default=10.0)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device-kind", required=True, choices=sorted(PEAKS),
                    help="JAX device_kind whose peak rates set the floors")
    ap.add_argument("--precision", default="highest",
                    choices=("highest", "high", "default"))
    args = ap.parse_args()
    rates = [args.rate] if args.rate else [8000, 16000, 22050, 32000,
                                           44100, 48000]
    for r in rates:
        print(json.dumps(frontend_floors(
            r, args.win_ms, args.step_ms, args.batch, args.seconds,
            device_kind=args.device_kind, precision=args.precision)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
