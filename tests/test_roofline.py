"""Smoke tests for tools/roofline.py (the per-geometry speed-of-light
statement for the spectrum frontends)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from roofline import PEAKS, frontend_floors, geometry  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


def test_geometry_matches_pipeline_derivation():
    # 44.1 kHz must give the pipeline's prime 1103, not a naive round 1102
    assert geometry(44100, 25.0, 10.0) == (1103, 441, 552, 4410)
    assert geometry(16000, 25.0, 10.0) == (400, 160, 201, 1600)


def test_floors_sane():
    r = frontend_floors(16000, device_kind=H100)
    fl = r["floors"]
    assert set(fl) == {"conv", "frames", "windowed", "sliced", "factored"}
    for f in fl.values():
        assert f["floor_ms"] > 0
        assert f["floor_ms"] == max(f["flop_ms"], f["mem_ms"])
    # conv/frames/windowed do the same exact MACs (frames' blocks tile the
    # window); they differ only in the bytes they move
    assert fl["frames"]["flop_ms"] == fl["conv"]["flop_ms"]
    assert fl["windowed"]["flop_ms"] == fl["conv"]["flop_ms"]
    assert fl["frames"]["mem_ms"] > fl["conv"]["mem_ms"]
    assert fl["windowed"]["mem_ms"] > fl["conv"]["mem_ms"]
    # sliced contracts the full chunk p*step = 480 > 400
    assert fl["sliced"]["flop_ms"] > fl["conv"]["flop_ms"]
    assert fl["factored"]["flop_ms"] < fl["conv"]["flop_ms"]
    assert r["rtf_at_floor"]["conv"] > 0
    # 16 kHz dense MACs = nW * W * 2K at the FP32 datasheet rate
    nw = 512 * 300
    expect_ms = 1e3 * (nw * 400 * 402) / (PEAKS[H100]["f32_flops"] / 2)
    assert abs(fl["conv"]["flop_ms"] - round(expect_ms, 3)) < 1e-9
    # the reduced tiers divide by the TF32 rate instead
    fast = frontend_floors(16000, device_kind=H100, precision="default")
    ratio = PEAKS[H100]["tf32_flops"] / PEAKS[H100]["f32_flops"]
    assert fast["floors"]["conv"]["flop_ms"] == pytest.approx(
        fl["conv"]["flop_ms"] / ratio, abs=1e-3
    )
    # an unknown device kind raises: no rate is assumed
    with pytest.raises(KeyError):
        frontend_floors(16000, device_kind="Unknown Accelerator")


def test_prime_window_has_no_factored_row():
    r = frontend_floors(44100, device_kind=H100)
    assert r["win"] == 1103
    assert "factored" not in r["floors"]
