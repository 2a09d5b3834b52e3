"""Test environment: CPU backend with 8 virtual devices (for sharding tests)
and x64 enabled (the parity oracle is float64, like the Go reference)."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# tests run on the virtual 8-device CPU backend, even on a GPU host
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from auditory_tpu.config import (
    GaborSet,
    SndEnvConfig,
    default_gabor_specs,
)


def tone(
    freq_hz: float, dur_s: float, sr: int, amp: float = 0.5, dither: float = 1e-4
) -> np.ndarray:
    """Sine test signal with a small deterministic dither.

    The dither lifts the spectrum off the FFT numerical noise floor: with the
    reference's mel LogOff=0, log-mel of a *pure* tone reads the ~1e-24 FFT
    rounding noise in the stop bins, which differs across FFT implementations
    (gonum vs pocketfft vs ducc) and is not meaningful for parity."""
    r = np.random.default_rng(int(freq_hz) * 7919 + sr)
    t = np.arange(int(dur_s * sr), dtype=np.float64) / sr
    sig = amp * np.sin(2 * np.pi * freq_hz * t)
    if dither:
        sig = sig + dither * r.standard_normal(len(t))
    return sig


def default_cfg_2d(**kw) -> SndEnvConfig:
    """SndEnv defaults with the processspeech-style gabor bank, 2-D output."""
    gset = GaborSet(
        size_x=9,
        size_y=9,
        stride_x=3,
        stride_y=3,
        gain=2.0,
        distribute=False,
        specs=default_gabor_specs(phases=(0.0, 1.5708)),
    )
    return SndEnvConfig(gabor=gset, **kw)


@pytest.fixture(scope="session")
def ref_wavs():
    """Paths of the reference example WAVs (read-only mount), if present."""
    base = "/root/reference/examples/processspeech/sounds"
    if not os.path.isdir(base):
        pytest.skip("reference WAV assets not available")
    return {
        f[:-4]: os.path.join(base, f)
        for f in sorted(os.listdir(base))
        if f.endswith(".wav")
    }
