"""Utility coverage: profiling spans/timer, memory stats, compile cache."""

import os

import jax
import jax.numpy as jnp

from auditory_tpu.utils.cache import cache_dir, enable_compilation_cache
from auditory_tpu.utils.profiling import StepTimer, memory_stats, trace


def test_trace_and_timer():
    timer = StepTimer(sample_rate=16000)
    with trace("stage"):
        with timer.step(16000):
            jnp.ones(8).block_until_ready()
    rep = timer.report()
    assert rep["steps"] == 1
    assert rep["audio_seconds"] == 1.0
    assert timer.rtf > 0


def test_memory_stats_keys():
    stats = memory_stats()
    assert len(stats) == jax.device_count()


def test_compilation_cache(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the cache goes there and the
    code sets no directory of its own (JAX reads the variable itself)."""
    d = str(tmp_path / "xla")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    before = jax.config.jax_compilation_cache_dir
    assert cache_dir() == d
    assert enable_compilation_cache() == d
    assert os.path.isdir(d)
    assert jax.config.jax_compilation_cache_dir == before
    f = jax.jit(lambda x: x * 3 + 1)
    assert float(f(jnp.asarray(2.0))) == 7.0


def test_compilation_cache_default_in_checkout(monkeypatch):
    """Unset, the cache lands in a fixed, git-ignored directory of the
    checkout (never under $HOME)."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache_dir() == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compilation_cache() == cache_dir()
        assert jax.config.jax_compilation_cache_dir == cache_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_pad_signal_multidim_pads_last_axis():
    """[..., S] signals pad per row (a len()-based pad measured the channel
    axis and corrupted stereo/batched input)."""
    import numpy as np

    from auditory_tpu.config import WindowParams
    from auditory_tpu.dsp.frame import pad_len, pad_signal

    t = WindowParams().derive(16000)
    sig = np.ones((2, 5000), np.float32)
    out = pad_signal(sig, t)
    assert out.shape == (2, 5000 + pad_len(5000, t))
    assert np.all(out[:, 5000:] == 0) and np.all(out[:, :5000] == 1)
    one = pad_signal(np.ones(5000, np.float32), t)
    assert one.shape == (5000 + pad_len(5000, t),)


def test_window_starts_int32_guard():
    import pytest as _pytest

    from auditory_tpu.config import WindowParams
    from auditory_tpu.dsp.frame import window_starts

    t = WindowParams().derive(16000)
    with _pytest.raises(ValueError, match="int32"):
        window_starts(t, seg_cnt=2**31 // t.stride_samples + 2)
