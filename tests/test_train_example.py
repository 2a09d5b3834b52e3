"""End-to-end features->classifier integration (the A1 input-layer role)."""

import subprocess
import sys


def test_phone_classifier_learns():
    out = subprocess.run(
        [sys.executable, "examples/train_phone_classifier.py", "--cpu",
         "--steps", "80", "--n-per-class", "12"],
        capture_output=True, text=True, timeout=300, cwd=".",
    )
    assert out.returncode == 0, out.stderr[-2000:]
    last = [l for l in out.stdout.splitlines() if l.startswith("final test")]
    assert last, out.stdout
    acc = float(last[0].split()[-3])
    assert acc > 0.5, f"classifier failed to learn: {last[0]}"


def test_gabor_view_example(tmp_path):
    """The headless gaborview example end to end over wav+PHN.MS fixtures."""
    import numpy as np

    from auditory_tpu.io.wav import float_to_wave, write_wav
    from tests.conftest import tone

    for i in range(2):
        sig = tone(600 + 300 * i, 0.6, 16000)
        write_wav(str(tmp_path / f"g{i}.wav"), float_to_wave(sig, 16000))
        (tmp_path / f"g{i}.PHN.MS").write_text("0 h#\n120 sh\n300 iy\n480 h#\n")
    out = subprocess.run(
        [sys.executable, "examples/gabor_view.py", str(tmp_path), "sh"],
        capture_output=True, text=True, timeout=300, cwd=".",
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode == 0, out.stderr[-1500:]
    assert "[sh]" in out.stdout


def test_learnable_frontend_learns():
    """Backprop into the gabor filter bank: loss must drop and the filters
    must move away from the hand-designed prior."""
    out = subprocess.run(
        [sys.executable, "examples/learnable_frontend.py", "--cpu",
         "--steps", "60", "--n-per-class", "10"],
        capture_output=True, text=True, timeout=300, cwd=".",
    )
    assert out.returncode == 0, out.stderr[-2000:]
    loss_line = [l for l in out.stdout.splitlines() if l.startswith("loss:")]
    assert loss_line, out.stdout
    first, last = (float(x) for x in
                   loss_line[0].split(":")[1].split("->"))
    assert last < 0.7 * first, f"frontend failed to train: {loss_line[0]}"
    drift_line = [l for l in out.stdout.splitlines()
                  if l.startswith("filter drift")]
    assert drift_line and float(drift_line[0].split()[-3]) > 0.01


def test_serve_streams_example():
    out = subprocess.run(
        [sys.executable, "examples/serve_streams.py", "--cpu",
         "--streams", "4", "--seconds", "1.2", "--f16"],
        capture_output=True, text=True, timeout=300, cwd=".",
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "SERVE_OK" in out.stdout


def test_phone_classifier_device_features():
    """The device-resident corpus->train route (iter_device_features): no
    npz round trip, same learnability."""
    out = subprocess.run(
        [sys.executable, "examples/train_phone_classifier.py", "--cpu",
         "--steps", "80", "--n-per-class", "12", "--features", "device"],
        capture_output=True, text=True, timeout=300, cwd=".",
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[device] corpus->features" in out.stdout
    last = [l for l in out.stdout.splitlines() if l.startswith("final test")]
    acc = float(last[0].split()[-3])
    assert acc > 0.5, f"classifier failed to learn: {last[0]}"


def test_learnable_frontend_resume(tmp_path):
    """Orbax checkpoint/resume: 30 steps + resume-to-60 must reproduce an
    uninterrupted 60-step run exactly (restored params/opt_state are
    bit-identical and the data pipeline is seeded)."""
    def run(extra):
        out = subprocess.run(
            [sys.executable, "examples/learnable_frontend.py", "--cpu",
             "--steps", "60", "--n-per-class", "10"] + extra,
            capture_output=True, text=True, timeout=300, cwd=".",
        )
        assert out.returncode == 0, out.stderr[-2000:]
        return out.stdout

    straight = run([])
    ck = str(tmp_path / "ck")
    run(["--ckpt-dir", ck, "--ckpt-every", "30", "--steps", "30"])
    resumed = run(["--ckpt-dir", ck])
    assert "resumed from step_30" in resumed

    def final(stdout, prefix):
        return [l for l in stdout.splitlines() if l.startswith(prefix)][-1]

    # identical final loss (printed to 4 decimals) and test accuracy
    assert (final(straight, "loss:").split("->")[1]
            == final(resumed, "loss:").split("->")[1])
    assert final(straight, "final test") == final(resumed, "final test")
