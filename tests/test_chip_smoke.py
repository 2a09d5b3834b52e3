"""chip_smoke.py on the CPU: its device gate, output format and bound
checks, and every phase rehearsed at tiny sizes with the CPU standing in
for the card (the numbers it grades are only meaningful on a GPU)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABEL = "cpu rehearsal"


def test_gate_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok": true' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Copied into a directory without the package, the script exits
    non-zero and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    devs = jax.devices("cpu")[:count]
    line = chip_smoke.result_line(devs)
    assert "\n" not in line
    obj = json.loads(line)
    assert obj == {
        "ok": True,
        "device": {"platform": "cpu", "kind": devs[0].device_kind,
                   "count": count},
    }


@pytest.mark.parametrize(
    "got,ref,bound,rel,passes",
    [
        # relative to peak: 1e-3 off a peak of 10 is 1e-4
        ([10.0, 1.0], [10.0, 1.001], 2e-4, True, True),
        ([10.0, 1.0], [10.0, 1.001], 5e-5, True, False),
        # absolute
        ([0.5, -2.0], [0.5, -2.0002], 3e-4, False, True),
        ([0.5, -2.0], [0.5, -2.001], 3e-4, False, False),
        # the mel NaN quirk: matching NaNs are skipped, mismatches fail
        ([np.nan, 1.0], [np.nan, 1.0], 1e-9, False, True),
        ([np.nan, 1.0], [0.0, 1.0], 1e9, False, False),
        # a non-finite value where the reference is finite never passes
        ([np.inf, 1.0], [1.0, 1.0], 1e9, False, False),
    ],
)
def test_check_bounds(got, ref, bound, rel, passes):
    if passes:
        chip_smoke.check("t", np.array(got), np.array(ref), bound, rel)
    else:
        with pytest.raises(chip_smoke.CheckFailed):
            chip_smoke.check("t", np.array(got), np.array(ref), bound, rel)


def test_check_close_allowance():
    ref = np.array([1000.0, 1e-3])
    chip_smoke.check_close("t", ref + [5e-3, 1e-6], ref, 1e-5, 1e-5)
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke.check_close("t", ref + [2e-2, 0.0], ref, 1e-5, 1e-5)


class FakeGpu:
    platform = "gpu"
    device_kind = "test"


@pytest.mark.parametrize("four", [False, True])
def test_four_selects_only_its_phase(four, monkeypatch, capsys):
    """main() runs the six one-card phases by default and only the 4-card
    phase with --four; the last line then counts 4 cards."""
    import auditory_tpu.utils.cache

    ran = []
    monkeypatch.setattr(chip_smoke, "require_gpu",
                        lambda min_count=1: [FakeGpu()] * 4)
    monkeypatch.setattr(chip_smoke, "card_label", lambda: LABEL)
    monkeypatch.setattr(auditory_tpu.utils.cache,
                        "enable_compilation_cache", lambda: "")
    for name in ("batch", "tiers", "frontends", "corpus", "serving", "f64",
                 "four"):
        def fake(*a, _name=name, **k):
            ran.append(_name)
            return (None, None, None) if _name == "batch" else None

        monkeypatch.setattr(chip_smoke, f"phase_{name}", fake)
    assert chip_smoke.main(["--four"] if four else []) == 0
    if four:
        assert ran == ["four"]
    else:
        assert ran == ["batch", "tiers", "frontends", "corpus", "serving",
                       "f64"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"]["count"] == (4 if four else 1)


def test_four_refuses_fewer_cards(monkeypatch):
    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        chip_smoke.require_gpu(4)
    assert chip_smoke.require_gpu(1)[0].platform == "gpu"


# ------------------------------------------------- phases at tiny sizes

CPU = jax.devices("cpu")[0]


def test_phase_batch_and_tiers():
    sigs, lens, ref = chip_smoke.phase_batch(CPU, CPU, LABEL, batch=3,
                                             seconds=0.4, rows=2)
    assert sigs.shape[0] == 2 and ref["gabor_kwta"].shape[0] == 2
    grades = chip_smoke.phase_tiers(CPU, LABEL, sigs, lens, ref)
    # precision tiers are a numeric no-op on the CPU backend
    assert all(d == 0.0 for g in grades.values() for d in g.values())


def test_phase_frontends():
    t = chip_smoke.phase_frontends(CPU, CPU, LABEL, batch=2, seconds=0.3,
                                   rows=2, repeats=1)
    assert sorted(t) == sorted(
        (geo, name) for geo in ("400/160", "1103/441")
        for name in ("conv", "frames", "windowed")
    )


def test_phase_corpus():
    decoder = chip_smoke.phase_corpus(CPU, LABEL, files=4,
                                      build_native=False)
    assert decoder in ("native int16", "native float", "python")


def test_phase_serving():
    worst = chip_smoke.phase_serving(CPU, LABEL, streams=2, seconds=0.5)
    assert set(worst) == {"mel_fbank_segment", "gabor_kwta"}


def test_phase_f64():
    worst = chip_smoke.phase_f64(LABEL, seconds=0.4)
    assert worst["mel_fbank_segment"] <= chip_smoke.F64_BOUND


def test_phase_four_on_virtual_devices():
    devs = jax.devices("cpu")
    assert len(devs) >= 4
    chip_smoke.phase_four(devs, LABEL, batch=8, seconds=0.4,
                          long_seconds=0.8)
