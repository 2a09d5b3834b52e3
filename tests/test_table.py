"""Sounds-table workflow (gaborview LoadTranscription path)."""

import json
import os

import pytest

from auditory_tpu.io.wav import float_to_wave, write_wav
from auditory_tpu.speech.table import SoundsTable, idx_from_snd, load_timit_sequence
from tests.conftest import tone


def make_pair(tmp_path, name="u0"):
    wav = str(tmp_path / f"{name}.wav")
    write_wav(wav, float_to_wave(tone(800, 0.6, 16000), 16000))
    phn = str(tmp_path / f"{name}.PHN.MS")
    open(phn, "w").write("0 h#\n100 sh\n250 iy\n400 h#\n")
    txt = str(tmp_path / f"{name}.TXT")
    open(txt, "w").write("0 9600 she\n")
    return wav


def test_load_timit_sequence(tmp_path):
    wav = make_pair(tmp_path)
    seq = load_timit_sequence(wav)
    assert [u.name for u in seq.units] == ["h#", "sh", "iy", "h#"]
    assert seq.text == "she"
    assert seq.units[1].a_start == 100.0  # no offset/silence


def test_load_timit_sequence_missing_timing(tmp_path):
    wav = str(tmp_path / "x.wav")
    write_wav(wav, float_to_wave(tone(500, 0.1, 16000), 16000))
    seq = load_timit_sequence(wav)
    assert len(seq.units) == 1 and seq.units[0].name == "unknown"


def test_sounds_table_filter(tmp_path):
    t = SoundsTable()
    t.add_sequence(load_timit_sequence(make_pair(tmp_path, "a")))
    t.add_sequence(load_timit_sequence(make_pair(tmp_path, "b")))
    assert len(t) == 8
    sh = t.filter_sound("sh")
    assert len(sh) == 2
    assert sh[0].duration == 150.0
    assert sh[0].file == "a" and sh[1].file == "b"


def test_idx_from_snd_dispatch():
    assert idx_from_snd("TIMIT", "sh") == (33, True)
    assert idx_from_snd("SYNTHCVS", "da", "I") == (0, True)
    assert idx_from_snd("GRAFESTES", "ku") == (7, True)
    assert idx_from_snd("NOPE", "x") == (-1, False)


def test_load_cv_sequence(tmp_path):
    from auditory_tpu.speech.table import load_cv_sequence

    wav = str(tmp_path / "cv.wav")
    write_wav(wav, float_to_wave(tone(600, 0.5, 16000), 16000))
    (tmp_path / "cv.txt").write_text("header\nda go pa\n")
    (tmp_path / "cv.times").write_text("0.0 0.15\n0.15 0.31\n0.31 0.5\n")
    seq = load_cv_sequence(wav, "SYNTHCVS", "I")
    assert [u.name for u in seq.units] == ["da", "go", "pa"]
    assert seq.units[1].a_start == 150.0
    # missing timing -> unknown fallback
    wav2 = str(tmp_path / "cv2.wav")
    write_wav(wav2, float_to_wave(tone(600, 0.1, 16000), 16000))
    seq2 = load_cv_sequence(wav2, "GRAFESTES")
    assert seq2.units[0].name == "unknown"


def test_cli_table(tmp_path, capsys):
    """cli table: the gaborview corpus-browse surface, headless."""
    from auditory_tpu.cli import main
    from auditory_tpu.io.wav import float_to_wave, write_wav
    from tests.conftest import tone

    sr = 16000
    for name, phn in (("a", "0 h#\n80 sh\n200 iy\n310 h#\n"),
                      ("b", "0 h#\n60 ae\n180 sh\n260 h#\n")):
        write_wav(str(tmp_path / f"{name}.wav"),
                  float_to_wave(tone(500.0, 0.35, sr), sr))
        (tmp_path / f"{name}.PHN.MS").write_text(phn)
        (tmp_path / f"{name}.TXT").write_text(f"0 5600 utterance {name}\n")

    rc = main(["table", "--glob", str(tmp_path / "*.wav")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "sh" in out and "units from 2 files" in out

    rc = main(["table", "--glob", str(tmp_path / "*.wav"),
               "--filter", "sh", "--json"])
    assert rc == 0
    rows = json.loads(capsys.readouterr().out)
    assert len(rows) == 2
    assert all(r["sound"] == "sh" for r in rows)

    # no matches -> rc 1
    assert main(["table", "--glob", str(tmp_path / "none*.wav")]) == 1


def test_cli_process_silence_adjust(tmp_path):
    """process --silence-add/--silence-existing drives AdjustForSilence."""
    import numpy as np

    from auditory_tpu.cli import main
    from auditory_tpu.io.wav import float_to_wave, write_wav
    from tests.conftest import tone

    sr = 16000
    p = str(tmp_path / "t.wav")
    write_wav(p, float_to_wave(tone(700.0, 0.2, sr), sr))
    o1, o2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert main(["process", p, "--out", o1, "--no-kwta"]) == 0
    assert main(["process", p, "--out", o2, "--no-kwta",
                 "--silence-add", "100"]) == 0
    a = np.load(o1)["power_segment"]
    b = np.load(o2)["power_segment"]
    # 100 ms of added leading silence = one extra (mostly silent) segment
    assert b.shape[0] == a.shape[0] + 1
    assert float(np.abs(b[0]).max()) < float(np.abs(a[0]).max())


def test_cli_process_frontend_flag(tmp_path):
    """process --frontend selects the spectrum frontend explicitly; all
    frontends compute the identical DFT (f32-tight), and geometries with
    no factored split are refused with a clean error (rc 2)."""
    import numpy as np

    from auditory_tpu.cli import main
    from auditory_tpu.io.wav import float_to_wave, write_wav
    from tests.conftest import tone

    sr = 16000
    p = str(tmp_path / "t.wav")
    write_wav(p, float_to_wave(tone(900.0, 0.3, sr), sr))
    outs = {}
    for fe in ("conv", "frames", "factored"):
        o = str(tmp_path / f"{fe}.npz")
        assert main(["process", p, "--out", o, "--no-kwta",
                     "--frontend", fe]) == 0
        outs[fe] = np.load(o)["power_segment"]
    scale = float(np.abs(outs["conv"]).max())
    for fe in ("frames", "factored"):
        np.testing.assert_allclose(
            outs[fe] / scale, outs["conv"] / scale, atol=1e-5
        )
    # 25.0625 ms at 16 kHz -> win 401 (prime): factored refused cleanly
    assert main(["process", p, "--out", str(tmp_path / "x.npz"),
                 "--no-kwta", "--frontend", "factored",
                 "--win-ms", "25.0625"]) == 2


def test_missing_timing_fallback_gets_silence_offset(tmp_path):
    """gbv.go:658-676: the 'unknown' unit from missing timing data still
    goes through AdjSeqTimes, so a_start/a_end carry the silence offset."""
    import numpy as np

    from auditory_tpu.io.wav import float_to_wave, write_wav
    from auditory_tpu.speech.table import load_timit_sequence
    from tests.conftest import tone

    wav = str(tmp_path / "x.wav")
    write_wav(wav, float_to_wave(tone(500.0, 0.2, 16000), 16000))
    seq = load_timit_sequence(wav, silence=100.0)
    assert [u.name for u in seq.units] == ["unknown"]
    assert seq.units[0].a_start == 100.0


@pytest.mark.parametrize("flags", [["--frontend", "fft"], ["--f64"]],
                         ids=["fft", "f64"])
def test_cli_process_keeps_platform(tmp_path, flags):
    """`--frontend fft` and `--f64` run on the device JAX picks: with an
    accelerator platform configured, neither is refused nor forced onto
    the CPU (both run there only because this process's backend is)."""
    import jax
    import numpy as np

    from auditory_tpu.cli import main
    from auditory_tpu.io.wav import float_to_wave, write_wav
    from tests.conftest import tone

    sr = 16000
    p = str(tmp_path / "t.wav")
    write_wav(p, float_to_wave(tone(700.0, 0.2, sr), sr))
    ref, out = str(tmp_path / "ref.npz"), str(tmp_path / "out.npz")
    assert main(["process", p, "--out", ref, "--no-kwta"]) == 0
    jax.devices()  # the backend is up before the platform list changes
    before = jax.config.jax_platforms
    jax.config.update("jax_platforms", "cuda,cpu")
    try:
        assert main(["process", p, "--out", out, "--no-kwta", *flags]) == 0
        assert jax.config.jax_platforms == "cuda,cpu"
    finally:
        jax.config.update("jax_platforms", before)
    a, b = np.load(ref)["power_segment"], np.load(out)["power_segment"]
    assert b.dtype == (np.float64 if "--f64" in flags else np.float32)
    scale = float(np.abs(a).max())
    np.testing.assert_allclose(b / scale, a / scale, atol=1e-5)


def test_cli_process_precision_tier(tmp_path):
    """`process --precision high` plumbs the matmul tier into SndEnv; on the
    CPU backend every tier lowers identically, so outputs must match the
    default exactly (the knob's GPU grades are printed by chip_smoke.py
    phase 2)."""
    import numpy as np

    from auditory_tpu.cli import main
    from auditory_tpu.io.wav import float_to_wave, write_wav
    from tests.conftest import tone

    sr = 16000
    p = str(tmp_path / "t.wav")
    write_wav(p, float_to_wave(tone(700.0, 0.2, sr), sr))
    o1, o2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert main(["process", p, "--out", o1, "--no-kwta"]) == 0
    assert main(["process", p, "--out", o2, "--no-kwta",
                 "--precision", "high"]) == 0
    np.testing.assert_array_equal(
        np.load(o1)["mel_fbank_segment"], np.load(o2)["mel_fbank_segment"]
    )


def test_cli_process_window_fn_flag(tmp_path):
    """`process --window-fn hamming` reaches the spectrum: the windowed run
    must match SndEnv(window_fn='hamming') exactly and differ from the
    rectangular default (the reference applies NO analysis window,
    dft/dft.go:42-59 -- the flag is the SURVEY's opt-in extension)."""
    import dataclasses as dc

    import numpy as np

    from auditory_tpu.cli import main
    from auditory_tpu.config import DFTParams
    from auditory_tpu.io.wav import float_to_wave, write_wav
    from auditory_tpu.pipeline.sndenv import SndEnv
    from tests.conftest import default_cfg_2d, tone

    sr = 16000
    p = str(tmp_path / "t.wav")
    sig = tone(700.0, 0.2, sr)
    write_wav(p, float_to_wave(sig, sr))
    o1, o2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    assert main(["process", p, "--out", o1, "--no-kwta"]) == 0
    assert main(["process", p, "--out", o2, "--no-kwta",
                 "--window-fn", "hamming"]) == 0
    rect = np.load(o1)["power_segment"]
    ham = np.load(o2)["power_segment"]
    assert not np.allclose(rect, ham)

    from auditory_tpu.io.wav import load_wav

    base = default_cfg_2d()
    cfg = dc.replace(
        base,
        dft=DFTParams(window_fn="hamming"),
        kwta=dc.replace(base.kwta, on=False),
    )
    env = SndEnv(cfg, sr)
    ref = np.asarray(
        env.process(env.pad(load_wav(p).sound_to_tensor())).power_segment
    )
    np.testing.assert_array_equal(ham, ref)
