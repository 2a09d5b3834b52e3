"""Corpus metadata layer: phone tables, .PHN.MS/.TXT loaders, CV loaders."""

import numpy as np
import pytest

from auditory_tpu.speech import Sequence, Unit, adjust_sequence_times
from auditory_tpu.speech import grafestes, synthcvs, timit

PHN_MS = """\
0 h#
112.4 sh
205 ix
260.06 hv
320 eh
395 dcl
410 d
520 h#
"""


def test_phone_tables():
    assert len(timit.PHONE_CATS_61) == 61
    assert len(timit.PHONE_CATS_41) == 41
    assert len(timit.PHONES_61) == 61
    # all 61 phones fold into the 41 table
    assert set(timit.PHONES_41.keys()) == set(timit.PHONE_CATS_61)
    # spot-checks against the reference map (timit.go:57-119)
    assert timit.PHONES_41["ax"] == timit.PHONES_41["ah"] == 5
    assert timit.PHONES_41["sh"] == timit.PHONES_41["zh"] == 33
    assert timit.PHONES_41["h#"] == timit.PHONES_41["pcl"] == 39
    assert timit.PHONES_41["q"] == 40
    assert timit.PHONES_61["q"] == 60
    assert timit.PHONES_10 == {
        "ah": 0, "ao": 1, "dh": 2, "er": 3, "ix": 4,
        "iy": 5, "l": 6, "n": 7, "r": 8, "s": 9,
    }


def test_idx_snd_roundtrip():
    for set_id, n in (("Phones10", 10), ("Phones61", 61)):
        for i in range(n):
            snd, ok = timit.snd_from_idx(i, set_id)
            assert ok
            j, ok = timit.idx_from_snd(snd, set_id)
            assert ok and j == i
    assert timit.idx_from_snd("zz", "Phones61") == (-1, False)
    assert timit.idx_from_snd("ah", "bogus") == (-1, False)


def test_load_times_no_fuse(tmp_path):
    p = tmp_path / "x.PHN.MS"
    p.write_text(PHN_MS)
    units = timit.load_times(str(p), fuse=False)
    names = [u.name for u in units]
    assert names == ["h#", "sh", "ix", "hv", "eh", "dcl", "d", "h#"]
    assert units[0].silence and units[-1].silence
    assert units[0].start == 0 and units[0].end == 112.4
    assert units[1].end == 205
    # tail h#: end = start + 1 (timit.go:305-307)
    assert units[-1].start == 520 and units[-1].end == 521


def test_load_times_fuse_closure(tmp_path):
    p = tmp_path / "x.PHN.MS"
    p.write_text(PHN_MS)
    units = timit.load_times(str(p), fuse=True)
    names = [u.name for u in units]
    # dcl+d fuse into one 'd' spanning the closure start
    assert names == ["h#", "sh", "ix", "hv", "eh", "d", "h#"]
    d = units[5]
    assert d.start == 395
    assert d.end == 520


def test_load_times_fuse_closure_not_followed_by_consonant(tmp_path):
    # closure followed by a different phone: the closure unit stays, the
    # following phone is processed normally
    p = tmp_path / "y.PHN.MS"
    p.write_text("0 h#\n100 bcl\n150 ix\n200 h#\n")
    units = timit.load_times(str(p), fuse=True)
    assert [u.name for u in units] == ["h#", "b", "ix", "h#"]


def test_load_text(tmp_path):
    p = tmp_path / "x.TXT"
    p.write_text("0 61748 She had your dark suit in greasy wash water.\n")
    assert timit.load_text(str(p)) == "She had your dark suit in greasy wash water."


def test_synthcvs_loaders(tmp_path):
    trans = tmp_path / "t.txt"
    trans.write_text("header junk\nda go pa\n")
    names = synthcvs.load_transcription(str(trans))
    assert names == ["da", "go", "pa"]

    times = tmp_path / "t.times"
    times.write_text("\\freq line skipped\n0.10 0.35\n0.35 0.61\n0.61 0.92\n1.0 2.0\n")
    units = synthcvs.load_times(str(times), names)
    assert len(units) == 3  # stops at len(names)
    assert units[0].start == pytest.approx(100.0)
    assert units[0].end == pytest.approx(350.0)
    assert units[2].name == "pa"

    assert synthcvs.idx_from_snd("da", "I") == (0, True)
    assert synthcvs.idx_from_snd("da", "III") == (-1, False)
    assert synthcvs.snd_from_idx(11, "VI") == ("la", True)
    assert synthcvs.idx_from_snd("da", "II") == (-1, False)


def test_grafestes_loaders(tmp_path):
    assert grafestes.idx_from_snd("may") == (4, True)
    assert grafestes.snd_from_idx(7) == ("ku", True)
    assert grafestes.snd_from_idx(8) == ("", False)
    times = tmp_path / "g.times"
    times.write_text("0.0 0.4\n0.4 0.8\n")
    units = grafestes.load_times(str(times), ["ti", "do"])
    assert [u.name for u in units] == ["ti", "do"]
    assert units[1].end == pytest.approx(800.0)


def test_adjust_sequence_times():
    seq = Sequence(silence=50.0)
    seq.units = [Unit(name="a", start=100.0, end=200.0), Unit(name="b", start=200.0, end=300.0)]
    adjust_sequence_times(seq)
    # offset = first unit start (100); silence 50 added
    assert seq.units[0].a_start == 50.0
    assert seq.units[0].a_end == 150.0
    assert seq.units[1].a_start == 150.0


def test_vowels_loaders(tmp_path):
    from auditory_tpu.speech import vowels

    # the 12 Hillenbrand categories (vowels.go:25)
    assert vowels.CATS == [
        "ae", "ah", "aw", "eh", "ei", "er",
        "ih", "iy", "oa", "oo", "uh", "uw",
    ]
    for i, cat in enumerate(vowels.CATS):
        assert vowels.idx_from_snd(cat) == (i, True)
        assert vowels.snd_from_idx(i) == (cat, True)
    assert vowels.idx_from_snd("zz") == (-1, False)
    assert vowels.snd_from_idx(12) == ("", False)
    assert vowels.snd_from_idx(-1) == ("", False)

    trans = tmp_path / "v.txt"
    trans.write_text("header\nae iy uw\n")
    names = vowels.load_transcription(str(trans))
    assert names == ["ae", "iy", "uw"]

    times = tmp_path / "v.times"
    # backslash-prefixed frequency lines are skipped (vowels.go:66-68);
    # blank line stops parsing; names-bound early return (vowels.go:84-86)
    times.write_text(
        "\\440 880\n0.10 0.35\n0.35 0.61\n\\100 200\n0.61 0.92\n1.0 2.0\n"
    )
    units = vowels.load_times(str(times), names)
    assert len(units) == 3
    assert [u.name for u in units] == ["ae", "iy", "uw"]
    assert units[0].start == pytest.approx(100.0)
    assert units[2].end == pytest.approx(920.0)

    blank = tmp_path / "b.times"
    blank.write_text("0.0 0.1\n\n0.2 0.3\n")
    units = vowels.load_times(str(blank), ["ae", "ah"])
    assert len(units) == 1  # blank line breaks (vowels.go:63-65)


def test_vowels_table_dispatch(tmp_path):
    from auditory_tpu.speech import table

    assert table.idx_from_snd("VOWELS", "er") == (5, True)
    trans = tmp_path / "v.txt"
    trans.write_text("ae iy\n")
    times = tmp_path / "v.times"
    times.write_text("0.0 0.3\n0.3 0.6\n")
    wav = tmp_path / "v.wav"
    seq = table.load_cv_sequence(str(wav), corpus="VOWELS")
    assert [u.name for u in seq.units] == ["ae", "iy"]
    assert seq.units[1].a_end == pytest.approx(600.0)


def test_snd_from_idx_folded_member_pinned():
    """Pin snd_from_idx's documented order behavior for folded indices:
    the *last table-order member* is returned.
    Any member is semantically valid (the Go reference's map iteration is
    nondeterministic), but our implementation is deterministic -- assert it
    so a silent change in the contract is caught."""
    # fold index 33 = sh/zh; insertion order in PHONES_41 puts zh after sh
    snd, ok = timit.snd_from_idx(33, "Phones41")
    assert ok
    members = [k for k, v in timit.PHONES_41.items() if v == 33]
    assert snd == members[-1]
    # and the returned member round-trips to the same folded index
    idx, ok = timit.idx_from_snd(snd, "Phones41")
    assert ok and idx == 33
    # unfolded sets are exact inverses
    for i in range(61):
        s, ok = timit.snd_from_idx(i, "Phones61")
        assert ok and timit.idx_from_snd(s, "Phones61") == (i, True)


def test_crlf_files_parse_like_lf(tmp_path):
    """Go's bufio.ScanLines strips '\r': CRLF corpora must parse exactly
    like LF ones (a CRLF blank line must hit the blank-line stop, not crash
    timit or silently shift CV unit names)."""
    from auditory_tpu.speech import synthcvs, timit

    phn_lf = "0 h#\n120 sh\n300 iy\n480 h#\n"
    p1 = tmp_path / "a.PHN.MS"
    p2 = tmp_path / "b.PHN.MS"
    p1.write_text(phn_lf)
    p2.write_text(phn_lf.replace("\n", "\r\n"))
    u_lf = timit.load_times(str(p1))
    u_crlf = timit.load_times(str(p2))
    assert [(u.name, u.start, u.end) for u in u_lf] == [
        (u.name, u.start, u.end) for u in u_crlf
    ]

    times = "0.0 0.25\n0.25 0.5\n\n"
    t1 = tmp_path / "a.times"
    t2 = tmp_path / "b.times"
    t1.write_text(times)
    t2.write_text(times.replace("\n", "\r\n"))
    names = ["da", "go"]
    a = synthcvs.load_times(str(t1), names)
    b = synthcvs.load_times(str(t2), names)
    assert [(u.name, u.start, u.end) for u in a] == [
        (u.name, u.start, u.end) for u in b
    ]
    assert [u.name for u in b] == names  # no spurious shifted unit


def test_vowels_delegates_to_synthcvs():
    """vowels shares synthcvs's parser (one implementation, like
    grafestes) -- a CRLF-style fix lands in all three corpora at once."""
    from auditory_tpu.speech import grafestes, synthcvs, vowels

    assert vowels._load_times is synthcvs.load_times
    assert vowels._load_transcription is synthcvs.load_transcription
    assert grafestes._load_times is synthcvs.load_times


def test_scan_lines_go_scanner_semantics():
    """bufio.ScanLines parity: a file ENDING with a newline yields no final
    empty token; interior blank lines and CRLF are preserved/normalized.
    The loaders' last-scanned-line and blank-line-break quirks depend on
    this exactly (review finding: the old split added a spurious '')."""
    from auditory_tpu.speech import scan_lines

    assert scan_lines("a b\n") == ["a b"]
    assert scan_lines("a b") == ["a b"]
    assert scan_lines("a b\n\n") == ["a b", ""]
    assert scan_lines("a\r\nb\r\n") == ["a", "b"]
    assert scan_lines("") == []  # Go Scan() yields zero tokens on empty input


def test_load_transcription_keeps_literal_last_line(tmp_path):
    """synthcvs.go:36-53 keeps the literal LAST SCANNED line -- a file whose
    last line is blank yields [''] (quirk), one ending at the names line
    yields the names."""
    from auditory_tpu.speech import synthcvs

    p1 = tmp_path / "t1.txt"
    p1.write_text("da go pa\n")
    assert synthcvs.load_transcription(str(p1)) == ["da", "go", "pa"]
    p2 = tmp_path / "t2.txt"
    p2.write_text("da go pa\n\n")
    assert synthcvs.load_transcription(str(p2)) == [""]


def test_load_times_short_line_raises(tmp_path):
    """A malformed times line (fewer than two fields) must fail loudly (the
    reference panics, synthcvs.go:81-88) instead of silently consuming a
    name and misaligning every later unit."""
    import pytest

    from auditory_tpu.speech import synthcvs

    p = tmp_path / "t.times"
    p.write_text("0.0 0.5\n \n0.5 1.0\n")
    with pytest.raises(ValueError, match="malformed"):
        synthcvs.load_times(str(p), ["da", "go"])
