"""Headless equivalent of the reference examples/gaborview app: build a
sounds table from WAV + .PHN.MS pairs, pick a phone row, process its time
slice through the gaborview pipeline (resize + byTime + KWTALayer), print
the results (the reference renders A/B tensor grids in a GUI).

Usage: python examples/gabor_view.py <dir-with-wav-and-PHN.MS> [phone]
"""

import glob
import os
import sys

import numpy as np

sys.path.insert(0, ".")

from auditory_tpu.config import GaborSet, default_gabor_specs
from auditory_tpu.io.wav import load_wav
from auditory_tpu.pipeline.segments import SegmentPipeline, SegmentWindowParams
from auditory_tpu.speech.table import SoundsTable, load_timit_sequence


def main() -> None:
    argv = [a for a in sys.argv[1:] if a != "--cpu"]
    if "--cpu" in sys.argv[1:]:
        import jax

        jax.config.update("jax_platforms", "cpu")
    from auditory_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()  # repeat runs skip recompilation
    root = argv[0] if len(argv) > 0 else "."
    want = argv[1] if len(argv) > 1 else None

    table = SoundsTable()
    for wav in sorted(glob.glob(os.path.join(root, "**/*.wav"), recursive=True)):
        table.add_sequence(load_timit_sequence(wav))
    if not table.rows:
        print(f"no wav/.PHN.MS pairs under {root}")
        return
    rows = table.filter_sound(want) if want else table.rows
    n_show = min(len(rows), 8)
    print(f"{len(table)} units loaded; processing {n_show} of "
          f"{len(rows)} matching rows")

    # gbv.go:318-357 InitGabors: 8x8, stride (6,3), gain 1.5, phase 0
    gset = GaborSet(
        size_x=8, size_y=8, stride_x=6, stride_y=3, gain=1.5,
        specs=default_gabor_specs(phases=(0.0,)),
    )
    pipes = {}
    for r in rows[:n_show]:
        w = load_wav(r.wav_path)
        if w.sample_rate not in pipes:  # setdefault would rebuild eagerly
            pipes[w.sample_rate] = SegmentPipeline(
                w.sample_rate, SegmentWindowParams(), gabor=gset
            )
        pipe = pipes[w.sample_rate]
        out = pipe.process(w.sound_to_tensor(), r.start, r.end)
        kw = np.asarray(out["gabor_kwta"])
        print(
            f"{r.file} [{r.sound}] {r.start:.0f}-{r.end:.0f} ms -> "
            f"gabor {kw.shape}, active {(kw > 0.1).mean():.3f}"
        )

    if not rows:
        print(f"no rows match sound {want!r}")
        return
    # the reference app's core capability: two parameter stacks over the
    # same phone, side by side (gbv.go:243-258 WParams/PParams/GParams 1&2)
    from auditory_tpu.pipeline.segments import compare_segments

    r = rows[0]
    w = load_wav(r.wav_path)
    gset_b = GaborSet(
        size_x=8, size_y=8, stride_x=3, stride_y=3, gain=2.0,
        specs=default_gabor_specs(phases=(0.0, 1.5708)),
    )
    pipe_a = pipes[w.sample_rate]
    pipe_b = SegmentPipeline(
        w.sample_rate, SegmentWindowParams(), gabor=gset_b
    )
    res = compare_segments(
        pipe_a, pipe_b, w.sound_to_tensor(), r.start, r.end
    )
    print(f"\nA/B compare on [{r.sound}] {r.start:.0f}-{r.end:.0f} ms:")
    for key in ("mel_fbank_segment", "gabor_kwta"):
        d = res["diff"][key]
        print(
            f"  {key}: A {d['a']['shape']} active {d['a']['active_frac']:.3f}"
            f" | B {d['b']['shape']} active {d['b']['active_frac']:.3f}"
        )


if __name__ == "__main__":
    main()
