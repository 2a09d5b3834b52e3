"""End-to-end demo: auditory features -> neural network, the role the
reference plays in the emergent ecosystem (an A1-cortex-like input layer).

Synthesizes CV-like tokens (distinct formant pairs per class), extracts
gabor-kwta features with the batched SndEnv pipeline, and trains a small MLP
classifier on them with optax -- everything jitted, shardable over the mesh.

Usage: python examples/train_phone_classifier.py [--steps 200]
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")


def synth_token(cls: int, rng: np.random.Generator, sr: int = 16000,
                dur: float = 0.15) -> np.ndarray:
    """A CV-ish token: two formant tones + onset transient + noise."""
    formants = [
        (300, 2300), (600, 1200), (800, 1800),
        (400, 900), (350, 1700), (700, 2500),
    ]
    f1, f2 = formants[cls % len(formants)]
    n = int(dur * sr)
    t = np.arange(n) / sr
    jit1 = rng.uniform(0.95, 1.05)
    jit2 = rng.uniform(0.95, 1.05)
    env = np.minimum(t / 0.02, 1.0) * np.exp(-t * 3.0)
    sig = env * (
        0.5 * np.sin(2 * np.pi * f1 * jit1 * t)
        + 0.35 * np.sin(2 * np.pi * f2 * jit2 * t)
    )
    sig += 0.01 * rng.standard_normal(n)
    return sig.astype(np.float32)


def assemble_batch(sigs, timing):
    """Pack variable-length signals into one zero-padded [N, n_pad] batch
    (bucketed length) + true lengths; shared by the training examples."""
    from auditory_tpu.pipeline.batch import bucket_length

    n_pad = bucket_length(max(len(s) for s in sigs), timing)
    batch = np.zeros((len(sigs), n_pad), np.float32)
    for i, s in enumerate(sigs):
        batch[i, : len(s)] = s
    lengths = np.array([len(s) for s in sigs], np.int32)
    return batch, lengths


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--n-per-class", type=int, default=40)
    ap.add_argument("--classes", type=int, default=6)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument(
        "--features", choices=("inline", "device", "npz"), default="inline",
        help="feature route: 'inline' = synthesize in-process and run the "
        "batched pipeline; 'device' = write a wav corpus and stream it "
        "through CorpusRunner.iter_device_features (features never leave "
        "the device -- no npz/host round trip); 'npz' = CorpusRunner.run + "
        "FeatureDataset (the materialized route, pays the host round trip)",
    )
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    from auditory_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()  # repeat runs skip the minutes-long compile

    from auditory_tpu.config import GaborSet, SndEnvConfig, default_gabor_specs
    from auditory_tpu.pipeline.batch import BatchedSndEnv, bucket_length
    from auditory_tpu.pipeline.sndenv import SndEnv

    sr = 16000
    rng = np.random.default_rng(0)

    # ---- data: synthetic CV tokens -> pipeline features -----------------
    cfg = SndEnvConfig(
        gabor=GaborSet(
            size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
            specs=default_gabor_specs(phases=(0.0, 1.5708)),
        )
    )
    env = SndEnv(cfg, sr, outputs=("gabor_kwta", "step_valid"))

    n_total = args.classes * args.n_per_class
    labels = np.repeat(np.arange(args.classes), args.n_per_class)
    sigs = [env.pad(synth_token(c, rng, sr)) for c in labels]

    if args.features == "inline":
        benv = BatchedSndEnv(env)
        batch, lengths = assemble_batch(sigs, env.timing)
        out, _ = benv.process(batch, lengths)
        feats = jnp.reshape(out.gabor_kwta, (n_total, -1))  # stays on device
    else:
        # a real on-disk wav corpus; class rides in the file stem
        import tempfile
        import time

        from auditory_tpu.io.wav import float_to_wave, write_wav
        from auditory_tpu.pipeline.batch import CorpusRunner

        tmp = tempfile.TemporaryDirectory()
        paths = []
        for i, (c, s) in enumerate(zip(labels, sigs)):
            p = f"{tmp.name}/tok_c{c}_{i:04d}.wav"
            write_wav(p, float_to_wave(s, sr))
            paths.append(p)
        # ONE parser for the tok_c<class>_<idx>.wav stem scheme, shared by
        # the device route (full paths) and FeatureDataset (bare stems)
        cls_of = lambda name: int(name.rsplit("_c", 1)[1].split("_")[0])
        runner = CorpusRunner(
            cfg, sr, batch_size=64, save_keys=("gabor_kwta",),
            feature_stats=False,
        )
        t0 = time.perf_counter()
        if args.features == "device":
            # corpus -> HBM -> training, zero device->host feature copies
            rows, lab_rows = [], []
            for bpaths, out, _valid, n_segs in runner.iter_device_features(
                paths
            ):
                # trim the bucket's padded segment axis to the files' true
                # segment count (uniform here: one duration, one bucket) so
                # the feature width matches the npz route's trimmed arrays
                assert len(set(n_segs)) == 1
                g = out.gabor_kwta[:, : n_segs[0]]
                rows.append(jnp.reshape(g, (len(bpaths), -1)))
                lab_rows.extend(cls_of(p) for p in bpaths)
            feats = jnp.concatenate(rows)
            labels = np.asarray(lab_rows)
            jax.block_until_ready(feats)
        else:  # npz: materialize, then read back through FeatureDataset
            from auditory_tpu.pipeline.dataset import FeatureDataset

            out_dir = f"{tmp.name}/out"
            runner.run(paths, out_dir)
            ds = FeatureDataset(
                out_dir, keys=("gabor_kwta",), label_fn=cls_of,
            )
            rows, lab_rows = [], []
            for b in ds.batches(64):
                rows.append(b["gabor_kwta"].reshape(len(b["stem"]), -1))
                lab_rows.extend(b["label"].tolist())
            feats = jnp.asarray(np.concatenate(rows))
            labels = np.asarray(lab_rows)
        dt = time.perf_counter() - t0
        audio_s = sum(len(s) for s in sigs) / sr
        print(
            f"[{args.features}] corpus->features: {audio_s:.1f} s audio in "
            f"{dt:.3f} s wall (RTF {audio_s / dt:.0f}x)"
        )
        tmp.cleanup()

    # all tokens share one duration -> one length bucket -> uniform D
    feats = jnp.reshape(jnp.asarray(feats), (n_total, -1))  # A1 input layer
    print(f"features: {feats.shape} from {n_total} tokens")

    perm = rng.permutation(n_total)
    split = int(0.8 * n_total)
    # device-side gather: features never round-trip to the host
    xtr, xte = feats[perm[:split]], feats[perm[split:]]
    ytr, yte = labels[perm[:split]], labels[perm[split:]]

    # ---- model: 2-layer MLP ---------------------------------------------
    din, dh, dout = feats.shape[1], 64, args.classes
    k0, k1 = jax.random.split(jax.random.PRNGKey(0))
    params = {
        "w1": jax.random.normal(k0, (din, dh)) * (2.0 / din) ** 0.5,
        "b1": jnp.zeros(dh),
        "w2": jax.random.normal(k1, (dh, dout)) * (2.0 / dh) ** 0.5,
        "b2": jnp.zeros(dout),
    }
    opt = optax.adam(3e-3)
    opt_state = opt.init(params)

    def forward(p, x):
        h = jax.nn.relu(x @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    @jax.jit
    def step(p, s, x, y):
        def loss_fn(p):
            logits = forward(p, x)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y
            ).mean()

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    xtr_d, ytr_d = jnp.asarray(xtr), jnp.asarray(ytr)
    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state, xtr_d, ytr_d)
        if i % 50 == 0 or i == args.steps - 1:
            acc = float(
                (jnp.argmax(forward(params, jnp.asarray(xte)), -1)
                 == jnp.asarray(yte)).mean()
            )
            print(f"step {i}: loss {float(loss):.4f} test acc {acc:.3f}")

    acc = float(
        (jnp.argmax(forward(params, jnp.asarray(xte)), -1)
         == jnp.asarray(yte)).mean()
    )
    print(f"final test accuracy: {acc:.3f} ({args.classes} classes)")


if __name__ == "__main__":
    main()
