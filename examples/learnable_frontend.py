"""Learnable gabor frontend: backpropagate through the feature extractor.

The reference's gabor bank is a fixed, hand-designed prior (agabor.Filter
specs rendered once, agabor/gabor.go:89-221). Because this rebuild is
functional JAX, the SAME convolution stage (dsp.gabor.convolve) is
differentiable with respect to its filter tensor -- so the filter bank can be
*trained* jointly with a classifier head, initialised from the biological
prior. This is a capability the scalar Go pipeline cannot express; see
tests/test_grad.py for the gradient contracts.

Pipeline here: signal -> (frozen) frame+DFT+mel via SndEnv -> learnable
gabor convolve -> mean-pooled features -> linear head. The mel features are
precomputed once (no gradient flows above the gabor stage), then filters and
head train jointly with optax.

Checkpoint/resume: ``--ckpt-dir DIR`` saves {params, opt_state, step} with
orbax every ``--ckpt-every`` steps (and at the end); rerunning with the same
directory restores the latest checkpoint and continues exactly where it
stopped (bit-identical to an uninterrupted run -- asserted in
tests/test_train_example.py::test_learnable_frontend_resume).

Usage: python examples/learnable_frontend.py [--steps 300] [--cpu]
       [--ckpt-dir /tmp/ckpt --ckpt-every 50]
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")

from train_phone_classifier import (  # noqa: E402
    assemble_batch,
    synth_token,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--n-per-class", type=int, default=40)
    ap.add_argument("--classes", type=int, default=6)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ckpt-dir", default="",
                    help="orbax checkpoint directory; if it already holds "
                    "checkpoints, training resumes from the latest")
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    from auditory_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()  # repeat runs skip recompilation

    from auditory_tpu.config import GaborSet, SndEnvConfig, default_gabor_specs
    from auditory_tpu.dsp.design import gabor_filters
    from auditory_tpu.dsp.gabor import convolve
    from auditory_tpu.pipeline.batch import BatchedSndEnv
    from auditory_tpu.pipeline.sndenv import SndEnv

    sr = 16000
    rng = np.random.default_rng(0)

    gset = GaborSet(
        size_x=9, size_y=9, stride_x=3, stride_y=3, gain=2.0,
        specs=default_gabor_specs(phases=(0.0, 1.5708)),
    )
    cfg = SndEnvConfig(gabor=gset)
    env = SndEnv(cfg, sr, outputs=("mel_fbank_segment", "step_valid"))
    benv = BatchedSndEnv(env)

    # ---- data: synthetic CV tokens -> frozen mel features ----------------
    n_total = args.classes * args.n_per_class
    labels = np.repeat(np.arange(args.classes), args.n_per_class)
    sigs = [env.pad(synth_token(c, rng, sr)) for c in labels]
    batch, lengths = assemble_batch(sigs, env.timing)

    out, _ = benv.process(batch, lengths)
    # mel_fbank_segment is [N, seg, n_mel, steps] -- exactly the [freq, time]
    # plane dsp.gabor.convolve consumes
    mel = np.asarray(out.mel_fbank_segment)
    print(f"mel features: {mel.shape}")

    perm = rng.permutation(n_total)
    split = int(0.8 * n_total)
    mel_d = jnp.asarray(mel)
    labels_d = jnp.asarray(labels)
    tr, te = perm[:split], perm[split:]

    # ---- model: learnable gabor bank (prior init) + linear head ----------
    filters0 = jnp.asarray(gabor_filters(gset), jnp.float32)  # [nf, sy, sx]
    nf = filters0.shape[0]

    def featurize(filters, mel_batch):
        g = convolve(mel_batch, filters, gset)  # [N, seg, fI, tI, 2, nf]
        # mean-pool over segments and positions -> [N, 2*nf] summary
        return jnp.mean(g, axis=(1, 2, 3)).reshape(mel_batch.shape[0], -1)

    din, dout = 2 * nf, args.classes
    k0 = jax.random.PRNGKey(0)
    params = {
        "filters": filters0,
        "w": jax.random.normal(k0, (din, dout)) * (2.0 / din) ** 0.5,
        "b": jnp.zeros(dout),
    }
    opt = optax.adam(3e-3)
    opt_state = opt.init(params)

    def loss_fn(p, x, y):
        z = featurize(p["filters"], x)
        logits = z @ p["w"] + p["b"]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y
        ).mean()

    # jitted eval paths: eager per-op dispatch would pay per-op compiles
    # and dispatches every 50 steps
    loss_jit = jax.jit(loss_fn)

    @jax.jit
    def predict(p, x):
        z = featurize(p["filters"], x)
        return jnp.argmax(z @ p["w"] + p["b"], -1)

    @jax.jit
    def step(p, s, x, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, x, y)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    def accuracy(p, idx):
        return float((predict(p, mel_d[idx]) == labels_d[idx]).mean())

    # ---- optional orbax checkpoint/resume --------------------------------
    ckptr = None
    start_step = 0
    if args.ckpt_dir:
        import os

        import orbax.checkpoint as ocp

        ckdir = os.path.abspath(args.ckpt_dir)
        os.makedirs(ckdir, exist_ok=True)
        ckptr = ocp.StandardCheckpointer()
        template = {
            "params": params, "opt_state": opt_state,
            "step": jnp.asarray(0),
        }
        import re

        # strict name filter: an interrupted save leaves an orbax staging
        # dir like 'step_100.orbax-checkpoint-tmp-<ts>' behind, which a
        # loose startswith+int parse would crash on -- resume must consider
        # only COMMITTED checkpoints
        done = sorted(
            (int(m.group(1)), d)
            for d in os.listdir(ckdir)
            for m in [re.fullmatch(r"step_(\d+)", d)]
            if m
        )
        if done:
            st = ckptr.restore(
                os.path.join(ckdir, done[-1][1]), template
            )
            params, opt_state = st["params"], st["opt_state"]
            start_step = int(st["step"])
            print(f"resumed from {done[-1][1]} (step {start_step})")

        def save(i, p, s):
            ckptr.save(
                os.path.join(ckdir, f"step_{i}"),
                {"params": p, "opt_state": s, "step": jnp.asarray(i)},
                force=True,
            )

    xtr, ytr = mel_d[tr], labels_d[tr]
    loss = loss_jit(params, xtr, ytr)  # defined even with --steps 0; on a
    # resumed run this is the RESUMED params' loss, labeled accordingly
    first_loss = float(loss)  # on a resumed run: the resumed params' loss
    for i in range(start_step, args.steps):
        params, opt_state, loss = step(params, opt_state, xtr, ytr)
        if (i + 1) % args.ckpt_every == 0 and ckptr is not None:
            save(i + 1, params, opt_state)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(loss):.4f} "
                  f"test acc {accuracy(params, te):.3f}")
    if ckptr is not None and args.steps > start_step:
        save(args.steps, params, opt_state)
        ckptr.wait_until_finished()

    drift = float(jnp.linalg.norm(params["filters"] - filters0)
                  / jnp.linalg.norm(filters0))
    print(f"filter drift from prior: {drift:.4f} (relative L2)")
    print(f"loss: {first_loss:.4f} -> {float(loss):.4f}")
    print(f"final test accuracy: {accuracy(params, te):.3f} "
          f"({args.classes} classes)")


if __name__ == "__main__":
    main()
