"""Batched / sharded corpus processing.

The reference processes one window at a time in one goroutine; at corpus
scale (TIMIT: thousands of utterances) the batched form is: pad utterances
into [B, S_max] batches (bucketed by length), run the whole SndEnv pipeline
for every segment of every utterance in one jitted program, shard the batch
axis over the device mesh, and mask invalid segments/steps.

Masking semantics (matches the reference exactly):
- step-invalid: window end beyond the signal -> zero columns
  (sndenv.go:353-359 break semantics; see dsp/frame.py)
- segment-invalid: segment index >= SegCnt(len) (sndenv.go:263-265) -> the
  reference never runs ProcessSegment for these; all outputs zeroed and
  ``seg_valid`` False.

Also provides :class:`CorpusRunner`: a three-stage overlapped pipeline
(host WAV decode || device compute || device->host transfer + ``.npz``
writes), with a resumable JSONL manifest (checkpoint/restart + failure
records for undecodable files; SURVEY.md section 5 aux-subsystem
equivalents). Stage N+1's decode runs concurrently with stage N's device
compute and stage N-1's output writes; bounded queues give backpressure.

Transfer-volume controls (the host<->device link is the corpus bottleneck,
not device compute):
- ``transfer='auto'`` ships 8/16-bit PCM audio as raw int16 (the WAV's own
  payload, half the bytes of float32) and normalizes on device: the jitted
  program computes ``int16.astype(f32) / divisor`` with the reference's
  divisor (sound/sound.go:130-141). This can differ from the host float
  path by <= 1 ulp of float32 per sample (float64-divide-then-round vs
  float32 divide) -- documented conscious deviation, gated by the
  ``transfer='float32'`` escape hatch. 24/32-bit and float WAVs always take
  the float path.
- ``transfer_dtype=jnp.float16`` (opt-in) casts the saved feature tensors to
  half precision on device before the device->host copy, halving download
  bytes; features feeding NN training are insensitive at this scale.
- ``transfer_dtype='int8'`` (opt-in, lossy) quantizes the packed features to
  int8 with per-channel ranges computed on device -- quarter the download
  bytes of float32. Error <= half a quantization step per channel (see
  :class:`PackedBatch`); exact zeros/sign of the gabor fold and NaN
  positions are preserved.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SndEnvConfig
from ..io.wav import load_wav
from ..parallel.mesh import batch_sharding, pad_to_multiple, replicated
from .sndenv import SndEnv, SndEnvOutputs

__all__ = ["BatchedSndEnv", "CorpusRunner", "PackedBatch", "bucket_length"]


@dataclass(frozen=True)
class PackEntry:
    """Layout of one key inside a :class:`PackedBatch` buffer."""

    key: str
    kind: str                       # "seg" (rows = segments) | "global"
                                    # | "meta" (row count never trimmed)
    view_shape: Tuple[int, ...]     # per-row trailing shape (post-fold)
    final_shape: Tuple[int, ...]    # true per-row trailing shape
    fold_ax: Optional[int]          # on/off axis in view_shape, or None
    rows: int                       # current row count in the buffer
    qchan_ax: Optional[int] = None  # int8 mode: channel axis in view_shape
    n_chan: int = 0                 # int8 mode: channels (0 = unquantized)

    @property
    def row_cols(self) -> int:
        n = 1
        for d in self.view_shape:
            n *= d
        if self.fold_ax is not None:
            n //= 2
        return n

    @property
    def cols(self) -> int:
        return self.rows * self.row_cols


@dataclass
class PackedBatch:
    """One flat device buffer [B, C] holding a whole batch's saved features.
    A single device->host copy per batch (every transfer pays a fixed
    cost, so many small copies of mel/gabor would waste bandwidth).

    Byte reductions applied at pack time (all lossless):
    - gabor on/off **fold**: the reference's half-rectified on/off pair
      (agabor/gabor.go:284-308) has at most one nonzero per (on, off) unit
      -- kWTA preserves exact zeros under the `_onoff_fold_exact` condition
      -- so the pair is stored as one signed value ``on - off`` and
      reconstructed exactly as (max(v,0), max(-v,0)).
    - **global-grid dedup**: a ``kind='global'`` entry (mel on the shared
      window grid) carries each window once instead of once per overlapping
      segment (~29% fewer mel bytes at the default 100 ms stride / 10 ms
      step + 2 border steps); callers expand host-side via
      ``SndEnv.global_grid``.
    - no validity column: per-file segment counts are a pure function of
      the (host-known) lengths, recomputed host-side by the caller.

    Opt-in LOSSY reduction (``transfer_dtype='int8'``): every float entry is
    quantized on device to int8 with per-ROW (utterance), per-channel
    ranges -- affine over [min, max] for spectral tensors (mel bands, MFCC
    coefficients, ...), symmetric around zero for the signed gabor fold so
    exact zeros and on/off routing survive quantization bit-for-bit. Each
    utterance gets its own scales, so a quiet file co-batched with a loud
    one keeps its own precision and outputs never depend on batch
    co-tenants. NaN (the mel triangle quirk can emit them) is preserved via
    the reserved code -128. The (scale, offset) pairs ride INSIDE the same
    single device->host copy as each row's trailing ``__qmeta__`` bitcast
    float32 bytes, so the one-copy-per-batch property is kept. Worst-case
    per-element error is half a quantization step: (max-min)/508 per
    row-channel (affine) or max|x|/254 (symmetric)."""

    data: Any                       # [B, C] device array
    entries: Tuple[PackEntry, ...]
    sps: int                        # stride/step ratio (global-row trim)
    steps: int                      # segment_steps (global-row trim)

    def _rows_for(self, kind: str, max_seg: int) -> int:
        if kind == "seg":
            return max_seg
        if kind == "meta":
            return 1 << 62  # never trimmed (trim min()s against e.rows)
        return (max_seg - 1) * self.sps + self.steps if max_seg > 0 else 0

    def trim(self, max_seg: int) -> "PackedBatch":
        """Device-side slice to the first ``max_seg`` segments (the rest are
        invalid padding for every file in the batch); shrinks the host copy."""
        parts, new_entries, off = [], [], 0
        changed = False
        for e in self.entries:
            rows = min(self._rows_for(e.kind, max_seg), e.rows)
            parts.append(self.data[:, off : off + rows * e.row_cols])
            new_entries.append(dataclasses.replace(e, rows=rows))
            changed |= rows != e.rows
            off += e.cols
        if not changed:
            return self
        return dataclasses.replace(
            self,
            data=jnp.concatenate(parts, axis=-1),
            entries=tuple(new_entries),
        )

    def unpack(self) -> Dict[str, np.ndarray]:
        """One host copy -> {key: [B, rows, ...]} with folds expanded
        (``global`` entries stay on the global grid) and, in int8 mode,
        values dequantized back to float32 (NaN code restored)."""
        host = np.asarray(self.data)
        b = host.shape[0]
        qscales = None
        if host.dtype == np.int8 and self.entries and (
            self.entries[-1].key == "__qmeta__"
        ):
            meta = self.entries[-1]
            tail = np.ascontiguousarray(host[:, host.shape[1] - meta.cols:])
            # [B, n_floats]; per entry: scale[B, n], off[B, n]
            qscales = tail.view(np.float32)
        out, off, qoff = {}, 0, 0
        for e in self.entries:
            if e.key == "__qmeta__":
                continue
            block = host[:, off : off + e.cols]
            off += e.cols
            folded_shape = list(e.view_shape)
            if e.fold_ax is not None:
                folded_shape[e.fold_ax] = 1
            v = block.reshape((b, e.rows) + tuple(folded_shape))
            if qscales is not None and e.n_chan:
                scale = qscales[:, qoff : qoff + e.n_chan]
                qo = qscales[:, qoff + e.n_chan : qoff + 2 * e.n_chan]
                qoff += 2 * e.n_chan
                bshape = [b] + [1] * (v.ndim - 1)
                if e.qchan_ax is not None:
                    bshape[2 + e.qchan_ax] = e.n_chan
                scale = scale.reshape(bshape)
                qo = qo.reshape(bshape)
                x = v.astype(np.float32) * scale + qo
                v = np.where(v == -128, np.float32(np.nan), x)
            if e.fold_ax is None:
                out[e.key] = v.reshape((b, e.rows) + e.view_shape)
                continue
            on = np.maximum(v, 0)
            off_ch = np.maximum(-v, 0)
            full = np.concatenate([on, off_ch], axis=2 + e.fold_ax)
            out[e.key] = full.reshape((b, e.rows) + e.final_shape)
        return out


def _quant_chan_axis(
    key: str, view_shape: Tuple[int, ...], fold_ax: Optional[int]
) -> Optional[int]:
    """int8 mode: which axis of the per-row view indexes feature channels
    (each channel gets its own quantization range). Gabor layouts quantize
    per filter (4-D) / per freq row (2-D); spectral [C, steps] tensors per
    band/coefficient; mel_fbank_global rows are [n_mel] vectors; a 1-D
    [steps] row (energy) is one channel."""
    if fold_ax is not None:
        return 3 if len(view_shape) == 4 else 0
    if len(view_shape) >= 2 or key == "mel_fbank_global":
        return 0
    return None


def _saturate_cast(x: jnp.ndarray, td) -> jnp.ndarray:
    """Cast a leaf to the transfer dtype, SATURATING float32->float16 at
    f16 max (65504) instead of overflowing to +-inf: the unnormalized DFT
    power reaches (win*amp)^2 ~ 1.6e5 on full-scale 16 kHz input. NaN
    propagates through the clip unchanged. Non-float leaves skip the clamp
    but ARE cast to ``td`` (packed buffers need one uniform dtype; the
    per-leaf tree path filters to float leaves before calling this)."""
    if td == jnp.float16 and jnp.issubdtype(x.dtype, jnp.floating):
        x = jnp.clip(x, -65504.0, 65504.0)
    return x.astype(td)


def _quantize_int8(
    a: jnp.ndarray,
    chan_ax: Optional[int],
    symmetric: bool,
    per_row: bool = False,
):
    """Quantize [B, rows, *view] to int8 with per-channel ranges computed on
    device. Returns (q int8, scale f32, offset f32); dequantization is
    ``q * scale + offset`` with the reserved code -128 restoring non-finite
    values as NaN. ``symmetric`` centers the grid on zero (q=0 <-> exactly
    0.0), used for the signed gabor fold so sparsity and on/off routing
    survive. ``per_row`` keeps axis 0 (the utterance/stream axis) out of the
    range reductions -- each row gets its own scales (returned [B, n_chan]
    instead of [n_chan]) so a quiet row co-batched with a loud one keeps
    its own precision and its outputs do not depend on co-tenants."""
    a = a.astype(jnp.float32)
    red = tuple(
        i for i in range(a.ndim)
        if (chan_ax is None or i != 2 + chan_ax) and (i != 0 or not per_row)
    )
    finite = jnp.isfinite(a)
    amax = jnp.max(jnp.where(finite, a, -jnp.inf), axis=red, keepdims=True)
    amin = jnp.min(jnp.where(finite, a, jnp.inf), axis=red, keepdims=True)
    empty = amin > amax  # channel with no finite values
    amax = jnp.where(empty, 0.0, amax)
    amin = jnp.where(empty, 0.0, amin)
    if symmetric:
        scale = jnp.maximum(jnp.abs(amax), jnp.abs(amin)) / 127.0
        offv = jnp.zeros_like(scale)
    else:
        scale = (amax - amin) / 254.0
        offv = amin + 127.0 * scale
    safe = jnp.where(scale == 0, 1.0, scale)
    q = jnp.clip(jnp.round((a - offv) / safe), -127.0, 127.0)
    q = jnp.where(scale == 0, 0.0, q)
    q = jnp.where(finite, q, -128.0).astype(jnp.int8)
    sshape = (a.shape[0], -1) if per_row else (-1,)
    return (
        q,
        scale.reshape(sshape).astype(jnp.float32),
        offv.reshape(sshape).astype(jnp.float32),
    )


def _onoff_fold_exact(kwta) -> bool:
    """Whether the gabor on/off fold is exact through the kWTA settle.

    The fold relies on 'at most one of each (on, off) pair is nonzero'. The
    convolution guarantees it for the raw output; the settle preserves it
    iff a zero-drive unit stays exactly zero, i.e. the noisy-XX1 shoulder
    (which extends 4*nvar below 0) cannot reach the *minimum* threshold
    drive ge_thr(gi=0) = gbar_l*(thr - erev_l)/(erev_e - thr). With the
    defaults (nvar=0.01 -> 0.04 <= 0.08) it holds; a user-raised nvar can
    break it, in which case the pack keeps both channels."""
    if not kwta.on:
        return True
    min_thr = (
        kwta.gbar_l * (kwta.thr - kwta.erev_l) / (kwta.erev_e - kwta.thr)
    )
    return 4.0 * kwta.xx1_nvar <= min_thr


def bucket_length(
    n: int,
    timing,
    min_samples: Optional[int] = None,
    quantum: int = 0,
) -> int:
    """Round a padded signal length up to the next stride boundary so jit
    recompiles only per bucket, not per file. ``quantum`` (samples) coarsens
    the buckets further -- each distinct bucket is one XLA compile, and
    compiles are expensive; masking makes the extra padding free."""
    stride = timing.stride_samples
    base = timing.segment_samples
    step = max(stride, quantum)
    if n <= base:
        out = base
    else:
        k = -(-(n - base) // step)
        out = base + k * step
        # keep the stride alignment the masking math expects
        out = base + (-(-(out - base) // stride)) * stride
    if min_samples is not None:
        out = max(out, min_samples)
    return out


def _pad_batch_rows(xp, signals, lengths, divisors, multiple, min_rows=0):
    """Pad the batch to a multiple of ``multiple`` with INERT rows (zero
    signal, length 0, divisor 1 — the validity masks and stats moments
    ignore them). THE single implementation of the pad-row invariant:
    ``process()`` (xp=jnp, device arrays) and ``process_local()`` (xp=np,
    host arrays pre-global-assembly) both use it, so the semantics cannot
    drift. Returns (signals, lengths, divisors, pad_count)."""
    b = signals.shape[0]
    pad = pad_to_multiple(max(b, min_rows), multiple) - b
    lengths = xp.asarray(lengths, dtype=xp.int32)
    if divisors is not None:
        divisors = xp.asarray(divisors, dtype=xp.float32)
    if pad:
        signals = xp.concatenate(
            [signals, xp.zeros((pad,) + signals.shape[1:], signals.dtype)]
        )
        lengths = xp.concatenate([lengths, xp.zeros(pad, dtype=xp.int32)])
        if divisors is not None:
            divisors = xp.concatenate(
                [divisors, xp.ones(pad, dtype=xp.float32)]
            )
    return signals, lengths, divisors, pad


class BatchedSndEnv:
    """The SndEnv pipeline over a padded utterance batch, optionally sharded
    over a device mesh.

    shard_axis='batch' (default): data parallelism over utterances -- the
    signals' leading axis is sharded, no collectives in the hot path.

    shard_axis='segment': CP-style sharding of the *segment* axis for few
    very long utterances -- the signal is replicated (cheap relative to the
    per-segment compute) and every [B, seg, ...] intermediate is constrained
    to shard on axis 1; segments are independent when prev_smooth == 0, so
    this is also communication-free. SURVEY.md section 5 long-context
    equivalent.

    ``transfer_dtype``: cast floating outputs to this dtype on device before
    they leave the program (halves device->host bytes with float16), or
    ``'int8'`` for per-channel quantized transfer (quarter bytes, lossy,
    packed mode only; see :class:`PackedBatch`).
    """

    def __init__(
        self,
        env: SndEnv,
        mesh: Optional[jax.sharding.Mesh] = None,
        axis_name: str = "data",
        shard_axis: str = "batch",
        transfer_dtype=None,
        pack_keys: Optional[Tuple[str, ...]] = None,
    ):
        if shard_axis not in ("batch", "segment"):
            raise ValueError("shard_axis must be 'batch' or 'segment'")
        if shard_axis == "segment" and env.cfg.dft.prev_smooth != 0.0:
            raise ValueError(
                "segment sharding requires prev_smooth == 0 (the smoothing "
                "recurrence couples steps within a segment only, but the "
                "reference zeroes state per segment -- still, keep it simple)"
            )
        if shard_axis == "segment" and mesh is not None and pack_keys:
            raise ValueError(
                "shard_axis='segment' cannot be combined with pack_keys: "
                "the packed [B, C] buffer flattens the segment axis into "
                "byte columns, so the output sharding constraint would cut "
                "across per-entry blocks and force XLA to reshard the "
                "segment-sharded intermediates -- exactly the collectives "
                "this mode exists to avoid. Pack on the batch axis, or use "
                "unpacked outputs with segment sharding."
            )
        self.env = env
        self.mesh = mesh
        self.axis_name = axis_name
        self.shard_axis = shard_axis
        self.transfer_dtype = (
            jnp.dtype(transfer_dtype) if transfer_dtype is not None else None
        )
        self.pack_keys = tuple(pack_keys) if pack_keys is not None else None
        self.quantize = self.transfer_dtype == jnp.dtype(jnp.int8)
        if self.quantize and self.pack_keys is None:
            raise ValueError(
                "transfer_dtype='int8' (quantized transfer) requires the "
                "packed mode (pack_keys); the unpacked API returns the true "
                "float tensors"
            )
        self._jit_cache: Dict[Tuple[int, int, bool], Any] = {}

    def _build(self, n_samples: int, add_ms: int, with_divisors: bool):
        # the SndEnv program is natively batched: [B, S] + lengths [B]
        inner = self.env._build(n_samples, add_ms)
        dtype = self.env.dtype
        td = self.transfer_dtype

        pack_keys = self.pack_keys
        pack_meta: Dict[str, Any] = {}

        quantize = self.quantize

        def cast_out(res):
            if td is not None and not quantize:
                cast = lambda x: (
                    _saturate_cast(x, td)
                    if x is not None and jnp.issubdtype(x.dtype, jnp.floating)
                    else x
                )
                out = jax.tree_util.tree_map(
                    cast, res[0], is_leaf=lambda v: v is None
                )
                res = (out,) + tuple(res[1:])
            if pack_keys is None:
                return res
            # pack the saved features into ONE flat [B, C] buffer: a single
            # device->host copy per batch. Validity is NOT shipped -- the
            # per-file segment count is a pure function of the host-known
            # length (config.DerivedTiming.seg_cnt). Gabor on/off pairs are
            # folded into one signed channel, and global-grid entries carry
            # each shared window once (see PackedBatch).
            out = res[0]
            ptd = td if td is not None else dtype
            is_4d = self.env.is_4d
            cols, entries, qscales = [], [], []
            for k in pack_keys:
                a = getattr(out, k)
                if a is None:
                    continue
                final_shape = tuple(a.shape[2:])
                view_shape, fold_ax = final_shape, None
                kind = "global" if k == "mel_fbank_global" else "seg"
                foldable = k == "gabor_raw" or (
                    k == "gabor_kwta" and _onoff_fold_exact(self.env.cfg.kwta)
                )
                if foldable:
                    if is_4d and len(final_shape) == 4:
                        fold_ax = 2  # [py, px, 2, nf]
                    elif len(final_shape) == 2 and final_shape[0] % 2 == 0:
                        # 2-D layout interleaves on/off rows (2f, 2f+1)
                        view_shape = (
                            final_shape[0] // 2, 2, final_shape[1]
                        )
                        fold_ax = 1
                if fold_ax is not None:
                    v = a.reshape(a.shape[:2] + view_shape)
                    on, off = jnp.split(v, 2, axis=2 + fold_ax)
                    a = on - off  # exact: at most one of the pair is nonzero
                qchan_ax, n_chan = None, 0
                if quantize:
                    if not jnp.issubdtype(a.dtype, jnp.floating):
                        raise ValueError(
                            f"int8 quantized transfer: key {k!r} is "
                            f"{a.dtype}, not float"
                        )
                    qchan_ax = _quant_chan_axis(k, view_shape, fold_ax)
                    n_chan = 1 if qchan_ax is None else view_shape[qchan_ax]
                    a, scale, offv = _quantize_int8(
                        a, qchan_ax, symmetric=fold_ax is not None,
                        per_row=True,
                    )
                    qscales += [scale, offv]  # each [B, n_chan]
                    flat = a.reshape(a.shape[0], -1)
                else:
                    flat = _saturate_cast(a.reshape(a.shape[0], -1), ptd)
                cols.append(flat)
                entries.append(
                    PackEntry(
                        key=k, kind=kind, view_shape=view_shape,
                        final_shape=final_shape, fold_ax=fold_ax,
                        rows=a.shape[1], qchan_ax=qchan_ax, n_chan=n_chan,
                    )
                )
            if quantize:
                # per-ROW trailer: each row carries its own f32 scale/offset
                # bytes, so the copy ships exactly one set per utterance
                svec = jnp.concatenate(qscales, axis=1)  # [B, n_floats]
                sbytes = jax.lax.bitcast_convert_type(
                    svec, jnp.int8
                ).reshape(svec.shape[0], -1)  # little-endian f32 bytes
                cols.append(sbytes)
                entries.append(
                    PackEntry(
                        key="__qmeta__", kind="meta",
                        view_shape=(int(sbytes.shape[1]),),
                        final_shape=(int(sbytes.shape[1]),),
                        fold_ax=None, rows=1,
                    )
                )
            t = self.env.timing
            pack_meta["entries"] = tuple(entries)
            pack_meta["sps"] = (
                t.stride_samples // t.step_samples
                if t.step_samples and t.stride_samples % t.step_samples == 0
                else 0
            )
            pack_meta["steps"] = t.segment_steps
            return (jnp.concatenate(cols, axis=-1),) + tuple(res[2:])

        if with_divisors:
            # raw integer audio in, reference normalization on device
            # (sound/sound.go:130-141; divide, not reciprocal-multiply, to
            # stay within 1 ulp of the host float path)
            def batch_program(signals, divisors, lengths):
                sig = signals.astype(dtype) / divisors[:, None].astype(dtype)
                return cast_out(inner(sig, lengths))
        else:
            def batch_program(signals, lengths):
                return cast_out(inner(signals, lengths))

        n_in = 3 if with_divisors else 2
        if self.mesh is None:
            return jax.jit(batch_program), pack_meta

        if self.shard_axis == "batch":
            shardings = [batch_sharding(self.mesh, 2, self.axis_name)]
            shardings += [batch_sharding(self.mesh, 1, self.axis_name)] * (
                n_in - 1
            )
            return (
                jax.jit(batch_program, in_shardings=tuple(shardings)),
                pack_meta,
            )

        # segment sharding: replicate inputs, constrain outputs on axis 1
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh, axis = self.mesh, self.axis_name

        def seg_sharded(x):
            if x is None or x.ndim < 2:
                return x
            spec = P(None, axis, *([None] * (x.ndim - 2)))
            return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))

        # pack_keys + segment sharding is rejected at __init__ (the packed
        # [B, C] buffer flattens the segment axis away), so outputs here are
        # always the unpacked tree
        assert pack_keys is None

        def program(*args):
            res = batch_program(*args)
            out, seg_valid, rest = res[0], res[1], res[2:]
            out = jax.tree_util.tree_map(
                seg_sharded, out, is_leaf=lambda v: v is None
            )
            return (out, seg_sharded(seg_valid)) + rest

        repl = replicated(self.mesh)
        return jax.jit(program, in_shardings=(repl,) * n_in), pack_meta

    def process_fn(
        self, n_samples: int, add_ms: int = 0, with_divisors: bool = False
    ):
        return self._fn_and_meta(n_samples, add_ms, with_divisors)[0]

    def _fn_and_meta(
        self, n_samples: int, add_ms: int = 0, with_divisors: bool = False
    ):
        key = (n_samples, add_ms, with_divisors)
        if key not in self._jit_cache:
            self._jit_cache[key] = self._build(n_samples, add_ms, with_divisors)
        return self._jit_cache[key]

    def process(
        self,
        signals: np.ndarray,
        lengths: np.ndarray,
        add_ms: int = 0,
        divisors: Optional[np.ndarray] = None,
    ) -> Tuple[SndEnvOutputs, jnp.ndarray]:
        """signals [B, S] (padded), lengths [B] -> (outputs with leading
        [B, seg] axes, seg_valid [B, seg]).

        With ``divisors`` [B], signals are raw integer samples (int16) and
        the program normalizes on device: ``signals.astype(f) / divisors``.

        Any batch size works on any mesh: when B is not a multiple of the
        device count, the batch is padded internally with zero-length rows
        (which the seg/step validity masks make inert, including in the
        feature-stats moments) and the padded rows are sliced off the
        returned outputs."""
        signals = jnp.asarray(signals)
        b = signals.shape[0]
        with_div = divisors is not None
        signals, lengths, divisors, pad = _pad_batch_rows(
            jnp, signals, lengths, divisors, self.batch_multiple
        )
        b_padded = b + pad
        fn, pack_meta = self._fn_and_meta(signals.shape[-1], add_ms, with_div)
        if self.mesh is not None and self.shard_axis == "batch":
            put1 = lambda x: jax.device_put(
                x, batch_sharding(self.mesh, 1, self.axis_name)
            )
            signals = jax.device_put(
                signals, batch_sharding(self.mesh, 2, self.axis_name)
            )
            lengths = put1(jnp.asarray(lengths, dtype=jnp.int32))
            if with_div:
                divisors = put1(divisors)
        elif self.mesh is not None:
            put = lambda x: jax.device_put(x, replicated(self.mesh))
            signals = put(signals)
            lengths = put(jnp.asarray(lengths, dtype=jnp.int32))
            if with_div:
                divisors = put(divisors)
        else:
            lengths = jnp.asarray(lengths, dtype=jnp.int32)
        args = (signals, divisors, lengths) if with_div else (signals, lengths)
        res = fn(*args)
        if self.pack_keys is not None:
            data = res[0][:b] if b_padded != b else res[0]
            packed = PackedBatch(data=data, **pack_meta)
            return (packed,) + tuple(res[1:])
        if b_padded != b:
            trim = lambda x: None if x is None else x[:b]
            out = jax.tree_util.tree_map(
                trim, res[0], is_leaf=lambda v: v is None
            )
            res = (out, res[1][:b]) + res[2:]
        return res

    def process_local(
        self,
        signals: np.ndarray,
        lengths: np.ndarray,
        add_ms: int = 0,
        divisors: Optional[np.ndarray] = None,
    ):
        """Multi-process SPMD entry (``jax.distributed``): each process
        passes only its LOCAL batch rows; the global batch is the
        process-ordered concatenation and runs as ONE jitted SPMD program
        over the multi-process mesh, XLA inserting any cross-process
        collectives (for this pipeline: the feature-stats all-reduce only).

        Every process must pass the same local row count. Rows are padded
        internally to the per-process device multiple with zero-length
        rows (inert: their seg_valid is all-False and the stats masks
        exclude them); they are NOT trimmed from the returned global
        arrays -- use the returned pad count after gathering.

        With ``shard_axis='segment'`` (multi-host CP for few very long
        utterances): every process passes the SAME full batch — the
        signal is replicated across the pod (cheap relative to per-segment
        compute) and the *segment* axis of every output comes back
        sharded over the global mesh; ``pad_rows`` is then 0.

        Returns ``(res, pad_rows)``: ``res`` is the same tuple
        :meth:`process` returns pre-trim (outputs/packed, seg_valid, and
        the stats dict when ``feature_stats``), every leaf a global
        ``jax.Array`` addressable only for this process' shards
        (``parallel.distributed.allgather`` replicates them); ``pad_rows``
        is the number of zero rows appended to each process' local block
        (global row ``p * (b_local + pad_rows) + i`` is process p's row i).
        """
        from ..parallel.distributed import global_batch_from_local

        if self.mesh is None:
            raise ValueError("process_local requires a mesh")
        mesh = self.mesh
        if self.shard_axis == "segment":
            # replicated inputs (identical on every process by contract),
            # segment-sharded outputs over the global mesh
            signals = np.asarray(signals)
            with_div = divisors is not None
            fn, pack_meta = self._fn_and_meta(
                signals.shape[-1], add_ms, with_div
            )
            repl = replicated(mesh)
            g = lambda x, dt=None: jax.make_array_from_process_local_data(
                repl, np.asarray(x, dtype=dt) if dt else np.asarray(x)
            )
            args = (
                (g(signals), g(divisors, np.float32),
                 g(lengths, np.int32))
                if with_div
                else (g(signals), g(lengths, np.int32))
            )
            res = fn(*args)
            assert self.pack_keys is None  # rejected at __init__
            return res, 0
        n_local = sum(
            1
            for d in mesh.devices.flat
            if d.process_index == jax.process_index()
        )
        if n_local == 0:
            raise ValueError(
                "this process owns no devices of the mesh; every "
                "participating process must contribute devices"
            )
        signals = np.asarray(signals)
        with_div = divisors is not None
        signals, lengths, divisors, pad = _pad_batch_rows(
            np, signals, lengths, divisors, n_local, min_rows=1
        )
        fn, pack_meta = self._fn_and_meta(
            signals.shape[-1], add_ms, with_div
        )
        g = lambda x: global_batch_from_local(mesh, x, self.axis_name)
        args = (
            (g(signals), g(divisors), g(lengths))
            if with_div
            else (g(signals), g(lengths))
        )
        res = fn(*args)
        if self.pack_keys is not None:
            res = (PackedBatch(data=res[0], **pack_meta),) + tuple(res[1:])
        # single-process meshes work here too: the path then equals
        # process() without the trim
        return res, pad

    @property
    def batch_multiple(self) -> int:
        if self.mesh is None or self.shard_axis != "batch":
            return 1
        return self.mesh.devices.size


@dataclass
class CorpusStats:
    files_done: int = 0
    files_failed: int = 0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0

    @property
    def rtf(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0


_SENTINEL = object()


def _rate_mismatch_msg(got: int, want: int) -> str:
    """Shared by the Python and native decode paths (they must not drift)."""
    return f"sample rate {got} != pipeline rate {want}"


def _multichannel_msg(channels: int) -> str:
    """The reference's SegCnt divides by Channels() (sndenv.go:263-265);
    batching mixed channel counts would silently give multi-channel files
    ~channels x the segment count -- refuse loudly instead (failure record,
    not crash). Shared by the Python and native decode paths."""
    return (
        f"{channels}-channel WAV: corpus batching is single-channel; "
        "de-interleave first (e.g. cli process --channel N)"
    )


class CorpusRunner:
    """Resumable overlapped batched extraction over a corpus of WAV files.

    Three concurrent stages (decode || compute || write):
    - a decode thread runs the native (or thread-pool) WAV decoder and feeds
      a bounded queue;
    - the main thread forms length buckets and *dispatches* device batches
      (JAX dispatch is asynchronous, so compute of batch N overlaps both
      decode of N+1 and writes of N-1);
    - a writer thread blocks on results, copies them to host, and writes
      per-utterance ``.npz`` files plus the JSONL manifest.

    ``manifest.jsonl`` in ``out_dir``: one record per file
    ({path, status: ok|error, error?}); on resume, files already 'ok' are
    skipped (checkpoint/restart equivalent, SURVEY.md section 5).
    Undecodable/odd files are recorded as errors and skipped, never fatal
    (failure-detection equivalent). The manifest is written only by the
    writer thread, so record order is deterministic per batch.

    ``pipeline_depth`` bounds how many dispatched-but-unwritten batches may
    be in flight (device memory backpressure).
    """

    def __init__(
        self,
        cfg: SndEnvConfig,
        sample_rate: int,
        # a fixed per-copy cost dominates small payloads, so fewer/larger
        # batches amortize it (the best size on a GPU is not yet measured)
        batch_size: int = 128,
        dtype=jnp.float32,
        mesh: Optional[jax.sharding.Mesh] = None,
        save_keys: Sequence[str] = ("mel_fbank_segment", "gabor_kwta"),
        decode_threads: int = 8,
        bucket_quantum_s: float = 1.0,
        feature_stats: bool = True,
        transfer: str = "auto",
        transfer_dtype=None,
        pipeline_depth: int = 3,
        dedup_mel: Optional[bool] = None,
        matmul_precision: str = "highest",
        spectrum_method: Optional[str] = None,
    ):
        if transfer not in ("auto", "float32"):
            raise ValueError("transfer must be 'auto' or 'float32'")
        # mel dedup: ship the global-grid mel (each shared window once,
        # ~29% fewer mel bytes at default geometry) and expand to the
        # per-segment tensor host-side; requires the uniform window grid.
        # dedup_mel=None: auto; False: force the per-segment transfer.
        t = cfg.params.derive(sample_rate)
        self._dedup_mel = (
            "mel_fbank_segment" in save_keys
            and t.step_samples > 0
            and t.stride_samples % t.step_samples == 0
            and cfg.dft.prev_smooth == 0.0
            and dedup_mel is not False
        )
        if dedup_mel is True and not self._dedup_mel:
            raise ValueError(
                "dedup_mel requires mel_fbank_segment in save_keys, a "
                "stride divisible by the step, and prev_smooth == 0"
            )
        env_keys = tuple(dict.fromkeys(
            "mel_fbank_global"
            if (k == "mel_fbank_segment" and self._dedup_mel)
            else k
            for k in save_keys
        ))  # dict.fromkeys: requesting mel_fbank_segment AND
        # mel_fbank_global under dedup must not pack the grid twice
        # only materialize what gets saved (XLA DCEs the rest)
        self.env = SndEnv(
            cfg, sample_rate, dtype=dtype,
            # validity is never shipped: per-file counts/masks are pure
            # functions of the host-known lengths (see PackedBatch)
            outputs=env_keys,
            feature_stats=feature_stats,
            matmul_precision=matmul_precision,
            spectrum_method=spectrum_method,
        )
        # packed transfer: one device->host copy per batch (a fixed
        # per-copy cost dominates many small transfers)
        self.batched = BatchedSndEnv(
            self.env, mesh=mesh, transfer_dtype=transfer_dtype,
            pack_keys=env_keys,
        )
        self._grid_cache: Dict[Tuple[int, int], Tuple] = {}
        self._batched_dev = None  # lazy: iter_device_features' unpacked env
        self.batch_size = batch_size
        self.save_keys = tuple(save_keys)
        self.decode_threads = decode_threads
        self._bucket_quantum = int(bucket_quantum_s * sample_rate)
        self.sample_rate = sample_rate
        self.transfer = transfer
        self.pipeline_depth = max(int(pipeline_depth), 1)
        # pre-pad audio lengths recorded at decode (reset per run): the
        # decoders return PADDED signals, whose length would inflate the
        # reported corpus RTF by the pad fraction
        self._true_lens: Dict[str, int] = {}

    # ---------------------------------------------------------------- decode

    def _decode(self, path: str):
        """Single-file host decode -> (path, signal, divisor|None, err|None).

        divisor is set when the signal is raw int16 audio to be normalized
        on device; None means the signal is already reference-normalized
        float32."""
        try:
            w = load_wav(path)
            if w.sample_rate != self.sample_rate:
                return path, None, None, _rate_mismatch_msg(
                    w.sample_rate, self.sample_rate
                )
            if w.channels > 1:
                return path, None, None, _multichannel_msg(w.channels)
            if self.transfer == "auto" and w.source_bit_depth <= 16:
                sig = w.data[: w.num_frames].astype(np.int16)
                div = w._norm_divisor()
                self._true_lens[path] = len(sig)
                return path, self.env.pad(sig), np.float32(div), None
            sig = w.sound_to_tensor(dtype=np.float32)
            self._true_lens[path] = len(sig)
            return path, self.env.pad(sig), None, None
        except Exception as e:  # noqa: BLE001 - failure detection, not flow
            return path, None, None, f"{type(e).__name__}: {e}"

    def _decode_many(self, paths):
        """Decode a list of paths -> iterable of
        (path, signal|None, divisor|None, err|None).

        Uses the native threaded batch decoder (csrc/auditory_io.cpp) when
        built, else the Python thread pool."""
        from ..io import native

        if not native.available() or not paths:
            with ThreadPoolExecutor(self.decode_threads) as pool:
                yield from pool.map(self._decode, paths)
            return

        # chunked native decode: bounds the [chunk, max_frames] buffer and
        # keeps host decode overlapping with device compute
        chunk_files = max(self.batch_size, 32)
        for lo in range(0, len(paths), chunk_files):
            group = paths[lo : lo + chunk_files]
            max_frames = 0
            metas = {}
            for p in group:
                try:
                    sr, ch, bd, nf = native.wav_info(p)
                    if ch > 1:
                        metas[p] = ValueError(_multichannel_msg(ch))
                        continue
                    metas[p] = (sr, nf)
                    max_frames = max(max_frames, nf)
                except Exception as e:  # noqa: BLE001 - never-fatal per file
                    # broad on purpose: the pure-Python fallback records ANY
                    # per-file exception as a manifest error; the native
                    # path must not be stricter (e.g. a UnicodeEncodeError
                    # from an un-encodable filename would otherwise kill
                    # the decode thread and the whole run)
                    metas[p] = e
            ok_paths = [p for p in group if not isinstance(metas[p], Exception)]
            yield from self._native_decode_group(
                group, ok_paths, max(max_frames, 1), metas
            )

    def _native_decode_group(self, group, ok_paths, max_frames, metas):
        from ..io import native

        results: Dict[str, Tuple] = {}
        float_paths = ok_paths
        if self.transfer == "auto" and native.has_i16():
            out, lengths, srs, divs, sts = native.decode_batch_i16(
                ok_paths, max_frames, n_threads=self.decode_threads
            )
            float_paths = []
            for i, p in enumerate(ok_paths):
                st = int(sts[i])
                if st == native.STATUS_NOT_I16:
                    float_paths.append(p)  # fall back below
                elif st != 0:
                    results[p] = (p, None, None, native.STATUS_NAMES.get(st, str(st)))
                elif srs[i] != self.sample_rate:
                    results[p] = (p, None, None, _rate_mismatch_msg(
                        srs[i], self.sample_rate
                    ))
                else:
                    sig = out[i, : lengths[i]]
                    self._true_lens[p] = int(lengths[i])
                    results[p] = (
                        p, self.env.pad(sig), np.float32(divs[i]), None
                    )
        if float_paths:
            out, lengths, srs, errors = native.decode_batch(
                float_paths, max_frames, n_threads=self.decode_threads
            )
            for i, p in enumerate(float_paths):
                if errors[i] is not None:
                    results[p] = (p, None, None, errors[i])
                elif srs[i] != self.sample_rate:
                    results[p] = (p, None, None, _rate_mismatch_msg(
                        srs[i], self.sample_rate
                    ))
                else:
                    sig = out[i, : lengths[i]]
                    self._true_lens[p] = int(lengths[i])
                    results[p] = (p, self.env.pad(sig), None, None)
        for p in group:
            meta = metas[p]
            if isinstance(meta, Exception):
                yield p, None, None, str(meta)
            else:
                yield results[p]

    # ---------------------------------------------------------------- naming

    @staticmethod
    def _out_names(paths: Sequence[str]) -> Dict[str, str]:
        """Unique output stem per input path. Same-named WAVs in different
        directories (the normal TIMIT layout: DR1/FCJF0/SA1.WAV,
        DR1/FVMH0/SA1.WAV, ...) must not clobber each other, so stems come
        from the path relative to the corpus' common directory with
        separators flattened to '_'."""
        if not paths:
            return {}
        dirs = {os.path.dirname(os.path.abspath(p)) for p in paths}
        common = os.path.commonpath(list(dirs)) if len(dirs) > 1 else dirs.pop()
        naturals = [
            os.path.splitext(
                os.path.relpath(os.path.abspath(p), common)
            )[0].replace(os.sep, "_")
            for p in paths
        ]
        # flattening separators can itself collide (DR1/A/S1 vs DR1/A_S1);
        # disambiguate deterministically. The '-n' suffix must ALSO avoid
        # the natural stem set (DR1/A_S1-1.WAV exists alongside DR1/A/S1
        # and DR1/A_S1: suffixing the latter to 'A_S1-1' would clobber it)
        natural_set = set(naturals)
        out = {}
        used = set()
        counts: Dict[str, int] = {}
        for p, stem in zip(paths, naturals):
            if stem not in used:
                used.add(stem)
                out[p] = stem
                continue
            n = counts.get(stem, 0) + 1
            cand = f"{stem}-{n}"
            while cand in used or cand in natural_set:
                n += 1
                cand = f"{stem}-{n}"
            counts[stem] = n
            used.add(cand)
            out[p] = cand
        return out

    # ------------------------------------------------------------------- run

    def run(
        self,
        wav_paths: Sequence[str],
        out_dir: str,
        resume: bool = True,
        add_ms: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> CorpusStats:
        """Extract features for ``wav_paths`` into ``out_dir``.

        Multi-host scale-out (``num_shards > 1``): the corpus is
        embarrassingly parallel (the pipeline is pointwise per utterance,
        SURVEY.md section 5), so hosts need no collectives -- each host runs
        its own runner over the deterministic interleaved slice
        ``wav_paths[shard_index::num_shards]`` with per-shard manifest and
        feature-stats files, and :meth:`merge_shards` combines them (moment
        sums add exactly). All hosts must pass the SAME full ``wav_paths``
        list (output stems are disambiguated against the full list so
        basename collisions stay collision-free across shards)."""
        if not 0 <= shard_index < num_shards:
            raise ValueError(
                f"shard_index {shard_index} out of range for "
                f"{num_shards} shards"
            )
        os.makedirs(out_dir, exist_ok=True)
        # stems from the FULL list: deterministic + collision-free across
        # shards, regardless of which slice this host processes
        self._stems = self._out_names(list(wav_paths))
        self._true_lens = {}  # reset per run (pre-pad lengths, honest RTF)
        suffix = (
            f".shard{shard_index}of{num_shards}" if num_shards > 1 else ""
        )
        wav_paths = list(wav_paths)[shard_index::num_shards]
        self._stats_path = os.path.join(
            out_dir, f"feature_stats{suffix}.json"
        )
        manifest_path = os.path.join(out_dir, f"manifest{suffix}.jsonl")
        done = set()
        if resume and os.path.exists(manifest_path):
            with open(manifest_path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("status") == "ok":
                        done.add(rec["path"])
        todo = [p for p in wav_paths if p not in done]

        stats = CorpusStats()
        # per-mel-band moments accumulate ON DEVICE (float32) batch by batch
        # -- per-batch downloads of the three tiny arrays would each pay the
        # link's fixed round trip -- and fold into a float64 host accumulator
        # every _MOMENTS_FOLD batches so corpus-scale sums keep f64 precision
        # (a pure-f32 running sum would saturate count past 2^24 steps)
        self._moments_dev = None
        self._moments_host = None
        self._moments_pending = 0
        # resume correctness for the corpus-wide stats: the moments of the
        # already-done files live only in the previously written stats file.
        # Seed the accumulator from its raw f64 moments; if files are done
        # but no usable stats exist (e.g. the prior run crashed before
        # writing them), the rewritten stats would cover only this run's
        # files -- mark them partial so consumers can't mistake them for
        # corpus-wide statistics.
        self._stats_partial = False
        self._stats_covered = 0  # ok-files whose moments the accumulator holds
        if done and self.env.feature_stats:
            prior = None
            if os.path.exists(self._stats_path):
                try:
                    with open(self._stats_path) as f:
                        prior = json.load(f)
                except (OSError, json.JSONDecodeError):
                    prior = None
            # the prior moments are only usable when they cover EXACTLY the
            # resumed 'ok' set: an intervening run may have completed more
            # files (flushed to the manifest) and then crashed before the
            # stats rewrite, leaving a stale-but-unmarked stats file whose
            # moments silently miss those files. files_covered pins this.
            if (
                prior and "mel_sum" in prior and not prior.get("partial")
                and prior.get("files_covered") == len(done)
            ):
                self._moments_host = {
                    "sum": np.asarray(prior["mel_sum"], dtype=np.float64),
                    "sumsq": np.asarray(
                        prior["mel_sumsq"], dtype=np.float64
                    ),
                    "count": np.float64(prior["count_steps"]),
                }
                self._stats_covered = len(done)
            else:
                self._stats_partial = True
        t0 = time.perf_counter()

        # stage queues: decoded items in, dispatched batches out
        dq: queue.Queue = queue.Queue(maxsize=max(4 * self.batch_size, 64))
        wq: queue.Queue = queue.Queue(maxsize=self.pipeline_depth)
        failures: List[BaseException] = []

        def decode_worker():
            try:
                for rec in self._decode_many(todo):
                    dq.put(rec)
            except BaseException as e:  # noqa: BLE001
                failures.append(e)
            finally:
                dq.put(_SENTINEL)

        # one dedicated download thread: the device->host link moves fastest
        # on a single serial stream (concurrent copies fragment it), so the
        # downloader drains batches in order at full link speed and hands the
        # host arrays to the pool, which does npz/manifest writes without
        # ever stalling the stream; manifest/stats/moments guarded by a lock
        manifest = open(manifest_path, "a")
        manifest_lock = threading.Lock()
        pool = ThreadPoolExecutor(max(self.decode_threads, 4))
        write_futures: List = []
        # bounded download->write handoff: the executor's internal queue is
        # unbounded, and each queued write_batch closure pins a whole
        # batch's host feature arrays -- on a slow out_dir (NFS, throttled
        # disk) that grows RSS without bound. The downloader blocks here,
        # which propagates backpressure up through wq to dispatch.
        self._write_slots = threading.BoundedSemaphore(
            max(2 * self.pipeline_depth, 4)
        )

        def write_worker():
            while True:
                entry = wq.get()
                if entry is _SENTINEL:
                    return
                if failures:
                    continue  # drain so producers never block
                try:
                    self._write_entry(
                        entry, out_dir, manifest, manifest_lock, stats, pool,
                        write_futures,
                    )
                except BaseException as e:  # noqa: BLE001
                    failures.append(e)

        dec_t = threading.Thread(target=decode_worker, name="corpus-decode")
        wrt_t = threading.Thread(target=write_worker, name="corpus-download")
        dec_t.start()
        wrt_t.start()
        try:
            buckets: Dict[Tuple[int, bool], List[Tuple]] = {}
            while True:
                rec = dq.get()
                if rec is _SENTINEL:
                    break
                if failures:
                    # a downstream stage (writer/download) already failed:
                    # stop dispatching NOW instead of burning device compute
                    # and decode on the whole remaining corpus just to
                    # discard it when the error finally re-raises
                    break
                path, sig, div, err = rec
                if err is not None:
                    wq.put(("error", path, err))
                    continue
                blen = bucket_length(
                    len(sig), self.env.timing, quantum=self._bucket_quantum
                )
                key = (blen, div is not None)
                buckets.setdefault(key, []).append((path, sig, div))
                if len(buckets[key]) >= self.batch_size:
                    wq.put(self._dispatch(buckets.pop(key), blen, add_ms))
            if not failures:
                for (blen, _), items in list(buckets.items()):
                    wq.put(self._dispatch(items, blen, add_ms))
        except BaseException as e:  # noqa: BLE001
            failures.append(e)
        finally:
            wq.put(_SENTINEL)
            # the decode thread may be blocked on a full dq (e.g. when
            # dispatch raised); drain until it exits so join() cannot hang
            while dec_t.is_alive():
                try:
                    dq.get(timeout=0.05)
                except queue.Empty:
                    pass
            dec_t.join()
            wrt_t.join()
            for fut in write_futures:
                try:
                    fut.result()
                except BaseException as e:  # noqa: BLE001
                    failures.append(e)
            pool.shutdown(wait=True)
            manifest.close()
        if failures:
            raise failures[0]

        self._fold_moments_to_host()
        if (
            self.env.feature_stats
            and self._moments_host is None
            and not self._stats_partial
            and not done
        ):
            # a shard that processed no files (empty slice, or every file
            # failed) must still write its stats shard: zero moments merge
            # exactly, and merge_shards enforces a COMPLETE 0..N-1 set --
            # a missing file would fail the whole multi-host merge. Gate
            # on THIS RUN's state (`done` empty), not on file existence:
            # a no-resume rerun of a now-empty shard legitimately owns
            # the path and must OVERWRITE any stale prior moments (which
            # would otherwise silently join the merge). The resumed
            # done-but-unusable-stats case is _stats_partial, excluded
            # above.
            nf = self.env.cfg.mel.fbank.n_filters
            self._moments_host = {
                "sum": np.zeros(nf, dtype=np.float64),
                "sumsq": np.zeros(nf, dtype=np.float64),
                "count": np.float64(0.0),
            }
        if self.env.feature_stats and self._moments_host is not None:
            # corpus-wide per-mel-band normalization statistics
            moments = self._moments_host
            cnt = max(float(moments["count"]), 1.0)
            mean = moments["sum"] / cnt
            var = np.maximum(moments["sumsq"] / cnt - mean**2, 0.0)
            payload = {
                "mel_mean": mean.tolist(),
                "mel_std": np.sqrt(var).tolist(),
                # the TRUE step count (not the divide clamp): an empty
                # shard must contribute 0 to the merged corpus count
                "count_steps": float(moments["count"]),
                # raw f64 moments so shard files merge exactly (and so a
                # resumed run can seed its accumulator)
                "mel_sum": moments["sum"].tolist(),
                "mel_sumsq": moments["sumsq"].tolist(),
                # how many ok files these moments cover: the resume seed
                # refuses a prior stats file whose coverage doesn't match
                # the manifest's ok set exactly
                "files_covered": self._stats_covered + stats.files_done,
            }
            if self._stats_partial:
                payload["partial"] = True  # resumed without prior moments:
                # covers only this run's files, NOT the whole corpus
            with open(self._stats_path, "w") as f:
                json.dump(payload, f)
        elif (
            self.env.feature_stats
            and self._stats_partial
            and os.path.exists(self._stats_path)
        ):
            # the resume seed REFUSED the prior stats (coverage mismatch)
            # and this run produced no new moments (empty todo): without a
            # rewrite the stale, unmarked file would survive and be
            # mistaken for corpus-wide statistics -- stamp it partial in
            # place so consumers refuse it too
            try:
                with open(self._stats_path) as f:
                    prior = json.load(f)
            except (OSError, json.JSONDecodeError):
                prior = {}
            prior["partial"] = True
            with open(self._stats_path, "w") as f:
                json.dump(prior, f)
        stats.wall_seconds = time.perf_counter() - t0
        return stats

    def iter_device_features(
        self,
        wav_paths: Sequence[str],
        add_ms: int = 0,
    ):
        """Device-resident corpus handoff: stream the corpus through the
        batched device pipeline and yield per-batch DEVICE arrays — no
        packing, no device→host copy, no npz round trip (`run()` +
        :class:`FeatureDataset` pays the D2H copy and the read-back when
        the consumer is a JAX training loop on the same device; this path
        pays neither — features go corpus → HBM → consumer jit).

        Yields ``(paths, outputs, seg_valid, n_segs)`` per length bucket:
        ``outputs`` is a :class:`SndEnvOutputs` of jax device arrays with
        leading ``[B, seg]`` axes (the runner's ``save_keys`` selection,
        deduped-mel disabled — there is no link to save bytes on),
        ``seg_valid`` is the ``[B, seg]`` device validity mask and
        ``n_segs`` the per-file host segment counts. Decode errors raise
        (there is no manifest to record them in); audio decode runs on the
        native threaded decoder and overlaps device compute exactly like
        ``run()``'s decode stage. Feature-stats moments are not accumulated.

        Replaces the reference's materialize-then-train file loop
        (sound/sndenv.go:342 → emergent table inputs) for same-device
        consumers; see ``examples/train_phone_classifier.py --features
        device``.
        """
        if self._batched_dev is None:
            env = SndEnv(
                self.env.cfg, self.sample_rate, dtype=self.env.dtype,
                outputs=self.save_keys, feature_stats=False,
                matmul_precision=self.env.matmul_precision,
                # mirror the runner's frontend selection: a frontend A/B
                # probe through the device-resident path must measure the
                # frontend the runner was constructed with
                spectrum_method=self.env.spectrum_method,
                segment_frontend=self.env.segment_frontend,
            )
            self._batched_dev = BatchedSndEnv(
                env, mesh=self.batched.mesh,
            )
        benv = self._batched_dev

        def flush(items, blen):
            signals, lengths, divisors, n_segs = self._assemble_batch(
                items, blen
            )
            out, seg_valid = benv.process(
                signals, lengths, add_ms, divisors=divisors
            )
            return [p for p, _, _ in items], out, seg_valid, n_segs

        buckets: Dict[Tuple[int, bool], List[Tuple]] = {}
        for path, sig, div, err in self._decode_many(list(wav_paths)):
            if err is not None:
                raise RuntimeError(f"decode failed for {path}: {err}")
            blen = bucket_length(
                len(sig), self.env.timing, quantum=self._bucket_quantum
            )
            key = (blen, div is not None)
            buckets.setdefault(key, []).append((path, sig, div))
            if len(buckets[key]) >= self.batch_size:
                yield flush(buckets.pop(key), blen)
        for (blen, _), items in list(buckets.items()):
            yield flush(items, blen)

    @staticmethod
    def merge_shards(out_dir: str) -> Dict[str, Any]:
        """Combine per-shard outputs of a multi-host run (see :meth:`run`)
        into the single-run artifacts: concatenates ``manifest.shard*``
        records into ``manifest.jsonl`` and sums the shards' raw f64 moment
        vectors into ``feature_stats.json`` (exact -- moments are additive).
        Returns a summary dict."""
        import glob as _glob
        import re

        def shard_set(pattern, regex):
            """Collect {index: path}, enforcing ONE complete 0..N-1 set --
            a stale mixed-generation file (different N) or a missing shard
            would silently corrupt the merged stats otherwise."""
            found = {}
            ns = set()
            for p in sorted(_glob.glob(os.path.join(out_dir, pattern))):
                m = re.fullmatch(regex, os.path.basename(p))
                if not m:
                    continue
                i, n = int(m.group(1)), int(m.group(2))
                ns.add(n)
                found[i] = p  # (i, n) is unique: it IS the filename
            if not found:
                return None, {}
            if len(ns) != 1:
                raise ValueError(
                    f"mixed shard generations in {out_dir}: found files "
                    f"for N in {sorted(ns)}; remove the stale set first"
                )
            n = ns.pop()
            missing = set(range(n)) - set(found)
            if missing:
                raise ValueError(
                    f"incomplete shard set in {out_dir}: missing shard "
                    f"indices {sorted(missing)} of {n} (is a host still "
                    "running?)"
                )
            return n, found

        n_man, man_shards = shard_set(
            "manifest.shard*.jsonl", r"manifest\.shard(\d+)of(\d+)\.jsonl"
        )
        if not man_shards:
            raise FileNotFoundError(
                f"no manifest.shard*.jsonl files in {out_dir}"
            )
        # last record per path wins (a resumed shard appends duplicates)
        by_path: Dict[str, str] = {}
        for i in sorted(man_shards):
            with open(man_shards[i]) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if "path" in rec:
                        by_path[rec["path"]] = line
        n_ok = n_err = 0
        with open(os.path.join(out_dir, "manifest.jsonl"), "w") as out:
            for line in by_path.values():
                rec = json.loads(line)
                n_ok += rec.get("status") == "ok"
                n_err += rec.get("status") == "error"
                out.write(line + "\n")

        n_stat, stat_map = shard_set(
            "feature_stats.shard*.json",
            r"feature_stats\.shard(\d+)of(\d+)\.json",
        )
        if stat_map and n_stat != n_man:
            raise ValueError(
                f"feature_stats shard count ({n_stat}) does not match the "
                f"manifest shard count ({n_man})"
            )
        stat_shards = [stat_map[i] for i in sorted(stat_map)]
        merged_stats = None
        if stat_shards:
            tot_sum = tot_sq = None
            tot_cnt = 0.0
            tot_cov = 0
            for sp in stat_shards:
                with open(sp) as f:
                    s = json.load(f)
                if "mel_sum" not in s:
                    raise ValueError(
                        f"{sp} lacks raw moments (mel_sum); re-run the "
                        "shard with this version to enable merging"
                    )
                if s.get("partial"):
                    raise ValueError(
                        f"{sp} is marked partial (a resumed run without "
                        "prior moments); re-run that shard without resume "
                        "to get corpus-wide statistics"
                    )
                ssum = np.asarray(s["mel_sum"], dtype=np.float64)
                ssq = np.asarray(s["mel_sumsq"], dtype=np.float64)
                tot_sum = ssum if tot_sum is None else tot_sum + ssum
                tot_sq = ssq if tot_sq is None else tot_sq + ssq
                tot_cnt += float(s["count_steps"])
                tot_cov += int(s.get("files_covered", 0))
            cnt = max(tot_cnt, 1.0)
            mean = tot_sum / cnt
            var = np.maximum(tot_sq / cnt - mean**2, 0.0)
            merged_stats = {
                "mel_mean": mean.tolist(),
                "mel_std": np.sqrt(var).tolist(),
                # the TRUE total (cnt is only the divide clamp): an
                # all-empty merge must report 0, matching the shard files
                "count_steps": tot_cnt,
                "mel_sum": tot_sum.tolist(),
                "mel_sumsq": tot_sq.tolist(),
                "files_covered": tot_cov,
            }
            with open(os.path.join(out_dir, "feature_stats.json"), "w") as f:
                json.dump(merged_stats, f)
        return {
            "manifest_shards": len(man_shards),
            "stats_shards": len(stat_shards),
            "files_ok": n_ok,
            "files_failed": n_err,
        }

    def run_distributed(
        self,
        wav_paths: Sequence[str],
        out_dir: str,
        resume: bool = True,
        add_ms: int = 0,
    ) -> Tuple[CorpusStats, Optional[Dict[str, Any]]]:
        """Multi-process corpus extraction under ``jax.distributed``: this
        process runs the deterministic interleaved file shard
        ``wav_paths[jax.process_index()::jax.process_count()]`` (decode/
        compute/write fully local -- the corpus is pointwise per utterance,
        so scale-out needs no hot-path collectives), every process
        barriers, and rank 0 merges the per-shard manifests and raw f64
        feature-stat moments into the single-run artifacts
        (:meth:`merge_shards`; moment sums add exactly, so the merged
        corpus statistics equal a single-process run's).

        ``out_dir`` must be a shared filesystem path (every process writes
        its shard's ``.npz``/manifest there). Returns
        ``(local CorpusStats, merge summary on rank 0 else None)``.
        """
        import jax as _jax

        from ..parallel.distributed import barrier

        pid, nproc = _jax.process_index(), _jax.process_count()
        if nproc == 1:
            # single process: run() writes the unsuffixed artifacts
            # directly; nothing to merge
            return self.run(wav_paths, out_dir, resume=resume,
                            add_ms=add_ms), None
        # guard: every process must pass the SAME ordered path list -- a
        # drifted glob on one host would silently mis-shard (files double-
        # processed or skipped) and corrupt the merged stats. Compare a
        # digest across processes before any work starts.
        import hashlib

        from jax.experimental import multihost_utils

        digest = hashlib.sha256(
            "\n".join(wav_paths).encode()
        ).digest()[:8]
        mine = np.frombuffer(digest, dtype=np.int64)
        allv = np.asarray(multihost_utils.process_allgather(mine))
        if not (allv == allv[0]).all():
            raise ValueError(
                "run_distributed: wav_paths differ across processes "
                "(path-list digests disagree); every process must pass "
                "the same ordered list"
            )
        stats = self.run(
            wav_paths, out_dir, resume=resume, add_ms=add_ms,
            shard_index=pid, num_shards=nproc,
        )
        barrier("corpus_run_distributed")
        summary = None
        if pid == 0:
            summary = self.merge_shards(out_dir)
        # second barrier: no process returns (and possibly reads merged
        # artifacts or exits) until rank 0 has finished writing them
        barrier("corpus_merge_distributed")
        return stats, summary

    # batches per f32 device partial before an f64 host fold: 64 batches of
    # <=2^18 steps each stay far below f32's 2^24 integer-precision limit
    _MOMENTS_FOLD = 64

    def _fold_moments_to_host(self):
        """Fold the device f32 moment partial into the f64 host accumulator
        (one tiny download per _MOMENTS_FOLD batches)."""
        if self._moments_dev is None:
            return
        part = {
            k: np.asarray(v, dtype=np.float64)
            for k, v in self._moments_dev.items()
        }
        if self._moments_host is None:
            self._moments_host = part
        else:
            self._moments_host = {
                k: self._moments_host[k] + part[k] for k in part
            }
        self._moments_dev = None
        self._moments_pending = 0

    def _assemble_batch(self, items, blen):
        """Pack decoded (path, signal, divisor) items into the padded batch
        arrays (int16 tier when the decoder produced raw int16) plus the
        host-computable per-file segment counts (sndenv.go:263-265). Shared
        by :meth:`_dispatch` and :meth:`iter_device_features`."""
        int16_mode = items[0][2] is not None
        signals = np.zeros(
            (len(items), blen), dtype=np.int16 if int16_mode else np.float32
        )
        lengths = np.zeros(len(items), dtype=np.int32)
        divisors = np.ones(len(items), dtype=np.float32) if int16_mode else None
        for i, (_, sig, div) in enumerate(items):
            signals[i, : len(sig)] = sig
            lengths[i] = len(sig)
            if int16_mode:
                divisors[i] = div
        n_segs = [max(self.env.seg_cnt(int(n)), 0) for n in lengths]
        return signals, lengths, divisors, n_segs

    def _dispatch(self, items, blen, add_ms):
        """Build the padded batch and *dispatch* it (asynchronously) to the
        device; returns the entry the writer thread will block on."""
        signals, lengths, divisors, n_segs = self._assemble_batch(items, blen)
        res = self.batched.process(signals, lengths, add_ms, divisors=divisors)
        # trim the packed buffer to the batch max (quantized so distinct
        # slice shapes stay few and compile-cached) before it is downloaded
        packed = res[0]
        seg_full = max(self.env.seg_cnt(blen), 0)
        if isinstance(packed, PackedBatch):
            max_seg = min(
                pad_to_multiple(max(n_segs) if n_segs else 0, 4), seg_full
            )
            res = (packed.trim(max_seg),) + tuple(res[1:])
        # host expansion metadata for the deduped mel (cached per bucket)
        grid = None
        if self._dedup_mel:
            gkey = (blen, add_ms)
            if gkey not in self._grid_cache:
                self._grid_cache[gkey] = self.env.global_grid(blen, add_ms)
            grid = self._grid_cache[gkey]
        return ("batch", res, items, n_segs, grid)

    def _write_entry(
        self, entry, out_dir, manifest, manifest_lock, stats, pool,
        write_futures,
    ):
        """Download-stage handler: block on one dispatched batch, copy it to
        host on this (single) thread -- one serial copy stream -- then hand the host arrays to the pool for npz/manifest
        writes so the next batch's download starts immediately."""
        if entry[0] == "error":
            _, path, err = entry
            with manifest_lock:
                stats.files_failed += 1
                manifest.write(
                    json.dumps({"path": path, "status": "error", "error": err})
                    + "\n"
                )
            return
        _, res, items, n_segs, grid = entry
        packed = res[0]
        if len(res) > 1 and res[1] is not None:
            # device-side accumulation (no per-batch host copy), folded to
            # the f64 host accumulator every _MOMENTS_FOLD batches
            mom = res[1]
            with manifest_lock:
                self._moments_dev = (
                    mom
                    if self._moments_dev is None
                    else jax.tree_util.tree_map(
                        jnp.add, self._moments_dev, mom
                    )
                )
                self._moments_pending += 1
                if self._moments_pending >= self._MOMENTS_FOLD:
                    self._fold_moments_to_host()
        # ONE device->host copy for the whole batch
        host = packed.unpack()

        def write_batch():
            # the dedup-mel expansion runs HERE, on the write pool: on the
            # download thread it would serialize tens of MB of host compute
            # into the D2H stream this stage exists to keep busy (the next
            # batch's copy couldn't start until the expansion finished)
            if grid is not None and "mel_fbank_global" in host:
                # expand the deduped global-grid mel to the reference's
                # per-segment tensor and re-apply the step/segment masks the
                # device path would have applied (SndEnv.global_grid
                # contract)
                map_idx, win_ends = grid
                if "mel_fbank_global" in self.save_keys:
                    mg = host["mel_fbank_global"]  # user wants the raw grid
                else:
                    mg = host.pop("mel_fbank_global")  # [B, n_flat_t, n_mel]
                seg_t = min(
                    (mg.shape[1] - packed.steps) // packed.sps + 1
                    if mg.shape[1] >= packed.steps else 0,
                    map_idx.shape[0],
                )
                mi = map_idx[:seg_t]
                # [B, seg_t, steps, n_mel] -> [B, seg_t, n_mel, steps]
                exp = mg[:, mi].transpose(0, 1, 3, 2)
                lens = np.asarray([len(sig) for _, sig, _ in items])
                valid = (
                    win_ends[None, :seg_t, :] <= lens[:, None, None]
                )  # [B, seg_t, steps]
                # where (not multiply): the mel NaN-triangle quirk means
                # masked values can be NaN, and NaN*0 != 0
                host["mel_fbank_segment"] = np.where(
                    valid[:, :, None, :], exp, exp.dtype.type(0)
                )

            def write_one(i_path_sig):
                i, path, n_audio = i_path_sig
                n_seg = n_segs[i]
                rec = {}
                for k, v in host.items():
                    if k == "mel_fbank_global":
                        # global-grid rows are windows, not segments: trim
                        # to this file's own global window count
                        rows = (
                            (n_seg - 1) * packed.sps + packed.steps
                            if n_seg > 0 else 0
                        )
                    else:
                        rows = n_seg
                    rec[k] = v[i][:rows]
                stem = self._stems.get(
                    path, os.path.splitext(os.path.basename(path))[0]
                )
                np.savez(os.path.join(out_dir, stem + ".npz"), **rec)
                return path, n_audio

            # true (pre-pad) audio lengths for the stats: len(sig) here is
            # the PADDED length (_decode pads), which would inflate the
            # reported corpus RTF by the pad fraction (up to +9% on 1 s
            # utterances at 16 kHz defaults)
            jobs = [
                (i, path, self._true_lens.get(path, len(sig)))
                for i, (path, sig, _) in enumerate(items)
            ]
            results = [write_one(j) for j in jobs]
            with manifest_lock:
                for path, n_audio in results:
                    manifest.write(
                        json.dumps({"path": path, "status": "ok"}) + "\n"
                    )
                    stats.files_done += 1
                    stats.audio_seconds += n_audio / self.sample_rate
                manifest.flush()

        self._write_slots.acquire()  # bounded handoff (see run())

        def bounded_write():
            try:
                write_batch()
            finally:
                self._write_slots.release()

        write_futures.append(pool.submit(bounded_write))
