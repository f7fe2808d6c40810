"""Shared plumbing for the CLI entry points."""

import time

import jax
import jax.numpy as jnp
import numpy as np


def compute_dtype(mixed_precision: bool, device: str):
    """bfloat16 under mixed precision (the reference used fp16 on GPUs,
    run/train.py:63-67; bf16 keeps float32's exponent range, so no loss
    scaling is needed)."""
    return jnp.bfloat16 if mixed_precision else jnp.float32


def create_model(model_config, dtype):
    """Instantiate the model definition with the compute dtype."""
    model = model_config.create_model()
    if dtype != jnp.float32:
        model = model.clone(dtype=dtype)
    return model


def build_variables(model, model_config, data_config, rng, audio_len=64, token_len=8):
    """Initialize model variables with tiny static shapes.

    Keeps only the persistent collections ({'params', 'batch_stats'}) —
    init also materializes transient sown collections (e.g. the MoE
    'aux_loss', models/moe.py) that checkpoints never contain, and the
    restore template must match the checkpoint structure."""
    from ..models import LAS, Transducer

    audio = jnp.zeros((1, audio_len, data_config.frequency_dim, data_config.feature_dim), jnp.float32)
    if isinstance(model, (LAS, Transducer)):
        tokens = jnp.zeros((1, token_len), jnp.int32)
        variables = model.init({"params": rng}, (audio, tokens))
    else:
        variables = model.init({"params": rng}, audio)
    return {k: variables[k] for k in ("params", "batch_stats") if k in variables}


def pipelined_decode(batches, decode_fn, depth=2):
    """Software-pipeline device decode against host materialization.

    JAX dispatch is asynchronous: keeping ``depth`` decode calls in flight
    overlaps each call's host dispatch work with the device execution of the
    previous call. The reference got the same overlap from Keras
    ``predict``'s internal prefetch queue (reference run/evaluate.py:79-84).

    ``batches`` yields ``(audio, *rest)``; ``decode_fn(audio)`` must return a
    device array. Yields ``(np_output, *rest)`` in input order.
    """
    from collections import deque

    inflight = deque()
    for audio, *rest in batches:
        inflight.append((decode_fn(audio), rest))
        if len(inflight) >= depth:
            out, r = inflight.popleft()
            yield (np.asarray(out), *r)
    while inflight:
        out, r = inflight.popleft()
        yield (np.asarray(out), *r)


def batch_audio_seconds(audio, n_valid: int, data_config, raw_mode: bool) -> float:
    """Seconds of real audio in the first ``n_valid`` rows of a padded batch:
    raw ``(pcm, lengths)`` batches count samples, feature batches count
    frames up to the last non-zero one (pad frames are exactly zero)."""
    if raw_mode:
        return float(np.sum(audio[1][:n_valid])) / data_config.sample_rate
    feats = np.asarray(audio[:n_valid], np.float32).reshape(n_valid, audio.shape[1], -1)
    nonzero = np.any(feats != 0.0, axis=2)
    frames = np.where(nonzero.any(axis=1), nonzero.shape[1] - np.argmax(nonzero[:, ::-1], axis=1), 0)
    samples = np.where(frames > 0, (frames - 1) * data_config.frame_step + data_config.frame_length, 0)
    return float(np.sum(samples)) / data_config.sample_rate


def timed_decode(batches, decode_fn, data_config, raw_mode: bool, logger):
    """``pipelined_decode`` that logs the real-time factor when it ends:
    decode wall time over seconds of audio, overall and after the first
    batch (which carries the compilation)."""
    seconds = []

    def _count():
        for batch in batches:
            seconds.append(batch_audio_seconds(batch[0], batch[-1], data_config, raw_mode))
            yield batch

    start = time.perf_counter()
    stamps = []
    for item in pipelined_decode(_count(), decode_fn):
        stamps.append(time.perf_counter())
        yield item
    if not stamps or not sum(seconds):
        return
    total = stamps[-1] - start
    msg = (f"[+] Decoded {sum(seconds):.2f} s of audio in {len(stamps)} batches, {total:.3f} s: "
           f"RTF {total / sum(seconds):.6f}")
    if len(stamps) > 1 and sum(seconds[1:]):
        msg += f"; after the first batch: RTF {(stamps[-1] - stamps[0]) / sum(seconds[1:]):.6f}"
    logger.info(msg)


def decode_pad_lengths(data_config, device: str):
    """(audio, token) pad lengths for the decode CLIs: the config's static
    maxima on the accelerator (one compiled decode program); None elsewhere,
    where batches pad to bounded quantized shapes instead."""
    from ..backend import on_accelerator

    if on_accelerator(device):
        return data_config.max_audio_length, data_config.max_token_length
    return None, None


def use_raw_frontend(on_device_frontend, device: str, use_tfrecord: bool) -> bool:
    """Resolve the on-device-frontend tri-state for the decode CLIs: None =
    auto (ON for accelerator tsv runs — same default as TrainConfig);
    explicit True/False from the flag always wins.  TFRecords hold
    pre-computed features, so raw mode never applies there."""
    from ..backend import on_accelerator

    if use_tfrecord:
        return False
    if on_device_frontend is None:
        return on_accelerator(device)
    return bool(on_device_frontend)


def frontend_decode_fn(data_config, decode_fn):
    """Wrap a feature-domain ``decode_fn`` for raw ``(audio, lengths)``
    batches: the fused on-device frontend (ops/frontend.py) runs as its own
    jit feeding the decode call — both dispatches are asynchronous, so the
    pipelining in ``pipelined_decode`` is preserved.  Pad frames come out
    exactly zero (frontend contract), which is what the models' masks key
    on; SpecAugment is off at decode time so zero-detection is exact."""
    from ..ops.frontend import make_batch_frontend

    frontend = make_batch_frontend(data_config, spec_augment=False)

    def _fn(batch):
        audio, lengths = batch
        feats, _ = frontend(audio, lengths)
        return decode_fn(feats)

    return _fn


def sharded_decode_fn(decode_fn, batch_size: int):
    """SPMD decode for the evaluate/inference CLIs: shard each batch's rows
    over a ('data',) mesh when more than one device is visible and the batch
    divides.  Returns ``(wrapped_fn, mesh_or_None)``.

    The jitted search loops are batch-parallel, so XLA partitions them over
    the batch axis exactly like the train step.  Replaces what Keras ``predict`` under a
    distribution strategy did for the reference (reference
    run/evaluate.py:79-84 with utils.py:130-156).
    """
    from ..parallel import get_device_mesh, shard_batch

    n = len(jax.devices())
    dp = 1
    for d in range(min(n, batch_size), 0, -1):
        if batch_size % d == 0:
            dp = d
            break
    if dp <= 1:
        return decode_fn, None
    mesh = get_device_mesh(data_parallel=dp, model_parallel=1)

    def _fn(batch):
        return decode_fn(shard_batch(batch, mesh))

    return _fn, mesh


def round_up(value: int, multiple: int) -> int:
    return ((value + multiple - 1) // multiple) * multiple


def count_params(variables) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(variables.get("params", {})))
