"""Fused on-device batch frontend: raw PCM -> model-ready features in one jit.

The reference computed features per-example on the host inside tf.data
(reference: run/train.py:70-116).  Accelerator alternative: ship padded raw
audio [B, num_samples] to the device and compute framing -> STFT -> log-mel /
MFCC -> SpecAugment -> delta-accelerate for the whole batch inside the train
step's jit.  The mel projection and MFCC DCT are batched matmuls;
XLA fuses the elementwise chain; the host pipeline is left with nothing but
decode + tokenize.

Padding correctness: features at frames beyond each utterance's valid length
are forced to exactly 0.0 so the models' pad-detection masks
(models/las.py audio_frame_mask) see the same zero-padding the host
per-example path produces.
"""

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..configs import DataConfig
from . import features as F
from .spec_augment import make_spec_augment


def make_batch_frontend(config: DataConfig, spec_augment: bool = False):
    """Build fn(audio [B, S], sample_lengths [B], key?) -> ([B, T, F, C], frame_lengths [B]).

    T = (max_samples - frame_length) // frame_step + 1 (static).  The true
    per-utterance frame counts are returned so models mask from them instead
    of re-deriving lengths by zero detection (SpecAugment time masks zero
    whole interior frames, which breaks zero detection).
    """
    feature_fn = config.make_audio_feature_fn("jax")
    sa_fn = None
    if spec_augment and config.spec_augment.enable:
        sa = config.spec_augment
        sa_fn = make_spec_augment(
            v=config.frequency_dim, W=sa.W, F=sa.F, m_F=sa.m_F, T=sa.T, p=sa.p, m_T=sa.m_T
        )

    frame_length, frame_step = config.frame_length, config.frame_step

    def frontend(audio: jnp.ndarray, sample_lengths: jnp.ndarray, key: Optional[jax.Array] = None):
        feats = jax.vmap(feature_fn)(audio)  # [B, T, F, 1]
        num_frames = feats.shape[1]
        # frames fully inside the valid samples: (len - frame_length)//step + 1
        valid = jnp.maximum((sample_lengths - frame_length) // frame_step + 1, 0)
        frame_mask = jnp.arange(num_frames)[None, :] < valid[:, None]
        feats = feats * frame_mask[:, :, None, None].astype(feats.dtype)

        if sa_fn is not None and key is not None:
            keys = jax.random.split(key, feats.shape[0])
            feats = jax.vmap(sa_fn)(keys, feats)
            feats = feats * frame_mask[:, :, None, None].astype(feats.dtype)

        if config.use_delta_accelerate:
            feats = jax.vmap(F.delta_accelerate)(feats)
            # delta at the first pad frame leaks a nonzero value; re-zero pads
            feats = feats * frame_mask[:, :, None, None].astype(feats.dtype)
        return feats, valid

    return jax.jit(frontend)


def make_sp_batch_frontend(
    config: DataConfig,
    mesh,
    seq_axis: str = "model",
    data_axis: Optional[str] = None,
    spec_augment: bool = False,
):
    """Sequence-parallel variant of :func:`make_batch_frontend`.

    The sample -> feature chain (framing, matmul STFT, mel/MFCC — the FLOPs)
    computes time-sharded over the mesh's ``seq_axis`` with a one-ppermute
    sample halo (``parallel/sequence.py``): on a tensor-parallel mesh the
    ``model`` axis participates in the frontend instead of idling through
    it.  SpecAugment masks and delta-accelerate stay on the assembled
    features (cheap elementwise; XLA re-shards as needed).  Identical
    output contract and numerics to the base frontend
    (``tests/test_sequence_parallel.py`` pins exact equality).

    Requires ``frame_length % frame_step == 0`` (all shipped configs:
    320/160) so each shard owns whole step-blocks.
    """
    from ..parallel.sequence import time_sharded

    fl, fs = config.frame_length, config.frame_step
    if fl % fs:
        raise ValueError("sequence-parallel frontend requires frame_length % frame_step == 0")
    n = mesh.shape[seq_axis]
    halo = fl - fs
    feature_fn = config.make_audio_feature_fn("jax")
    sa_fn = None
    if spec_augment and config.spec_augment.enable:
        sa = config.spec_augment
        sa_fn = make_spec_augment(
            v=config.frequency_dim, W=sa.W, F=sa.F, m_F=sa.m_F, T=sa.T, p=sa.p, m_T=sa.m_T
        )

    sp_features = time_sharded(
        lambda a: jax.vmap(feature_fn)(a),
        mesh,
        seq_axis,
        time_axis=1,
        halo_right=halo,
        data_axis=data_axis,
    )

    def frontend(audio: jnp.ndarray, sample_lengths: jnp.ndarray, key: Optional[jax.Array] = None):
        B, S = audio.shape
        num_frames = (S - fl) // fs + 1
        # pad so every shard owns an equal whole number of step blocks; the
        # spurious tail frames (zero-halo windows past the signal) are
        # sliced off after assembly
        blocks = -(-S // fs)
        blocks_pad = -(-blocks // n) * n
        if blocks_pad * fs != S:
            audio = jnp.pad(audio, ((0, 0), (0, blocks_pad * fs - S)))
        feats = sp_features(audio)[:, :num_frames]

        valid = jnp.maximum((sample_lengths - fl) // fs + 1, 0)
        frame_mask = jnp.arange(num_frames)[None, :] < valid[:, None]
        feats = feats * frame_mask[:, :, None, None].astype(feats.dtype)

        if sa_fn is not None and key is not None:
            keys = jax.random.split(key, feats.shape[0])
            feats = jax.vmap(sa_fn)(keys, feats)
            feats = feats * frame_mask[:, :, None, None].astype(feats.dtype)

        if config.use_delta_accelerate:
            feats = jax.vmap(F.delta_accelerate)(feats)
            feats = feats * frame_mask[:, :, None, None].astype(feats.dtype)
        return feats, valid

    return jax.jit(frontend)


def pad_audio_batch(audios, max_samples: int):
    """Host helper: stack raw 1-D audios -> ([B, max_samples] f32, lengths [B])."""
    lengths = np.array([min(len(a), max_samples) for a in audios], np.int32)
    out = np.zeros((len(audios), max_samples), np.float32)
    for i, a in enumerate(audios):
        out[i, : lengths[i]] = a[: lengths[i]]
    return out, lengths
