"""Conformer-CTC model family (beyond reference parity).

The reference framework ships exactly two model families — LAS and
DeepSpeech2 (reference speech_recognition/configs/model_config.py:20-36).
This adds a third, the Conformer encoder (Gulati et al. 2020,
arXiv:2005.08100) with a CTC head, because its compute profile suits a
matrix accelerator: every hot op is a large batched matmul (QKV
projections, attention einsums, 4x-expansion feed-forwards, pointwise
convs), there is no sequential recurrence, and the whole forward is one
fused XLA graph with static shapes.

It plugs into the existing CTC infrastructure unchanged:
- loss: ``measure.ctc_loss`` (same contract as DeepSpeech2);
- decoding: ``search.DeepSpeechSearcher`` (greedy / prefix-beam, on device);
- batching/example semantics identical to DS2 (reference
  deepspeech2.py:186-202).

Deviations from the paper, chosen for static shapes and exact masking:
- relative positional encoding is RoPE (rotary) instead of Transformer-XL
  relative attention — parameter-free, two elementwise rotations, no extra
  [T, T] gather, and still strictly relative (q_i . k_j depends on i-j);
- the convolution module normalizes with LayerNorm instead of BatchNorm so
  padding frames can never pollute batch statistics and padded batches are
  bit-invariant on the real prefix (the same mask discipline the rest of
  the framework pins in tests).

Mask contract: frame validity is threaded exactly like DS2 — computed from
the input lengths (or last-nonzero-frame detection, models/las.py:52-64)
and collapsed through the VALID subsampling convs with exact conv
arithmetic.  Inside each block, attention masks keys and the depthwise conv
sees zeros at padded frames, so no real frame ever reads padded content.
"""

import os
import re
from typing import Tuple

import jax
import jax.numpy as jnp

from .. import nn
from ..measure import ctc_loss
from ..ops.dropout import FastDropout
from ..ops.dw_conv import depthwise_conv1d
from ..ops.s2d_conv import Conv2DValid
from .las import audio_frame_lengths, split_audio_lengths
from .model_proto import ModelProto


NEG_INF = -1e9

# Encoder-internal time-axis tile alignment (see Conformer.hidden_states):
# pad T' up to a multiple of TIME_PAD_MULTIPLE once it reaches TIME_PAD_GATE.
# Module-level so tests can monkeypatch the gate down to mini shapes.
TIME_PAD_MULTIPLE = 128
TIME_PAD_GATE = 128


def _dropout(rate: float):
    """Dropout layer factory: counter-based hash dropout by default.

    Threefry bit generation over 6 sites/block x 16 blocks of up-to-
    [B, T, 4D] tensors is a large share of a Conformer train step;
    ``FastDropout`` (ops/dropout.py) replaces it with a fused position-hash
    and regenerates masks in the backward.  SRT_FAST_DROPOUT=0 reverts to
    the threefry ``nn.Dropout``.  Neither carries params, so the flag never
    touches checkpoint structure.
    """
    if os.environ.get("SRT_FAST_DROPOUT", "1") != "0":
        return FastDropout(rate)
    return nn.Dropout(rate)


def rope_rotate(x: jnp.ndarray) -> jnp.ndarray:
    """Apply rotary position embedding over the time axis.

    ``x`` is [B, T, H, d] (d even).  Pairs (x[..., :d/2], x[..., d/2:]) are
    rotated by angle pos * 10000^(-2i/d); computed in f32 and cast back so
    bf16 activations keep exact angles.
    """
    d2 = x.shape[-1] // 2
    inv_freq = 10000.0 ** (-jnp.arange(d2, dtype=jnp.float32) / d2)
    angles = jnp.arange(x.shape[1], dtype=jnp.float32)[:, None] * inv_freq[None, :]
    cos = jnp.cos(angles)[None, :, None, :]
    sin = jnp.sin(angles)[None, :, None, :]
    x1 = x[..., :d2].astype(jnp.float32)
    x2 = x[..., d2:].astype(jnp.float32)
    out = jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1)
    return out.astype(x.dtype)


class ConvSubsampler(nn.Module):
    """Conv2D stride-2 x N subsampling stem + projection to encoder_dim.

    Same stem shape as the LAS listener / canonical Conformer front:
    each layer divides time and frequency by 2 (VALID).  Frame validity is
    collapsed with exact conv arithmetic: an output frame is valid iff its
    receptive field lies entirely within real input frames.
    """

    channels: Tuple[int, ...]
    encoder_dim: int
    dropout: float = 0.0
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, audio_input, lengths=None, training: bool = False):
        """[B, T, F, C] -> ([B, T', D], mask [B, T'])."""
        if lengths is None:
            lengths = audio_frame_lengths(audio_input)
        x = audio_input.astype(self.dtype)
        for i, ch in enumerate(self.channels):
            x = Conv2DValid(ch, kernel_size=(3, 3), strides=(2, 2), dtype=self.dtype, name=f"conv{i}")(x)
            x = nn.relu(x)
            lengths = jnp.maximum(lengths - 3, 0) // 2 + jnp.where(lengths >= 3, 1, 0)
        B, T2 = x.shape[0], x.shape[1]
        x = x.reshape(B, T2, x.shape[2] * x.shape[3])
        x = nn.Dense(self.encoder_dim, dtype=self.dtype, name="proj")(x)
        x = _dropout(self.dropout)(x, deterministic=not training)
        lengths = jnp.minimum(lengths, T2)
        mask = jnp.arange(T2)[None, :] < lengths[:, None]
        return x, mask


class FeedForward(nn.Module):
    """Macaron feed-forward: LN -> Dense(expansion*D) -> swish -> Dense(D)."""

    dim: int
    expansion: int = 4
    dropout: float = 0.0
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, training: bool = False):
        x = nn.LayerNorm(dtype=self.dtype, name="ln")(x)
        x = nn.Dense(self.dim * self.expansion, dtype=self.dtype, name="dense1")(x)
        x = nn.swish(x)
        x = _dropout(self.dropout)(x, deterministic=not training)
        x = nn.Dense(self.dim, dtype=self.dtype, name="dense2")(x)
        return _dropout(self.dropout)(x, deterministic=not training)


class MHSA(nn.Module):
    """Multi-head self-attention with RoPE, key-masked, f32 softmax."""

    dim: int
    num_heads: int
    dropout: float = 0.0
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, mask, training: bool = False):
        B, T, D = x.shape
        H = self.num_heads
        d = D // H
        assert D % H == 0 and d % 2 == 0, "encoder_dim/heads must be even"
        x = nn.LayerNorm(dtype=self.dtype, name="ln")(x)
        qkv = nn.Dense(3 * D, dtype=self.dtype, name="qkv")(x).reshape(B, T, 3, H, d)
        q = rope_rotate(qkv[:, :, 0])
        k = rope_rotate(qkv[:, :, 1])
        v = qkv[:, :, 2]
        scores = jnp.einsum("bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32)
        scores = scores / jnp.sqrt(jnp.float32(d))
        scores = jnp.where(mask[:, None, None, :], scores, NEG_INF)
        probs = jax.nn.softmax(scores, axis=-1).astype(self.dtype)
        probs = _dropout(self.dropout)(probs, deterministic=not training)
        ctx = jnp.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
        out = nn.Dense(D, dtype=self.dtype, name="out")(ctx)
        return _dropout(self.dropout)(out, deterministic=not training)


class ConvModule(nn.Module):
    """Conformer convolution module: LN -> pointwise(2D) -> GLU ->
    depthwise conv1d -> LN -> swish -> pointwise(D).

    Masked frames are zeroed before the depthwise conv so real frames near
    the valid/pad boundary convolve against exact zeros (pad content can
    never leak in).  Normalization is LayerNorm (see module docstring).
    """

    dim: int
    kernel_size: int = 32
    dropout: float = 0.0
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, mask, training: bool = False):
        x = nn.LayerNorm(dtype=self.dtype, name="ln")(x)
        x = nn.Dense(2 * self.dim, dtype=self.dtype, name="pointwise1")(x)
        x = nn.glu(x, axis=-1)
        x = x * mask[:, :, None].astype(x.dtype)
        # depthwise temporal conv: one tap-column per channel via
        # feature_group_count=dim; SAME padding keeps T static
        kernel = self.param(
            "depthwise_kernel",
            nn.initializers.lecun_normal(),
            (self.kernel_size, 1, self.dim),
            jnp.float32,
        )
        # custom-VJP wrapper: XLA SPMD mis-partitions the grouped-conv
        # KERNEL grad on multi-axis meshes (see ops/dw_conv.py docstring)
        x = depthwise_conv1d(x, kernel.astype(x.dtype))
        x = nn.LayerNorm(dtype=self.dtype, name="norm")(x)
        x = nn.swish(x)
        x = nn.Dense(self.dim, dtype=self.dtype, name="pointwise2")(x)
        return _dropout(self.dropout)(x, deterministic=not training)


class ConformerBlock(nn.Module):
    """FF(1/2) -> MHSA -> Conv -> FF(1/2) -> LN, all residual."""

    dim: int
    num_heads: int
    conv_kernel_size: int
    ffn_expansion: int = 4
    dropout: float = 0.0
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x, mask, training: bool = False):
        kw = dict(dropout=self.dropout, dtype=self.dtype)
        x = x + 0.5 * FeedForward(self.dim, self.ffn_expansion, name="ff1", **kw)(x, training)
        x = x + MHSA(self.dim, self.num_heads, name="mhsa", **kw)(x, mask, training)
        x = x + ConvModule(self.dim, self.conv_kernel_size, name="conv", **kw)(x, mask, training)
        x = x + 0.5 * FeedForward(self.dim, self.ffn_expansion, name="ff2", **kw)(x, training)
        return nn.LayerNorm(dtype=self.dtype, name="ln")(x)


class _BlockScanStep(nn.Module):
    """One lax.scan step over a ConformerBlock (``scan_layers=True`` path).

    ``nn.scan`` needs a ``carry, *broadcast -> (carry, out)`` call shape;
    this wraps the plain block (identical math and submodule names, so the
    stacked params are exactly the unrolled params stacked — see
    ``stack_block_params``).
    """

    dim: int
    num_heads: int
    conv_kernel_size: int
    ffn_expansion: int
    dropout: float
    remat: bool
    dtype: jnp.dtype

    @nn.compact
    def __call__(self, x, mask, training: bool = False):
        block_cls = nn.remat(ConformerBlock, static_argnums=(3,)) if self.remat else ConformerBlock
        x = block_cls(
            self.dim,
            self.num_heads,
            self.conv_kernel_size,
            self.ffn_expansion,
            self.dropout,
            dtype=self.dtype,
            name="block",
        )(x, mask, training)
        return x, None


def stack_block_params(params, num_layers: int):
    """Unrolled Conformer params (``block0..block{L-1}``) -> the
    ``scan_layers=True`` layout: one ``blocks/block`` subtree whose every
    leaf gains a leading [L] layer axis.  Non-block entries (subsampler,
    fully_connected) pass through.  Inverse: ``unstack_block_params``."""
    blocks = [params[f"block{i}"] for i in range(num_layers)]
    stacked = jax.tree_util.tree_map(lambda *leaves: jnp.stack(leaves), *blocks)
    out = {k: v for k, v in params.items() if not re.fullmatch(r"block\d+", k)}
    out["blocks"] = {"block": stacked}
    return out


def unstack_block_params(params, num_layers: int):
    """Inverse of ``stack_block_params``: split the stacked [L, ...] leaves
    back into per-layer ``block{i}`` subtrees (unrolled layout)."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    stacked = params["blocks"]["block"]
    for i in range(num_layers):
        out[f"block{i}"] = jax.tree_util.tree_map(lambda leaf: leaf[i], stacked)
    return out


class Conformer(ModelProto):
    """Conformer encoder + CTC head.

    Same framework contract as DeepSpeech2 (reference deepspeech2.py:122-202):
    identity ``make_example``, [T, F, C] batching shape, CTC loss keyed on
    ``blank_index``/``pad_index``.
    """

    vocab_size: int
    encoder_dim: int
    num_layers: int
    num_attention_heads: int
    conv_kernel_size: int
    ffn_expansion: int
    dropout: float
    subsample_channels: Tuple[int, ...]
    blank_index: int
    pad_index: int = 0
    # rematerialize each block's activations in the backward pass
    # (jax.checkpoint): trades ~1 extra forward of FLOPs for O(num_layers)
    # less activation HBM — the standard lever for scaling batch/depth
    remat: bool = False
    # fold the (architecturally identical) blocks into ONE traced block under
    # lax.scan with stacked [L, ...] params: the HLO no longer repeats the
    # block subgraph num_layers times, so compile time drops ~num_layers-x.
    # Changes the param tree (block0..N -> blocks/block, leading layer axis);
    # stack_block_params / unstack_block_params convert between the layouts.
    scan_layers: bool = False
    dtype: jnp.dtype = jnp.float32

    def setup(self):
        self.subsampler = ConvSubsampler(
            self.subsample_channels, self.encoder_dim, self.dropout, dtype=self.dtype, name="subsampler"
        )
        if self.scan_layers:
            # scan-of-(optionally remat-ed) block: variable_axes stacks each
            # layer's params on axis 0; dropout rngs split per layer so sites
            # stay independent across depth (distribution unchanged; the bit
            # stream differs from the unrolled layout's rng fold path)
            self.blocks = nn.scan(
                _BlockScanStep,
                variable_axes={"params": 0},
                split_rngs={"params": True, "dropout": True},
                in_axes=(nn.broadcast, nn.broadcast),
                length=self.num_layers,
            )(
                self.encoder_dim,
                self.num_attention_heads,
                self.conv_kernel_size,
                self.ffn_expansion,
                self.dropout,
                self.remat,
                dtype=self.dtype,
                name="blocks",
            )
        else:
            # identical params/structure either way: nn.remat is transparent
            # to the variable tree, so remat toggles freely across a checkpoint
            block_cls = nn.remat(ConformerBlock, static_argnums=(3,)) if self.remat else ConformerBlock
            self.blocks = [
                block_cls(
                    self.encoder_dim,
                    self.num_attention_heads,
                    self.conv_kernel_size,
                    self.ffn_expansion,
                    self.dropout,
                    dtype=self.dtype,
                    name=f"block{i}",
                )
                for i in range(self.num_layers)
            ]
        self.fully_connected = nn.Dense(self.vocab_size, dtype=self.dtype, name="fully_connected")

    def __call__(self, audio_input, training: bool = False):
        """[B, T, F, C] (or (features, frame_lengths)) -> logits [B, T', V]."""
        return self.fully_connected(self.hidden_states(audio_input, training))

    def hidden_states(self, audio_input, training: bool = False):
        """Forward up to (not including) the vocab projection: [B, T', D]."""
        audio_input, frame_lengths = split_audio_lengths(audio_input)
        x, mask = self.subsampler(audio_input, frame_lengths, training)
        # Tile-align the encoder's time axis: two VALID stride-2 convs turn
        # T=1024 into T'=255, so every attention matmul and [T', T']
        # intermediate carries a ragged last tile.  Pad time up to a
        # multiple of 128 for the blocks only and slice back before the CTC
        # head (whether this pays on the GPU is an open A/B): padded frames are
        # mask-False, so attention key-masks them, the conv module zeroes
        # them before the depthwise conv, and FFN/LN are per-frame — valid
        # frames are bit-identical either way (pinned in
        # tests/models/test_conformer.py).  Small T' (tests, short utts) is
        # left alone: the pad only pays off once tiles are actually full.
        T1 = x.shape[1]
        pad = (-T1) % TIME_PAD_MULTIPLE if T1 >= TIME_PAD_GATE else 0
        if pad:
            x = jnp.pad(x, ((0, 0), (0, pad), (0, 0)))
            mask = jnp.pad(mask, ((0, 0), (0, pad)))
        if self.scan_layers:
            x, _ = self.blocks(x, mask, training)
        else:
            for block in self.blocks:
                x = block(x, mask, training)
        if pad:
            x, mask = x[:, :T1], mask[:, :T1]
        # zero padded frames (DS2 parity semantics, deepspeech2.py:174-178):
        # CTC consumes the full padded T with blank-friendly masked rows
        return x * mask[:, :, None].astype(self.dtype)

    def get_loss_fn(self):
        blank, pad = self.blank_index, self.pad_index
        return lambda y_true, logits: ctc_loss(y_true, logits, blank, pad)

    def get_metrics(self):
        return []

    @staticmethod
    def get_batching_shape(audio_pad_length, token_pad_length, frequency_dim, feature_dim):
        return ([audio_pad_length, frequency_dim, feature_dim], [token_pad_length])

    @staticmethod
    def make_example(audio, tokens):
        return audio, tokens

    @property
    def model_checkpoint_name(self) -> str:
        return "model-{epoch}epoch-{val_loss:.4f}loss"
