"""DeepSpeech2.

Architecture parity with reference speech_recognition/models/deepspeech2.py:
- ``Convolution``: N x VALID Conv2D over [B, T, F, C] then freq/channel
  flatten (reference deepspeech2.py:11-66).  The time mask is recomputed with
  exact conv length arithmetic over valid-frame counts instead of the
  reference's reshape/reduce_any collapse, which also fixes the latent
  stride-product bug at deepspeech2.py:74.
- ``Recurrent``: N x (BiRNN -> BatchNorm) with final-state threading across
  layers (reference deepspeech2.py:81-119).
- ``DeepSpeech2``: conv -> recurrent -> mask-zeroed -> vocab Dense; CTC loss
  (reference deepspeech2.py:122-202).
"""

from typing import Tuple

import jax.numpy as jnp

from .. import nn
from ..measure import ctc_loss
from ..ops.rnn import BiRNN
from ..ops.s2d_conv import Conv2DValid
from .las import audio_frame_lengths, split_audio_lengths
from .model_proto import ModelProto
from .moe import MoELayer


class Convolution(nn.Module):
    """Conv frontend (reference deepspeech2.py:11-78)."""

    num_layers: int
    channels: Tuple[int, ...]
    kernel_sizes: Tuple[Tuple[int, int], ...]
    strides: Tuple[Tuple[int, int], ...]
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, audio_input: jnp.ndarray, training: bool = False, lengths=None):
        """[B, T, F, C] -> ([B, T', F'*ch], mask [B, T'])."""
        assert self.num_layers == len(self.channels) == len(self.kernel_sizes) == len(self.strides)
        if lengths is None:
            lengths = audio_frame_lengths(audio_input)

        x = audio_input.astype(self.dtype)
        for i, (ch, kernel, stride) in enumerate(zip(self.channels, self.kernel_sizes, self.strides)):
            # Conv2DValid == nn.Conv(VALID) parameter-wise; with SRT_S2D_CONV=1 the
            # stride-2-time layers take the phase-split stride-1 path
            # (ops/s2d_conv.py) whose backward avoids input dilation
            x = Conv2DValid(
                ch, kernel_size=tuple(kernel), strides=tuple(stride), dtype=self.dtype, name=f"conv{i}"
            )(x)

        B, T2 = x.shape[0], x.shape[1]
        output = x.reshape(B, T2, x.shape[2] * x.shape[3])
        # intended reference mask semantics (deepspeech2.py:68-78): collapse
        # the frame mask by the time-stride product — an output frame is valid
        # if ANY input frame in its group is, i.e. ceil(L / prod) clamped to
        # T2.  (The reference's stride_complex expression is buggy and yields
        # an all-False mask — constant logits — so the fixed collapse, which
        # matches the LAS listener's semantics, is the parity target; see
        # tests/test_model_parity.py.)
        reduction = 1
        for stride in self.strides:
            reduction *= stride[0]
        lengths = jnp.minimum((lengths + reduction - 1) // reduction, T2)
        mask = jnp.arange(T2)[None, :] < lengths[:, None]
        return output, mask


class Recurrent(nn.Module):
    """BiRNN stack with BatchNorm (reference deepspeech2.py:81-119).

    ``moe_experts > 0`` (beyond parity — the reference trunk is dense)
    inserts a residual Switch-routed MoE FFN (models/moe.py) after each
    layer's BatchNorm; padding frames are excluded from routing via the
    frame mask, so the parity pad semantics hold.
    """

    rnn_type: str
    num_layers: int
    units: int
    dropout: float = 0.0
    recurrent_dropout: float = 0.0
    moe_experts: int = 0
    moe_hidden_dim: int = 0
    moe_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, audio_input: jnp.ndarray, mask: jnp.ndarray, training: bool = False):
        states = None
        x = audio_input
        for i in range(self.num_layers):
            output, *states = BiRNN(
                self.rnn_type,
                self.units,
                self.dropout,
                self.recurrent_dropout,
                dtype=self.dtype,
                name=f"reccurent_layer{i}",
            )(x, mask, states, training)
            x = nn.BatchNorm(
                use_running_average=not training,
                momentum=0.99,
                epsilon=1e-3,
                dtype=self.dtype,
                name=f"batch_normalization{i}",
            )(output)
            if self.moe_experts:
                x = MoELayer(
                    self.moe_experts,
                    self.moe_hidden_dim or 4 * 2 * self.units,
                    k=self.moe_k,
                    capacity_factor=self.moe_capacity_factor,
                    aux_weight=self.moe_aux_weight,
                    dtype=self.dtype,
                    name=f"moe{i}",
                )(x, mask)
        return x


class DeepSpeech2(ModelProto):
    """DeepSpeech2 model (reference deepspeech2.py:122-202)."""

    num_conv_layers: int
    channels: Tuple[int, ...]
    kernel_sizes: Tuple[Tuple[int, int], ...]
    strides: Tuple[Tuple[int, int], ...]
    rnn_type: str
    num_reccurent_layers: int
    hidden_dim: int
    dropout: float
    recurrent_dropout: float
    vocab_size: int
    blank_index: int
    pad_index: int = 0
    # beyond parity: sparse MoE FFNs in the recurrent trunk (models/moe.py);
    # 0 = the reference's dense architecture, checkpoint-layout unchanged
    moe_experts: int = 0
    moe_hidden_dim: int = 0
    moe_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    dtype: jnp.dtype = jnp.float32

    def setup(self):
        self.convolution = Convolution(
            self.num_conv_layers, self.channels, self.kernel_sizes, self.strides, dtype=self.dtype, name="convolution"
        )
        self.recurrent = Recurrent(
            self.rnn_type,
            self.num_reccurent_layers,
            self.hidden_dim,
            self.dropout,
            self.recurrent_dropout,
            moe_experts=self.moe_experts,
            moe_hidden_dim=self.moe_hidden_dim,
            moe_k=self.moe_k,
            moe_capacity_factor=self.moe_capacity_factor,
            moe_aux_weight=self.moe_aux_weight,
            dtype=self.dtype,
            name="recurrent",
        )
        self.fully_connected = nn.Dense(self.vocab_size, dtype=self.dtype, name="fully_connected")

    def __call__(self, audio_input: jnp.ndarray, training: bool = False):
        """[B, T, F, C] (or (features, frame_lengths)) -> logits [B, T', V]."""
        return self.fully_connected(self.hidden_states(audio_input, training))

    def hidden_states(self, audio_input, training: bool = False):
        """Forward up to (not including) the vocab projection: [B, T', 2H]."""
        audio_input, frame_lengths = split_audio_lengths(audio_input)
        audio, mask = self.convolution(audio_input, training, frame_lengths)
        return self.recurrent(audio, mask, training) * mask[:, :, None].astype(self.dtype)

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
