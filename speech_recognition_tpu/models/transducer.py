"""RNN-Transducer (RNN-T) model family — beyond reference parity.

The reference (cosmoquester/speech-recognition) ships LAS and DeepSpeech2;
this adds the streaming-friendly transducer objective (Graves 2012) on top
of the framework's existing building blocks:

* encoder: the Conformer stem + block stack (models/conformer.py — RoPE
  MHSA, macaron FFNs, masked depthwise conv), projected to the joint dim.
* prediction network: embedding + unidirectional masked LSTM stack
  (ops/rnn.RNN — lax.scan cells with the custom sequence VJP), projected
  to the joint dim (no bias: the encoder projection's bias covers it).
* joint: additive combine -> tanh -> vocab.  The full [B, T', U+1, V]
  logits lattice NEVER materializes — training routes through
  ops/transducer.joint_log_planes (a custom-VJP scan over encoder frames
  that emits only the blank/target log-prob planes) into the
  ops/transducer.transducer_loss lattice DP.

Training I/O matches LAS's (model_input = (audio, tokens[:-1]) with BOS,
y_true = tokens[1:] with EOS — las.py make_example): the prediction net
consumes [BOS, y_1..y_U] and the lattice emits [y_1..y_U] — the trailing
EOS is dropped inside the loss (blank terminates transducer paths; see
get_loss_fn) — so the whole data pipeline (padded/bucketed batching,
TFRecords, tokenizers) is reused unchanged.
"""

from typing import Tuple

import jax.numpy as jnp

from .. import nn
from ..ops.rnn import RNN
from ..ops.transducer import joint_log_planes, transducer_loss
from .conformer import TIME_PAD_GATE, TIME_PAD_MULTIPLE, ConformerBlock, ConvSubsampler
from .las import split_audio_lengths
from .model_proto import ModelProto


class Transducer(ModelProto):
    """Conformer-encoder RNN-T with an LSTM prediction network."""

    vocab_size: int
    encoder_dim: int = 256
    num_encoder_layers: int = 16
    num_attention_heads: int = 4
    conv_kernel_size: int = 32
    ffn_expansion: int = 4
    subsample_channels: Tuple[int, ...] = (128, 128)
    pred_dim: int = 320
    num_pred_layers: int = 1
    joint_dim: int = 320
    dropout: float = 0.1
    blank_index: int = 0
    pad_index: int = 0
    remat: bool = False
    # pruned (banded) lattice width: evaluate the joint on only this many
    # label slots per frame (ops/transducer_pruned.py); 0 = exact dense
    pruned_range: int = 0
    dtype: jnp.dtype = jnp.float32

    def setup(self):
        self.subsampler = ConvSubsampler(
            self.subsample_channels, self.encoder_dim, self.dropout, dtype=self.dtype, name="subsampler"
        )
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
            for i in range(self.num_encoder_layers)
        ]
        self.enc_proj = nn.Dense(self.joint_dim, dtype=self.dtype, name="enc_proj")
        self.embedding = nn.Embed(self.vocab_size, self.pred_dim, name="embedding")
        self.pred_layers = [
            RNN("lstm", self.pred_dim, dropout=self.dropout, dtype=self.dtype, name=f"pred_layer{i}")
            for i in range(self.num_pred_layers)
        ]
        self.pred_proj = nn.Dense(
            self.joint_dim, use_bias=False, dtype=self.dtype, name="pred_proj"
        )
        self.joint_kernel = self.param(
            "joint_kernel",
            nn.initializers.lecun_normal(),
            (self.joint_dim, self.vocab_size),
            jnp.float32,
        )
        self.joint_bias = self.param(
            "joint_bias", nn.initializers.zeros, (self.vocab_size,), jnp.float32
        )

    # ------------------------------------------------------------- encoder
    def encode(self, audio_input, training: bool = False):
        """[B, T, F, C] (or (features, lengths)) ->
        (enc_proj [B, T', J] pre-tanh joint input, frame_lens [B] int32)."""
        audio_input, frame_lengths = split_audio_lengths(audio_input)
        x, mask = self.subsampler(audio_input, frame_lengths, training)
        # time tile-alignment, same contract as Conformer.hidden_states:
        # padded frames are mask-False so no valid frame reads them
        T1 = x.shape[1]
        pad = (-T1) % TIME_PAD_MULTIPLE if T1 >= TIME_PAD_GATE else 0
        if pad:
            x = jnp.pad(x, ((0, 0), (0, pad), (0, 0)))
            mask = jnp.pad(mask, ((0, 0), (0, pad)))
        for block in self.blocks:
            x = block(x, mask, training)
        if pad:
            x, mask = x[:, :T1], mask[:, :T1]
        enc = self.enc_proj(x * mask[:, :, None].astype(self.dtype))
        return enc, jnp.sum(mask.astype(jnp.int32), axis=-1)

    # ---------------------------------------------------- prediction network
    def predict_sequence(self, tokens, training: bool = False):
        """[B, U1] int tokens (BOS-prefixed, pad-padded) ->
        pred_proj [B, U1, J] pre-tanh joint input."""
        mask = tokens != self.pad_index
        x = self.embedding(tokens).astype(self.dtype)
        for layer in self.pred_layers:
            x, _ = layer(x, mask, training=training)
        return self.pred_proj(x)

    # --------------------------------------------------------------- forward
    def __call__(self, inputs, training: bool = False):
        """((audio, tokens)) -> joint-input pytree for the streamed loss.

        Returns a dict, NOT logits: materializing [B, T', U+1, V] is
        exactly what this family's design avoids (see module docstring).
        """
        audio_input, tokens = inputs
        enc_proj, frame_lens = self.encode(audio_input, training)
        pred_proj = self.predict_sequence(tokens, training)
        return {
            "enc_proj": enc_proj,
            "pred_proj": pred_proj,
            "joint_kernel": self.joint_kernel.astype(self.dtype),
            "joint_bias": self.joint_bias.astype(self.dtype),
            "frame_lens": frame_lens,
        }

    # ------------------------------------------------------------ framework
    def get_loss_fn(self):
        blank, pad = self.blank_index, self.pad_index
        pruned = self.pruned_range

        def _planes(outputs, ids, frame_lens, label_lens):
            """Blank/target log-prob planes: the frame scan of
            ops/transducer.joint_log_planes, or with ``pruned_range`` set the
            banded joint (ops/transducer_pruned.py) that evaluates only an
            s_range-wide label band per frame — a U1/s_range FLOP cut."""
            args = (
                outputs["enc_proj"],
                outputs["pred_proj"],
                outputs["joint_kernel"],
                outputs["joint_bias"],
                ids,
            )
            if pruned:
                from ..ops.transducer_pruned import pruned_log_planes

                return pruned_log_planes(blank, pruned, *args, frame_lens, label_lens)
            return joint_log_planes(blank, *args)

        def loss_fn(y_true, outputs):
            """Label-length-normalized RNN-T NLL, averaged over real rows
            (same reduction contract as measure.ctc_loss: all-pad rows are
            batch padding and contribute nothing).

            EOS is NOT a transducer label: blank terminates paths (Graves
            2012), so the final EOS the pipeline appends for LAS is dropped
            from the lattice (label_lens = non-pad count - 1).  That also
            makes the slot counts line up exactly: the final blank at
            u = U needs the prediction slot for the full label history,
            and pred_proj's U+1 slots ([BOS, y_1..y_U] = tokens[:-1])
            provide it only when y_true's last column (EOS at max length)
            is excluded."""
            label_lens = jnp.maximum(jnp.sum(y_true != pad, axis=-1) - 1, 0).astype(jnp.int32)
            ids = jnp.where(y_true == pad, 0, y_true)[:, :-1]
            frame_lens = jnp.maximum(outputs["frame_lens"], 1)
            lpb, lpe = _planes(outputs, ids, frame_lens, label_lens)
            per_seq = transducer_loss(lpb, lpe, frame_lens, label_lens)
            valid = label_lens > 0
            # pruned lattice: rows whose labels outnumber what the band can
            # carry have no in-band path — their loss sits at the -1e30
            # floor's magnitude; exclude them rather than poison the mean
            # (their occupancy gradients are already exactly zero)
            valid = valid & (per_seq < 1e29)
            normed = jnp.where(valid, per_seq / jnp.maximum(label_lens, 1), 0.0)
            return jnp.sum(normed) / jnp.maximum(jnp.sum(valid), 1)

        return loss_fn

    def get_metrics(self):
        return []

    @staticmethod
    def get_batching_shape(audio_pad_length, token_pad_length, frequency_dim, feature_dim):
        if token_pad_length is not None:
            token_pad_length = token_pad_length - 1
        return (([audio_pad_length, frequency_dim, feature_dim], [token_pad_length]), [token_pad_length])

    @staticmethod
    def make_example(audio, tokens):
        """(audio, tokens) -> ((audio, tokens[:-1]), tokens[1:]) — the LAS
        convention (las.py:676-678): BOS-led prediction-net input, EOS-led
        lattice targets."""
        return (audio, tokens[:-1]), tokens[1:]

    @property
    def model_checkpoint_name(self) -> str:
        return "model-{epoch}epoch-{val_loss:.4f}loss"
