"""Listen, Attend and Spell (LAS).

Architecture parity with reference speech_recognition/models/las.py:
- ``Attention``: multiplicative attention with projected query/key, -1e9
  masking (reference las.py:20-59).  Change: the key projection is
  computed ONCE over the encoder output and reused every decoder step
  (the reference re-projects keys inside every step, las.py:50).
- ``Listener``: 2x stride-2 VALID Conv2D + dropout -> N x (BiRNN -> Dense ->
  BatchNorm -> ReLU) with final-state threading across layers and a
  state-bridge projection into the decoder (reference las.py:129-217).
- ``AttendAndSpeller``: embed -> attention -> stacked unidirectional RNN
  cells (the reference threads one flat state list through the layer stack,
  las.py:285-288 — mirrored exactly for checkpoint parity) -> vocab Dense
  (reference las.py:220-292).
- ``LAS.__call__``: teacher forcing sampled once per batch (las.py:366); the
  decoder loop is a single ``lax.scan`` over token positions instead of the
  reference's per-token Python loop + TensorArray (las.py:361-379).

Masks are derived from conv length arithmetic on the count of non-pad
frames rather than the reference's reshape/reduce_any collapse
(las.py:205-217) — same contract (True on valid frames), exact under the
pad-invariance property.
"""

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import nn
from ..measure import sparse_categorical_accuracy, sparse_categorical_crossentropy
from ..ops.rnn import BiRNN, RNNParams, cell_step, num_states
from ..ops.s2d_conv import Conv2DValid
from .model_proto import ModelProto

def _embed_init(key, shape, dtype=jnp.float32):
    # Keras Embedding default RandomUniform(-0.05, 0.05)
    return jax.random.uniform(key, shape, dtype, -0.05, 0.05)


def conv_output_length(length, kernel_size: int, stride: int):
    """VALID conv output length: floor((L - k) / s) + 1."""
    return jnp.maximum((length - kernel_size) // stride + 1, 0)


def audio_frame_mask(audio: jnp.ndarray) -> jnp.ndarray:
    """[B, T] True where the frame has any non-pad value (pad value 0.0)."""
    return jnp.any(audio.reshape(audio.shape[0], audio.shape[1], -1) != 0.0, axis=2)


def audio_frame_lengths(audio: jnp.ndarray) -> jnp.ndarray:
    """[B] valid frame count = index of the last non-zero frame + 1.

    Counting non-zero frames (the reference's pad detection,
    las.py:205-217) undercounts when SpecAugment time masks zero whole
    interior frames; taking the last non-zero position instead is exact as
    long as the final real frame is non-zero (log-mel of silence is
    log(1e-12) != 0, so this holds in practice).  Callers that know the true
    lengths (the fused on-device frontend) pass them explicitly instead.
    """
    nonzero = audio_frame_mask(audio)
    positions = jnp.arange(1, audio.shape[1] + 1, dtype=jnp.int32)[None, :]
    return jnp.max(jnp.where(nonzero, positions, 0), axis=1)


def _decoder_unroll() -> int:
    """Unroll factor for the decoder scans; ``SRT_DEC_UNROLL`` overrides the
    default of 1 (the step body is several small dependent matmuls, so
    unrolling trades loop overhead against schedule size)."""
    import os

    return int(os.environ.get("SRT_DEC_UNROLL", 1))


def split_audio_lengths(audio_input):
    """Accept [B,T,F,C] features or a (features, frame_lengths) pair."""
    if isinstance(audio_input, (tuple, list)):
        return audio_input[0], audio_input[1]
    return audio_input, None


class DenseParams(nn.Module):
    """Param holder with nn.Dense's layout/initializers (kernel, bias).

    Exposes the raw arrays (the custom-VJP decoder scan needs them as
    explicit operands) while keeping checkpoint paths identical to an
    nn.Dense of the same name.
    """

    features: int

    @nn.compact
    def __call__(self, in_dim: int):
        kernel = self.param("kernel", nn.initializers.lecun_normal(), (in_dim, self.features))
        bias = self.param("bias", nn.initializers.zeros, (self.features,))
        return kernel, bias


class Attention(nn.Module):
    """Dot-product attention with projected query/key (reference las.py:20-59)."""

    hidden_dim: int
    dtype: jnp.dtype = jnp.float32

    def setup(self):
        self.query_weight = DenseParams(self.hidden_dim, name="query_weight")
        self.key_weight = DenseParams(self.hidden_dim, name="key_weight")

    def query_params(self, in_dim: int):
        kernel, bias = self.query_weight(in_dim)
        return kernel.astype(self.dtype), bias.astype(self.dtype)

    def project_keys(self, key: jnp.ndarray) -> jnp.ndarray:
        """[B, S, H] -> [B, S, H], hoisted out of the decode loop."""
        kernel, bias = self.key_weight(key.shape[-1])
        return key @ kernel.astype(self.dtype) + bias.astype(self.dtype)

    def __call__(self, query, key, value, attention_mask, projected_key=None):
        """query [B,H] (or [B,K,H] for K beams), key/value [B,S,*],
        mask [B,S] -> context [B,Dv] (or [B,K,Dv]).

        Pass ``projected_key`` (from project_keys) to skip the per-step key
        projection on the decode hot path.  The multi-query form lets beam
        search attend all K hypotheses of a batch element over ONE copy of
        the (projected) listener output instead of tiling it K-fold — the
        per-row math is identical, only the batching of the score/context
        contractions changes.
        """
        if projected_key is None:
            projected_key = self.project_keys(key)
        qk, qb = self.query_params(query.shape[-1])
        single = query.ndim == 2
        q = query @ qk + qb
        if single:
            q = q[:, None, :]  # [B,1,H]
        scores = jnp.einsum("bqh,bsh->bqs", q, projected_key)
        scores = scores - 1e9 * (1.0 - attention_mask[:, None, :].astype(scores.dtype))
        probs = jax.nn.softmax(scores, axis=-1)
        ctx = jnp.einsum("bqs,bsd->bqd", probs, value)
        return ctx[:, 0] if single else ctx


class Listener(nn.Module):
    """LAS listener (reference las.py:129-217)."""

    rnn_type: str
    encoder_hidden_dim: int
    decoder_hidden_dim: int
    num_encoder_layers: int
    dropout: float
    dtype: jnp.dtype = jnp.float32

    KERNEL_SIZE = 3
    STRIDE = 2

    @nn.compact
    def __call__(self, audio: jnp.ndarray, training: bool = False, lengths: Optional[jnp.ndarray] = None):
        """audio [B, T, F, C] -> [encoded [B, T', H], mask [B, T'], *states].

        ``lengths`` [B] overrides zero-frame detection when the caller knows
        the true valid frame counts (e.g. the fused on-device frontend).
        """
        if lengths is None:
            lengths = audio_frame_lengths(audio)

        audio = audio.astype(self.dtype)
        deterministic = not training
        drop = lambda x: nn.Dropout(self.dropout, deterministic=deterministic)(x)
        conv_kw = dict(
            kernel_size=(self.KERNEL_SIZE, self.KERNEL_SIZE),
            strides=(self.STRIDE, self.STRIDE),
            dtype=self.dtype,
        )
        # Conv2DValid == nn.Conv(VALID) parameter-wise, with the opt-in
        # phase-split stride-1 path for stride-2 time (ops/s2d_conv.py)
        audio = drop(Conv2DValid(32, name="conv1", **conv_kw)(audio))
        audio = drop(Conv2DValid(32, name="conv2", **conv_kw)(audio))
        B, T2 = audio.shape[0], audio.shape[1]
        audio = audio.reshape(B, T2, audio.shape[2] * audio.shape[3])

        # reference mask semantics (las.py:205-217): collapse the frame mask
        # by groups of stride**2 — an output frame is valid if ANY input frame
        # in its group is valid, i.e. ceil(L / 4) clamped to T2.  This keeps
        # conv frames partially computed from padding, exactly as the
        # published checkpoints were trained; exact conv arithmetic
        # ((L-3)//2+1 twice) would drop one frame and break logits parity on
        # padded batches (verified against the TF model in
        # tests/test_model_parity.py).
        reduction = self.STRIDE**2
        lengths = jnp.minimum((lengths + reduction - 1) // reduction, T2)
        mask = jnp.arange(T2)[None, :] < lengths[:, None]

        states = None
        for i in range(self.num_encoder_layers):
            audio, *states = BiRNN(
                self.rnn_type, self.encoder_hidden_dim, self.dropout, dtype=self.dtype, name=f"encoder_layer{i}"
            )(audio, mask, states, training)
            audio = nn.Dense(self.encoder_hidden_dim * 2, dtype=self.dtype, name=f"projection{i}")(audio)
            audio = nn.BatchNorm(
                use_running_average=deterministic,
                momentum=0.99,
                epsilon=1e-3,
                dtype=self.dtype,
                name=f"batch_normalization{i}",
            )(audio)
            audio = nn.relu(audio)

        # bridge final fwd/bwd states into decoder dimension (reference las.py:195-202)
        hidden_proj = nn.Dense(self.decoder_hidden_dim, dtype=self.dtype, name="hidden_states_proj")
        if self.rnn_type == "lstm":
            # states = [fwd_h, fwd_c, bwd_h, bwd_c]
            h = hidden_proj(jnp.concatenate([states[0], states[2]], axis=-1))
            c = nn.Dense(self.decoder_hidden_dim, dtype=self.dtype, name="cell_states_proj")(
                jnp.concatenate([states[1], states[3]], axis=-1)
            )
            out_states = (h, c)
        else:
            out_states = (hidden_proj(jnp.concatenate([states[0], states[1]], axis=-1)),)
        return [audio, mask] + list(out_states)


class AttendAndSpeller(nn.Module):
    """Single-step LAS decoder (reference las.py:220-292)."""

    rnn_type: str
    vocab_size: int
    hidden_dim: int
    num_decoder_layers: int
    dropout: float
    pad_id: int = 0
    dtype: jnp.dtype = jnp.float32

    def setup(self):
        self.embedding = nn.Embed(
            self.vocab_size, self.hidden_dim, embedding_init=_embed_init, dtype=self.dtype, name="embedding"
        )
        self.attention = Attention(self.hidden_dim, dtype=self.dtype, name="attention")
        self.cells = [
            RNNParams(self.rnn_type, self.hidden_dim, name=f"decoder_layer{i}")
            for i in range(self.num_decoder_layers)
        ]
        self.feedforward = nn.Dense(self.vocab_size, dtype=self.dtype, name="feedforward")

    def project_keys(self, audio_output):
        return self.attention.project_keys(audio_output)

    def make_dropout_masks(self, rng, batch: int, context_dim: int):
        """Keras-style per-call dropout masks, constant across decoder steps."""
        keep = 1.0 - self.dropout
        masks = {}
        r_emb, r_out, *r_cells = jax.random.split(rng, 2 + self.num_decoder_layers)
        masks["emb"] = jax.random.bernoulli(r_emb, keep, (batch, self.hidden_dim)).astype(self.dtype) / keep
        masks["out"] = jax.random.bernoulli(r_out, keep, (batch, self.hidden_dim)).astype(self.dtype) / keep
        cell_masks = []
        in_dim = self.hidden_dim + context_dim
        for i, r in enumerate(r_cells):
            cell_masks.append(jax.random.bernoulli(r, keep, (batch, in_dim)).astype(self.dtype) / keep)
            in_dim = self.hidden_dim
        masks["cells"] = cell_masks
        return masks

    def step_hidden(
        self,
        audio_output,
        projected_keys,
        decoder_input,
        attention_mask,
        states: Tuple,
        dropout_masks=None,
    ):
        """One decode step up to (but not including) the vocab projection.

        Returning the pre-logits hidden state lets the teacher-forced
        training path hoist the [B,H] x [H,V] vocab matmul out of the
        sequential scan entirely — one [N*B,H] x [H,V] matmul instead of
        N small ones (reference recomputes it every step, las.py:291).

        :param audio_output: [B, S, Dv] listener output
        :param projected_keys: [B, S, H] hoisted key projection
        :param decoder_input: [B] int32 previous token
        :param attention_mask: [B, S] bool
        :param states: flat state tuple threaded through the layer stack
            exactly like the reference (las.py:285-288)
        :return: (hidden [B, H] after output dropout, new_states)
        """
        token_mask = (decoder_input != self.pad_id)[:, None].astype(self.dtype)
        x = self.embedding(decoder_input)
        if dropout_masks is not None:
            x = x * dropout_masks["emb"]

        context = self.attention(
            states[0], audio_output, audio_output, attention_mask, projected_key=projected_keys
        )
        x = jnp.concatenate([x, context], axis=-1)
        return self._speller_cells(x, token_mask, states, dropout_masks)

    def _speller_cells(self, x, token_mask, states: Tuple, dropout_masks=None):
        """The stacked-cell tail of a decode step ([emb, ctx] -> hidden)."""
        n = num_states(self.rnn_type)
        for i, cell in enumerate(self.cells):
            kernel, recurrent_kernel, bias = cell(x.shape[-1])
            kernel = kernel.astype(self.dtype)
            recurrent_kernel = recurrent_kernel.astype(self.dtype)
            bias = bias.astype(self.dtype)
            if self.rnn_type == "gru":
                input_bias, recurrent_bias = bias[0], bias[1]
            else:
                input_bias, recurrent_bias = bias, None
            x_in = x * dropout_masks["cells"][i] if dropout_masks is not None else x
            x_proj = x_in @ kernel + input_bias
            h_new, new_state = cell_step(
                self.rnn_type, x_proj, tuple(states[:n]), recurrent_kernel, recurrent_bias, self.hidden_dim
            )
            # gate by token mask: pad steps neither advance state nor emit
            new_state = tuple(
                token_mask * ns + (1.0 - token_mask) * os for ns, os in zip(new_state, states[:n])
            )
            x = h_new * token_mask
            states = new_state  # threaded into the next layer (reference semantics)

        if dropout_masks is not None:
            x = x * dropout_masks["out"]
        return x, states

    def step(
        self,
        audio_output,
        projected_keys,
        decoder_input,
        attention_mask,
        states: Tuple,
        dropout_masks=None,
    ):
        """One full decode step: (logits [B, V], new_states)."""
        x, states = self.step_hidden(
            audio_output, projected_keys, decoder_input, attention_mask, states, dropout_masks
        )
        return self.feedforward(x), states

    def step_beam(self, audio_output, projected_keys, decoder_input, attention_mask, states: Tuple):
        """One decode step for K beams per batch element over UNTILED
        listener operands.

        The reference beam loop tiles the encoder output/keys/mask to B*K
        rows (search.py:141-153), so every step re-streams K copies of the
        two large attention operands from device memory.  Here only the decoder
        states are per-beam ([B*K, H] rows, beam-major within each batch
        element — same layout the tiled path used); attention runs with a
        K-query axis over one copy of keys/values.  Per-row arithmetic is
        identical to ``step``.

        :param decoder_input: [B, K] int32 previous tokens
        :param states: flat state tuple of [B*K, H] arrays
        :return: (logits [B*K, V], new_states)
        """
        B, K = decoder_input.shape
        flat = decoder_input.reshape(B * K)
        token_mask = (flat != self.pad_id)[:, None].astype(self.dtype)
        x = self.embedding(flat)
        context = self.attention(
            states[0].reshape(B, K, -1),
            audio_output,
            audio_output,
            attention_mask,
            projected_key=projected_keys,
        ).reshape(B * K, -1)
        x = jnp.concatenate([x, context], axis=-1)
        x, states = self._speller_cells(x, token_mask, states)
        return self.feedforward(x), states


class LAS(ModelProto):
    """LAS model (reference las.py:295-406)."""

    rnn_type: str
    vocab_size: int
    encoder_hidden_dim: int
    decoder_hidden_dim: int
    num_encoder_layers: int
    num_decoder_layers: int
    dropout: float
    teacher_forcing_rate: float
    pad_id: int = 0
    dtype: jnp.dtype = jnp.float32

    def setup(self):
        self.listener = Listener(
            self.rnn_type,
            self.encoder_hidden_dim,
            self.decoder_hidden_dim,
            self.num_encoder_layers,
            self.dropout,
            dtype=self.dtype,
            name="listener",
        )
        self.attend_and_speller = AttendAndSpeller(
            self.rnn_type,
            self.vocab_size,
            self.decoder_hidden_dim,
            self.num_decoder_layers,
            self.dropout,
            self.pad_id,
            dtype=self.dtype,
            name="attend_and_speller",
        )

    # --------------------------------------------------------------- methods
    def encode(self, audio, training: bool = False):
        """Listener forward; returns [encoded, mask, *states] (for search).

        ``audio`` is [B,T,F,C] features, or a (features, frame_lengths)
        pair when the caller knows the true lengths.
        """
        audio, lengths = split_audio_lengths(audio)
        return self.listener(audio, training, lengths)

    def project_keys(self, audio_output):
        return self.attend_and_speller.project_keys(audio_output)

    def decode_step(self, audio_output, projected_keys, decoder_input, attention_mask, states):
        return self.attend_and_speller.step(
            audio_output, projected_keys, decoder_input, attention_mask, states
        )

    def decode_step_beam(self, audio_output, projected_keys, decoder_input, attention_mask, states):
        """Beam decode step over untiled listener operands (see
        AttendAndSpeller.step_beam)."""
        return self.attend_and_speller.step_beam(
            audio_output, projected_keys, decoder_input, attention_mask, states
        )

    # the train/eval steps may ask for time-major [N,B,V] logits to skip a
    # pair of [*,16000] transposes per step (fwd + its VJP twin)
    logits_time_major_supported = True

    def __call__(self, inputs: Tuple, training: bool = False, time_major_logits: bool = False):
        """(audio [B,T,F,C] | (audio, frame_lengths), decoder_input [B,N]) -> logits.

        Returns [B,N,V] (reference layout, las.py:379) or — with
        ``time_major_logits`` — the scan-native [N,B,V], which the loss and
        metrics consume layout-agnostically (the vocab-space transpose and
        its backward twin move ~1 GB/step at bench shapes).
        """
        hiddens_all = self._hiddens(inputs, training)
        # ONE [N*B,H] x [H,V] matmul for every position incl. step 0
        logits = self.attend_and_speller.feedforward(hiddens_all)
        return logits if time_major_logits else jnp.swapaxes(logits, 0, 1)

    def _hiddens(self, inputs: Tuple, training: bool = False):
        audio_input, decoder_input = inputs
        audio_input, frame_lengths = split_audio_lengths(audio_input)
        B, N = decoder_input.shape

        audio_output, attention_mask, *states = self.listener(audio_input, training, frame_lengths)
        states = tuple(states)
        projected_keys = self.attend_and_speller.project_keys(audio_output)

        dropout_masks = None
        if training and self.dropout > 0.0:
            dropout_masks = self.attend_and_speller.make_dropout_masks(
                self.make_rng("dropout"), B, audio_output.shape[-1]
            )

        # teacher forcing coin flipped once per batch (reference las.py:366).
        # Statically teacher-forced (no coin, no cond) when not training or
        # when the rate is 1.0 — the compiler then sees only the fast path.
        static_teacher_forcing = (
            not training
            or not self.has_rng("teacher_forcing")
            or self.teacher_forcing_rate >= 1.0
        )
        if static_teacher_forcing:
            use_teacher_forcing = None
        else:
            use_teacher_forcing = (
                jax.random.uniform(self.make_rng("teacher_forcing"), ()) < self.teacher_forcing_rate
            )

        # step 0 outside the scan (primes submodule parameters; first token is
        # always the given input, reference las.py:369).  Only the hidden
        # state is kept: all positions go through ONE vocab projection at the
        # end, so the step-0/rest concat happens in [*,H] instead of [*,V]
        # (a [N,B,16000] concat + its backward slice move ~1 GB/step).
        hidden0, states = self.attend_and_speller.step_hidden(
            audio_output, projected_keys, decoder_input[:, 0], attention_mask, states, dropout_masks
        )

        tokens_t = jnp.swapaxes(decoder_input[:, 1:], 0, 1)  # [N-1, B]

        # Two decoder paths selected by the per-batch coin (reference
        # las.py:366-372).  Teacher-forced (rate 0.99 in every shipped
        # config): the scan emits hidden states only and the [N*B,H] x [H,V]
        # vocab projection runs ONCE after the scan.  Feedback:
        # logits must live inside the scan for the argmax.  lax.cond executes
        # only the sampled branch at runtime.
        def teacher_forced(mdl, states):
            import os

            aas = mdl.attend_and_speller
            if mdl.rnn_type == "lstm" and os.environ.get("SRT_DECODER_CUSTOM_VJP", "1") == "1":
                # custom-VJP decoder scan (ops/decoder.py): all weight-grad
                # accumulations hoisted out of the sequential backward loop
                from ..ops.decoder import decoder_scan_lstm

                H = aas.hidden_dim
                Dv = audio_output.shape[-1]
                Bsz = audio_output.shape[0]
                emb_all = aas.embedding(decoder_input[:, 1:]).astype(mdl.dtype)
                if dropout_masks is not None:
                    emb_all = emb_all * dropout_masks["emb"][:, None, :]
                    cell_masks = tuple(dropout_masks["cells"])
                    out_mask = dropout_masks["out"]
                else:
                    cms, d = [], H + Dv
                    for _ in aas.cells:
                        cms.append(jnp.ones((Bsz, d), mdl.dtype))
                        d = H
                    cell_masks, out_mask = tuple(cms), jnp.ones((Bsz, H), mdl.dtype)
                qw, qb = aas.attention.query_params(H)
                kernels, rkernels, biases = [], [], []
                in_dim = H + Dv
                for cell in aas.cells:
                    k, r, b = cell(in_dim)
                    kernels.append(k.astype(mdl.dtype))
                    rkernels.append(r.astype(mdl.dtype))
                    biases.append(b.astype(mdl.dtype))
                    in_dim = H
                tok_mask = (tokens_t != aas.pad_id)[:, :, None].astype(mdl.dtype)
                attn_bias = -1e9 * (1.0 - attention_mask.astype(mdl.dtype))
                pk_in = projected_keys.astype(mdl.dtype)
                val_in = audio_output.astype(mdl.dtype)
                emb_t = jnp.swapaxes(emb_all, 0, 1)
                hiddens, _, _ = decoder_scan_lstm(
                    emb_t,
                    tok_mask,
                    pk_in,
                    val_in,
                    attn_bias,
                    qw,
                    qb,
                    tuple(kernels),
                    tuple(rkernels),
                    tuple(biases),
                    cell_masks,
                    out_mask,
                    states[0].astype(mdl.dtype),
                    states[1].astype(mdl.dtype),
                )
                return hiddens

            def body(states, tok_t):
                hidden, new_states = aas.step_hidden(
                    audio_output, projected_keys, tok_t, attention_mask, states, dropout_masks
                )
                return new_states, hidden

            _, hiddens = jax.lax.scan(body, states, tokens_t, unroll=_decoder_unroll())
            return hiddens

        def feedback(mdl, states):
            aas = mdl.attend_and_speller

            def body(carry, tok_t):
                states, prev_logits = carry
                tok = jnp.argmax(prev_logits, axis=-1).astype(jnp.int32)
                hidden, new_states = aas.step_hidden(
                    audio_output, projected_keys, tok, attention_mask, states, dropout_masks
                )
                # the vocab projection lives inside this branch only for the
                # argmax feedback; the emitted stream stays in hidden space
                return (new_states, aas.feedforward(hidden)), hidden

            (_, _), rest = jax.lax.scan(
                body, (states, aas.feedforward(hidden0)), tokens_t, unroll=_decoder_unroll()
            )
            return rest

        if N <= 1:
            hiddens_all = hidden0[None]
        elif use_teacher_forcing is None:
            hiddens_all = jnp.concatenate([hidden0[None], teacher_forced(self, states)], axis=0)
        else:
            rest = nn.cond(use_teacher_forcing, teacher_forced, feedback, self, states)
            hiddens_all = jnp.concatenate([hidden0[None], rest], axis=0)  # [N, B, H]
        return hiddens_all

    # ----------------------------------------------------------------- plumbing
    def get_loss_fn(self):
        pad_id = self.pad_id
        return lambda y_true, logits: sparse_categorical_crossentropy(y_true, logits, pad_id)

    def get_metrics(self):
        pad_id = self.pad_id
        fn = lambda y_true, logits: sparse_categorical_accuracy(y_true, logits, pad_id)
        return [("accuracy", fn)]

    @staticmethod
    def get_batching_shape(audio_pad_length, token_pad_length, frequency_dim, feature_dim):
        if token_pad_length is not None:
            token_pad_length = token_pad_length - 1
        return (([audio_pad_length, frequency_dim, feature_dim], [token_pad_length]), [token_pad_length])

    @staticmethod
    def make_example(audio, tokens):
        """(audio, tokens) -> ((audio, tokens[:-1]), tokens[1:]) (reference las.py:396-406)."""
        return (audio, tokens[:-1]), tokens[1:]

    @property
    def model_checkpoint_name(self) -> str:
        return "model-{epoch}epoch-{val_loss:.4f}loss_{val_accuracy:.4f}acc"
