"""Device-side decoding: LAS greedy/beam search and CTC greedy/beam search.

Counterpart of reference speech_recognition/search.py.  Every
decoder is a jitted static-shape program: fixed [B, max_len] token buffers
updated in-place via dynamic_update_slice inside ``lax.while_loop`` /
``lax.scan`` (the reference grew tensors per step inside tf.while_loop,
search.py:53-54).  The CTC decoders run entirely on device — the reference
fell back to TF's CPU-only ctc kernels (search.py:246-248, 279-281).

Scoring parity with the reference:
- LAS beam: score = cumulative logP x ((1 + len)/(1 + beta))^alpha
  (search.py:161-164); finished beams accumulate 0 (search.py:137-138);
  perplexity = exp(logP)^(-1/len) (search.py:78-81, 207).
- CTC greedy: path probability = exp(sum of per-frame max log-softmax)
  (the blank-remap dance at search.py:237-240 is unnecessary here because
  blank_index is passed straight to the decoder).
"""

import os
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .models import LAS, DeepSpeech2


def topk_inloop(x: jnp.ndarray, k: int):
    """Exact top-k along the last axis for use INSIDE device loops.

    k rounds of (max, first-argmax, mask) fuse into plain elementwise and
    reduction passes, which kept a TopK custom call out of the loop body on
    the machine this was first tuned for; whether ``jax.lax.top_k`` is
    faster in the GPU loop is an open A/B.  Matches ``jax.lax.top_k``
    bitwise, including tie order (both prefer lower indices; verified on
    random bf16 logits).

    :param x: [..., V]; any float dtype
    :return: (values [..., k] same dtype, indices [..., k] int32)
    """
    V = x.shape[-1]
    cols = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    neg = jnp.finfo(x.dtype).min
    vals, idxs = [], []
    for _ in range(k):
        m = jnp.max(x, axis=-1, keepdims=True)
        i = jnp.min(jnp.where(x == m, cols, V), axis=-1, keepdims=True)
        vals.append(m)
        idxs.append(i)
        x = jnp.where(cols == i, neg, x)
    return jnp.concatenate(vals, -1), jnp.concatenate(idxs, -1)


class LASSearcher:
    """Greedy / beam search over a trained LAS model (reference search.py:6-209)."""

    def __init__(self, model: LAS, variables, max_token_length: int, bos_id: int, eos_id: int, pad_id: int = 0):
        self.model = model
        self.variables = variables
        self.max_token_length = max_token_length
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._greedy = jax.jit(self._greedy_impl)
        self._beam = jax.jit(self._beam_impl, static_argnums=(1, 2, 3))

    # ------------------------------------------------------------------ common
    def _encode(self, audio_input):
        enc_out, mask, *states = self.model.apply(self.variables, audio_input, method=LAS.encode)
        keys = self.model.apply(self.variables, enc_out, method=LAS.project_keys)
        return enc_out, keys, mask, tuple(states)

    def _step(self, enc_out, keys, tokens, mask, states):
        return self.model.apply(self.variables, enc_out, keys, tokens, mask, states, method=LAS.decode_step)

    def _step_beam(self, enc_out, keys, tokens, mask, states):
        """K-beam step over UNTILED encoder operands: tokens [B,K], states
        [B*K,H] rows -> (logits [B*K,V], new_states)."""
        return self.model.apply(
            self.variables, enc_out, keys, tokens, mask, states, method=LAS.decode_step_beam
        )

    # ------------------------------------------------------------------ greedy
    def greedy_search(self, audio_input) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """:return: (tokens [B, max_token_length], perplexity [B])."""
        return self._greedy(jnp.asarray(audio_input))

    def _greedy_impl(self, audio_input):
        B = audio_input.shape[0]
        L = self.max_token_length
        enc_out, keys, mask, states = self._encode(audio_input)

        tokens = jnp.full((B, L), self.pad_id, jnp.int32).at[:, 0].set(self.bos_id)
        is_ended = jnp.zeros((B,), bool)
        log_perplexity = jnp.zeros((B,), jnp.float32)
        seq_lens = jnp.full((B,), L, jnp.int32)

        def cond(carry):
            step, tokens, is_ended, logp, seq_lens, states = carry
            return (step < L) & ~jnp.all(is_ended)

        def body(carry):
            step, tokens, is_ended, logp, seq_lens, states = carry
            last = jax.lax.dynamic_index_in_dim(tokens, step - 1, axis=1, keepdims=False)
            logits, states = self._step(enc_out, keys, last, mask, states)
            log_probs = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            new_tokens = jnp.argmax(log_probs, axis=-1).astype(jnp.int32)
            top_logp = jnp.max(log_probs, axis=-1)

            logp = jnp.where(is_ended, logp, logp + top_logp)
            new_tokens = jnp.where(is_ended, self.pad_id, new_tokens)
            newly_ended = new_tokens == self.eos_id
            seq_lens = jnp.where(newly_ended & ~is_ended, step + 1, seq_lens)
            is_ended = is_ended | newly_ended
            tokens = jax.lax.dynamic_update_index_in_dim(tokens, new_tokens, step, axis=1)
            return step + 1, tokens, is_ended, logp, seq_lens, states

        carry = (jnp.int32(1), tokens, is_ended, log_perplexity, seq_lens, states)
        _, tokens, is_ended, logp, seq_lens, _ = jax.lax.while_loop(cond, body, carry)
        perplexity = jnp.exp(logp) ** (-1.0 / seq_lens.astype(jnp.float32))
        return tokens, perplexity

    # -------------------------------------------------------------------- beam
    def beam_search(self, audio_input, beam_size: int, alpha: float = 1.0, beta: int = 32):
        """:return: (tokens [B, beam, max_token_length], perplexity [B, beam])."""
        return self._beam(jnp.asarray(audio_input), int(beam_size), alpha, beta)

    def _beam_impl(self, audio_input, beam_size: int, alpha=1.0, beta=32):
        B = audio_input.shape[0]
        K = beam_size
        L = self.max_token_length
        enc_out, keys, mask, states = self._encode(audio_input)

        # first decode step from BOS initializes the beams (reference search.py:141-153)
        logits0, states0 = self._step(enc_out, keys, jnp.full((B,), self.bos_id, jnp.int32), mask, states)
        lse0 = jax.nn.logsumexp(logits0.astype(jnp.float32), axis=-1, keepdims=True)
        top_raw0, top_tokens = jax.lax.top_k(jax.lax.optimization_barrier(logits0), K)
        top_logp = top_raw0.astype(jnp.float32) - lse0  # [B, K]

        tokens = jnp.full((B, K, L), self.pad_id, jnp.int32)
        tokens = tokens.at[:, :, 0].set(self.bos_id).at[:, :, 1].set(top_tokens)
        log_perplexity = top_logp  # [B, K]

        def tile(x):
            return jnp.repeat(x, K, axis=0)

        # Decoder states are per-beam ([B*K, H], beam-major rows); the big
        # encoder operands are NOT tiled — step_beam attends all K beams
        # over one copy (the reference tiles them K-fold, search.py:141-153,
        # which re-streams K copies of keys/values every step).
        # SRT_BEAM_UNTILED=0 restores the tiled layout for A/B.
        untiled = os.environ.get("SRT_BEAM_UNTILED", "1") == "1"
        if not untiled:
            enc_out_t, keys_t, mask_t = tile(enc_out), tile(keys), tile(mask)
        states_t = tuple(tile(s) for s in states0)

        def seq_lengths(tokens, cur_len):
            """First-EOS position + 1 else current length (reference search.py:106-116)."""
            is_eos = tokens == self.eos_id
            any_eos = jnp.any(is_eos, axis=-1)
            first = jnp.argmax(is_eos, axis=-1)
            return jnp.where(any_eos, first + 1, cur_len).astype(jnp.int32)

        def finish(tokens, logp):
            """Shared while_loop tail: pad after EOS + per-beam perplexity."""
            lens = seq_lengths(tokens, L)  # [B, K]
            pos = jnp.arange(L)[None, None, :]
            tokens = jnp.where(pos < lens[:, :, None], tokens, self.pad_id)
            perplexity = jnp.exp(logp) ** (-1.0 / lens.astype(jnp.float32))
            return tokens, perplexity

        def cond(carry):
            step, tokens, logp, states = carry
            has_eos = jnp.any(tokens == self.eos_id, axis=-1)
            return (step < L) & jnp.any(~has_eos)

        def body(carry):
            step, tokens, logp, states = carry
            last = jax.lax.dynamic_index_in_dim(tokens.reshape(B * K, L), step - 1, axis=1, keepdims=False)
            if untiled:
                logits, new_states = self._step_beam(enc_out, keys, last.reshape(B, K), mask, states)
            else:
                logits, new_states = self._step(enc_out_t, keys_t, last, mask_t, states)
            # top-k on the RAW logits, normalizing only the K winners
            # (log_softmax is monotone per row, so the selection is
            # identical but the [B*K,V] normalized tensor is never formed)
            lse = jax.nn.logsumexp(logits.astype(jnp.float32), axis=-1, keepdims=True)
            top_raw, cand_tokens = topk_inloop(logits, K)
            step_lp = top_raw.astype(jnp.float32) - lse  # [B*K, K]
            step_lp = step_lp.reshape(B, K, K)
            cand_tokens = cand_tokens.reshape(B, K, K)

            ended = jnp.any(tokens == self.eos_id, axis=-1)  # [B, K]
            step_lp = jnp.where(ended[:, :, None], 0.0, step_lp)
            cand_logp = logp[:, :, None] + step_lp  # [B, K, K]

            # candidate lengths for the length penalty
            eos_len = seq_lengths(tokens, step + 1)  # [B, K]
            cand_len = jnp.broadcast_to(eos_len[:, :, None], (B, K, K))
            penalty = ((1.0 + cand_len.astype(jnp.float32)) / (1.0 + beta)) ** alpha
            scores = (cand_logp * penalty).reshape(B, K * K)

            _, top_idx = topk_inloop(scores, K)  # [B, K]
            beam_idx = top_idx // K
            tok_idx = top_idx % K

            batch_idx = jnp.arange(B)[:, None]
            new_tok = cand_tokens[batch_idx, beam_idx, tok_idx]  # [B, K]
            sel_ended = ended[batch_idx, beam_idx]
            new_tok = jnp.where(sel_ended, self.pad_id, new_tok)

            tokens = tokens[batch_idx, beam_idx]  # [B, K, L]
            tokens = jax.lax.dynamic_update_slice_in_dim(tokens, new_tok[:, :, None], step, axis=2)
            logp = cand_logp[batch_idx, beam_idx, tok_idx]

            # REFERENCE SEMANTICS: decoder states are NOT re-gathered by the
            # selected beam ancestry — the reference's while_loop re-gathers
            # only decoder_input and log_perplexity (search.py:166-180), so
            # each slot's state keeps evolving from its own previous
            # hypothesis.  The published WER numbers were produced with this
            # behavior; beam-decode parity is pinned in
            # tests/test_model_parity.py::test_las_beam_decode_parity.
            return step + 1, tokens, logp, new_states

        carry = (jnp.int32(2), tokens, log_perplexity, states_t)
        _, tokens, logp, _ = jax.lax.while_loop(cond, body, carry)
        return finish(tokens, logp)


def ctc_greedy_decode(log_probs: jnp.ndarray, blank_index: int):
    """Greedy CTC path decode: argmax per frame, collapse repeats, drop blanks.

    :param log_probs: [B, T, V] log-softmax outputs
    :return: (tokens [B, T] left-compacted 0-padded, path log-prob [B])
    """
    B, T, V = log_probs.shape
    path = jnp.argmax(log_probs, axis=-1).astype(jnp.int32)  # [B, T]
    path_logp = jnp.sum(jnp.max(log_probs, axis=-1), axis=-1)  # [B]

    prev = jnp.concatenate([jnp.full((B, 1), -1, jnp.int32), path[:, :-1]], axis=1)
    keep = (path != prev) & (path != blank_index)
    pos = jnp.cumsum(keep, axis=1) - 1
    out = jnp.zeros((B, T + 1), jnp.int32)
    batch_idx = jnp.broadcast_to(jnp.arange(B)[:, None], (B, T))
    scatter_pos = jnp.where(keep, pos, T)
    out = out.at[batch_idx, scatter_pos].set(jnp.where(keep, path, 0))
    return out[:, :T], path_logp


class DeepSpeechSearcher:
    """CTC greedy / beam search (reference search.py:212-285).

    Model-agnostic within the CTC family: any model whose ``apply`` maps
    features to [B, T', V] logits works (DeepSpeech2, Conformer)."""

    def __init__(self, model, variables, blank_index: int):
        self.model = model
        self.variables = variables
        self.blank_index = blank_index
        self._greedy = jax.jit(self._greedy_impl)
        self._beam = jax.jit(self._beam_impl, static_argnums=(1,))

    def greedy_search(self, audio_input):
        """:return: (tokens [B, T'], probability [B])."""
        return self._greedy(jnp.asarray(audio_input))

    def _greedy_impl(self, audio_input):
        logits = self.model.apply(self.variables, audio_input)
        log_probs = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        tokens, path_logp = ctc_greedy_decode(log_probs, self.blank_index)
        return tokens, jnp.exp(path_logp)

    def beam_search(self, audio_input, beam_size: int):
        """CTC prefix beam search, fully on device.

        :return: (tokens [B, beam, T'], probability [B, beam])
        """
        return self._beam(jnp.asarray(audio_input), int(beam_size))

    def _beam_impl(self, audio_input, beam_size: int):
        logits = self.model.apply(self.variables, audio_input)
        log_probs = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        tokens, total_logp = ctc_beam_decode(log_probs, self.blank_index, beam_size)
        return tokens, jnp.exp(total_logp)


@partial(jax.jit, static_argnums=(1, 2))
def ctc_beam_decode(log_probs: jnp.ndarray, blank_index: int, beam_size: int):
    """CTC prefix beam search over log-softmax outputs.

    Per-frame candidates: each beam may stay (blank extension or repeated
    last token, probabilities merged) or expand with one of the top-P
    non-blank tokens; the K best-scoring candidates survive.  Cross-beam
    merging matches TF's CPU decoder (reference search.py:279-281 uses
    tf.nn.ctc_beam_search_decoder semantics): an expand candidate whose
    resulting prefix equals an EXISTING beam folds its mass into that
    beam's stay candidate and leaves the expand set.  Because the merge
    keeps live beam prefixes unique, two expand candidates can never
    collide with each other, so this IS the full prefix merge: with K
    covering the reachable-prefix space the result is exactly the
    exhaustive host prefix-beam (pinned by the randomized oracle tests in
    tests/test_search.py); under pruning (small K) only mass that fell
    off the beam a frame earlier is lost, same as any pruned decoder.

    :return: (tokens [B, beam, T] 0-padded, total log-prob [B, beam])
    """
    B, T, V = log_probs.shape
    K = beam_size
    P = min(max(2 * K, 8), V)  # per-frame candidate-token pruning
    NEG = jnp.float32(-1e30)

    # beam state: prefixes [B,K,T], lengths [B,K], pb/pnb [B,K] (log domain)
    prefixes = jnp.zeros((B, K, T), jnp.int32)
    lengths = jnp.zeros((B, K), jnp.int32)
    pb = jnp.broadcast_to(jnp.where(jnp.arange(K) == 0, 0.0, NEG), (B, K))  # only beam 0 active
    pnb = jnp.full((B, K), NEG)

    def lse(a, b):
        return jnp.logaddexp(a, b)

    def frame(carry, lp_t):
        prefixes, lengths, pb, pnb = carry  # lp_t: [B, V]
        blank_lp = lp_t[:, blank_index]  # [B]
        top_lp, top_tok = jax.lax.top_k(
            lp_t.at[:, blank_index].set(NEG), P
        )  # [B, P] best non-blank tokens (in-scan TopK is fine at this
        # row count; topk_inloop measured slower here — see its docstring)

        total = lse(pb, pnb)  # [B, K]
        last = jnp.take_along_axis(
            prefixes, jnp.maximum(lengths - 1, 0)[:, :, None], axis=2
        )[:, :, 0]  # [B, K]
        has_last = lengths > 0

        # stay candidates (prefix unchanged): blank from anywhere, repeat from pnb
        stay_pb = total + blank_lp[:, None]  # [B, K]
        rep_lp = jnp.take_along_axis(lp_t, jnp.where(has_last, last, 0), axis=1)
        stay_pnb = jnp.where(has_last, pnb + rep_lp, NEG)

        # expand candidates: token c appended -> [B, K, P]
        tok = jnp.broadcast_to(top_tok[:, None, :], (B, K, P))
        same_as_last = has_last[:, :, None] & (tok == last[:, :, None])
        src = jnp.where(same_as_last, pb[:, :, None], total[:, :, None])
        exp_pnb = src + top_lp[:, None, :]  # [B, K, P]

        # ---- cross-beam merge: an expand candidate (k extended by c) whose
        # prefix equals an existing beam m folds its mass into m's stay
        # candidate (TF's CPU decoder merges the same way).
        alive = total > NEG / 2  # [B, K]
        t_idx = jnp.arange(T)[None, None, None, :]
        pref_eq = jnp.all(
            (prefixes[:, :, None, :] == prefixes[:, None, :, :]) | (t_idx >= lengths[:, :, None, None]),
            axis=-1,
        )  # [B, k, m]: prefixes equal on the first len_k positions
        len_ok = lengths[:, None, :] == lengths[:, :, None] + 1  # [B, k, m]
        tok_at_lenk = jnp.take_along_axis(
            prefixes[:, None, :, :].repeat(K, 1),
            jnp.clip(lengths, 0, T - 1)[:, :, None, None],
            axis=3,
        )[..., 0]  # [B, k, m]: prefix_m[len_k]
        eq_km = pref_eq & len_ok & alive[:, None, :] & alive[:, :, None]  # [B, k, m]
        eq_kpm = eq_km[:, :, None, :] & (tok[:, :, :, None] == tok_at_lenk[:, :, None, :])  # [B,k,p,m]
        merged_any = jnp.any(eq_kpm, axis=3)  # [B, K, P]
        contrib = jax.nn.logsumexp(
            jnp.where(eq_kpm, exp_pnb[:, :, :, None], NEG), axis=(1, 2)
        )  # [B, m]
        stay_pnb = lse(stay_pnb, contrib)
        exp_pnb = jnp.where(merged_any, NEG, exp_pnb)

        # score all K + K*P candidates, pick top K
        stay_score = lse(stay_pb, stay_pnb)
        cand_scores = jnp.concatenate([stay_score, exp_pnb.reshape(B, K * P)], axis=1)
        _, sel = jax.lax.top_k(cand_scores, K)  # [B, K]

        is_stay = sel < K
        stay_idx = jnp.where(is_stay, sel, 0)
        exp_flat = jnp.where(is_stay, 0, sel - K)
        exp_beam = exp_flat // P
        exp_tok_i = exp_flat % P

        bidx = jnp.arange(B)[:, None]
        src_beam = jnp.where(is_stay, stay_idx, exp_beam)  # [B, K]
        new_prefixes = prefixes[bidx, src_beam]  # [B, K, T]
        new_lengths = lengths[bidx, src_beam]
        append_tok = top_tok[bidx, exp_tok_i]

        # append token for expand candidates: scatter along axis 2 at
        # per-beam positions via one-hot (static-shape friendly)
        pos_idx = jnp.clip(new_lengths, 0, T - 1)
        onehot = jax.nn.one_hot(pos_idx, T, dtype=jnp.int32)  # [B, K, T]
        appended_prefixes = new_prefixes * (1 - onehot) + append_tok[:, :, None] * onehot

        new_prefixes = jnp.where(is_stay[:, :, None], new_prefixes, appended_prefixes)
        new_lengths = jnp.where(is_stay, new_lengths, jnp.minimum(new_lengths + 1, T))
        new_pb = jnp.where(is_stay, stay_pb[bidx, stay_idx], NEG)
        new_pnb = jnp.where(
            is_stay, stay_pnb[bidx, stay_idx], exp_pnb[bidx, exp_beam, exp_tok_i]
        )
        return (new_prefixes, new_lengths, new_pb, new_pnb), None

    (prefixes, lengths, pb, pnb), _ = jax.lax.scan(frame, (prefixes, lengths, pb, pnb), jnp.swapaxes(log_probs, 0, 1))
    total = lse(pb, pnb)
    # zero out beyond length
    pos = jnp.arange(T)[None, None, :]
    prefixes = jnp.where(pos < lengths[:, :, None], prefixes, 0)
    return prefixes, total


class TransducerSearcher:
    """Greedy (and breadth-limited beam) RNN-T decode, fully on device.

    Standard transducer greedy loop (Graves 2012 §3.1): at lattice node
    (t, u) take the joint's argmax; blank advances time, a label advances
    the prediction network.  Static-shape jitted program: one
    ``lax.while_loop`` whose every iteration advances t or u on every
    active lane (the emit-cap forces blank once ``max_token_length`` labels
    are out, so it terminates in <= T' + L iterations per lane).

    The prediction-net steps run through ops/rnn.cell_step on raw
    parameter arrays.
    """

    def __init__(self, model, variables, max_token_length: int, bos_id: int,
                 eos_id: int, pad_id: int = 0):
        self.model = model
        self.variables = variables
        self.max_token_length = max_token_length
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._greedy = jax.jit(self._greedy_impl)
        self._beam = jax.jit(self._beam_impl, static_argnums=(1, 2))

    # ------------------------------------------------------------- plumbing
    def _pred_params(self):
        # jnp.asarray: restored checkpoints hold host numpy arrays, and
        # numpy fancy-indexing (emb[tok]) can't take a tracer
        p = self.variables["params"]
        a = lambda x, dt=self.model.dtype: jnp.asarray(x).astype(dt)
        emb = a(p["embedding"]["embedding"])
        cells = [
            (
                a(p[f"pred_layer{i}"]["cell"]["kernel"]),
                a(p[f"pred_layer{i}"]["cell"]["recurrent_kernel"]),
                a(p[f"pred_layer{i}"]["cell"]["bias"]),
            )
            for i in range(self.model.num_pred_layers)
        ]
        wp = a(p["pred_proj"]["kernel"])
        wo = a(p["joint_kernel"])
        bo = a(p["joint_bias"], jnp.float32)
        return emb, cells, wp, wo, bo

    def _pred_step(self, tok, states, emb, cells, wp):
        """One prediction-net step: [B] token ids + LSTM states ->
        (pred_proj [B, J], new states)."""
        from .ops.rnn import cell_step

        x = emb[tok]
        new_states = []
        for (k, rk, b), st in zip(cells, states):
            x_proj = x @ k + b
            x, st_new = cell_step("lstm", x_proj, st, rk, None, self.model.pred_dim)
            new_states.append(st_new)
        return x @ wp, tuple(new_states)

    # --------------------------------------------------------------- greedy
    def greedy_search(self, audio_input):
        """:return: (tokens [B, max_token_length] pad-padded, probability [B])."""
        return self._greedy(jnp.asarray(audio_input))

    def _greedy_impl(self, audio_input):
        from .models import Transducer

        enc_proj, frame_lens = self.model.apply(
            self.variables, audio_input, method=Transducer.encode
        )
        B, T, J = enc_proj.shape
        L = self.max_token_length
        emb, cells, wp, wo, bo = self._pred_params()
        H = self.model.pred_dim

        dt = enc_proj.dtype
        states0 = tuple((jnp.zeros((B, H), dt), jnp.zeros((B, H), dt)) for _ in cells)
        g0, states0 = self._pred_step(jnp.full((B,), self.bos_id, jnp.int32), states0, emb, cells, wp)

        def cond(carry):
            t, *_ = carry
            return jnp.any(t < frame_lens)

        def body(carry):
            t, u, tokens, logp, g, states = carry
            enc_t = jnp.take_along_axis(
                enc_proj, jnp.clip(t, 0, T - 1)[:, None, None], axis=1
            )[:, 0, :]
            z = jnp.tanh(enc_t + g) @ wo + bo  # [B, V] (bo is f32 -> z f32)
            lsm = jax.nn.log_softmax(z.astype(jnp.float32), axis=-1)
            tok = jnp.argmax(lsm, axis=-1).astype(jnp.int32)
            lp_tok = jnp.take_along_axis(lsm, tok[:, None], axis=1)[:, 0]

            active = t < frame_lens
            capped = u >= L
            is_eos = tok == self.eos_id
            emit = active & ~capped & (tok != self.model.blank_index) & ~is_eos

            logp = logp + jnp.where(active, lp_tok, 0.0)
            # EOS ends the lane outright; blank (or cap) advances time
            t = jnp.where(active & is_eos, frame_lens, jnp.where(active & ~emit, t + 1, t))

            write = (jnp.arange(L)[None, :] == u[:, None]) & emit[:, None]
            tokens = jnp.where(write, tok[:, None], tokens)
            u = u + emit.astype(jnp.int32)

            g_new, states_new = self._pred_step(tok, states, emb, cells, wp)
            sel = lambda new, old: jnp.where(emit[:, None], new, old)
            g = sel(g_new, g)
            states = tuple(
                (sel(hn, ho), sel(cn, co))
                for (hn, cn), (ho, co) in zip(states_new, states)
            )
            return t, u, tokens, logp, g, states

        init = (
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), jnp.int32),
            jnp.full((B, L), self.pad_id, jnp.int32),
            jnp.zeros((B,), jnp.float32),
            g0,
            states0,
        )
        t, u, tokens, logp, g, states = jax.lax.while_loop(cond, body, init)
        return tokens, jnp.exp(logp)

    # ----------------------------------------------------------------- beam
    def beam_search(self, audio_input, beam_size: int, max_symbols: int = 4):
        """Time-synchronous transducer beam search (TSD; Graves 2012 §3.2
        restricted to a fixed per-frame expansion budget, the static-shape
        form the n-best literature calls TSD-with-max-sym-exp).

        Per encoder frame, ``max_symbols`` counts JOINT EVALUATIONS, not
        emitted labels: each of the ``max_symbols`` rounds scores the joint
        once ([B, K, V] — one matmul) and moves blank/EOS continuations
        into the frame's *done* pool, but only the first ``max_symbols - 1``
        rounds also keep the top-K label extensions as the next *active*
        pool — the final round is blank/EOS-only, so at most
        ``max_symbols - 1`` labels are emitted per frame (the CLI default 4
        allows 3 labels/frame; the max_sym_exp convention in the n-best
        literature counts labels, i.e. equals ``max_symbols - 1`` here).
        The whole search is one ``lax.scan`` over frames with [B, K, ...]
        carries — fixed shapes, no host round-trips.

        Scores are raw single-alignment log-probabilities (no length
        normalization, no prefix recombination — hypotheses that emit the
        same labels along different alignments stay distinct, matching the
        common production TSD simplification).

        :return: (tokens [B, beam_size, max_token_length] sorted best-first,
                  probability [B, beam_size]).
        """
        return self._beam(jnp.asarray(audio_input), int(beam_size), int(max_symbols))

    def _beam_impl(self, audio_input, beam_size: int, max_symbols: int):
        from .models import Transducer

        enc_proj, frame_lens = self.model.apply(
            self.variables, audio_input, method=Transducer.encode
        )
        B, T, J = enc_proj.shape
        K = beam_size
        L = self.max_token_length
        emb, cells, wp, wo, bo = self._pred_params()
        H = self.model.pred_dim
        dt = enc_proj.dtype
        NEG = jnp.float32(-1e30)

        kv = min(K, self.model.vocab_size)  # label fanout per hypothesis

        def joint_scores(enc_t, c_g):
            """One joint evaluation for every live hypothesis:
            (blank_lp, eos_lp, label top-k lp, label top-k ids)."""
            hid = jnp.tanh(enc_t[:, None, :] + c_g)  # [B, K, J] dt
            z = hid @ wo + bo  # [B, K, V] f32
            lsm = jax.nn.log_softmax(z.astype(jnp.float32), axis=-1)
            lab = lsm.at[..., self.model.blank_index].set(NEG)
            lab = lab.at[..., self.eos_id].set(NEG)
            if self.pad_id != self.model.blank_index:
                lab = lab.at[..., self.pad_id].set(NEG)
            top_lp, top_id = jax.lax.top_k(lab, kv)  # [B, K, kv]
            return (
                lsm[..., self.model.blank_index],
                lsm[..., self.eos_id],
                top_lp,
                top_id.astype(jnp.int32),
            )

        # beam slot 0 holds the BOS hypothesis; the rest start dead
        g0, st0 = self._pred_step(jnp.full((B,), self.bos_id, jnp.int32),
                                  tuple((jnp.zeros((B, H), dt), jnp.zeros((B, H), dt)) for _ in cells),
                                  emb, cells, wp)
        score0 = jnp.where(jnp.arange(K)[None, :] == 0, 0.0, NEG) * jnp.ones((B, 1))
        carry0 = (
            score0,                                        # [B, K] log p
            jnp.zeros((B, K), bool),                       # fin: EOS taken
            jnp.full((B, K, L), self.pad_id, jnp.int32),   # emitted labels
            jnp.zeros((B, K), jnp.int32),                  # u: emit count
            jnp.broadcast_to(g0[:, None, :], (B, K, J)),   # pred_proj
            tuple((jnp.broadcast_to(h[:, None, :], (B, K, H)),
                   jnp.broadcast_to(c[:, None, :], (B, K, H))) for h, c in st0),
        )

        def gather(x, idx):
            """Gather beam rows: x [B, K, ...] by idx [B, K']."""
            full = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
            return jnp.take_along_axis(x, full.astype(jnp.int32), axis=1)

        def frame(carry, xs):
            enc_t, t = xs  # [B, J], scalar
            c_score, c_fin, c_tokens, c_u, c_g, c_states = carry
            frame_on = t < frame_lens  # [B]

            # frame-done pool (blank taken / carried); starts empty
            d = None

            for e in range(max_symbols):
                blank_lp, eos_lp, top_lp, top_id = joint_scores(enc_t, c_g)
                live = frame_on[:, None] & ~c_fin & (c_score > NEG / 2)

                # blank finishes the frame; EOS finishes the hypothesis;
                # dead-frame / finished hyps carry unchanged (score + 0)
                blank_sc = c_score + jnp.where(live, blank_lp, 0.0)
                eos_sc = jnp.where(live, c_score + eos_lp, NEG)
                cand_score = jnp.concatenate([blank_sc, eos_sc], axis=1)      # [B, 2K]
                cand_fin = jnp.concatenate([c_fin, jnp.ones_like(c_fin)], axis=1)
                if d is not None:
                    cand_score = jnp.concatenate([d[0], cand_score], axis=1)
                    cand_fin = jnp.concatenate([d[1], cand_fin], axis=1)
                d_score, d_idx = jax.lax.top_k(cand_score, K)
                if d is None:
                    # parents of the 2K candidates are cur[idx % K]
                    parent = d_idx % K
                    d = (d_score, jnp.take_along_axis(cand_fin, d_idx, axis=1),
                         gather(c_tokens, parent), gather(c_u, parent),
                         gather(c_g, parent),
                         tuple((gather(h, parent), gather(c, parent)) for h, c in c_states))
                else:
                    # first K candidates are the old pool, rest map to cur
                    from_pool = d_idx < K
                    parent = jnp.where(from_pool, d_idx, (d_idx - K) % K)
                    pick = lambda pool_x, cur_x: jnp.where(
                        from_pool.reshape(from_pool.shape + (1,) * (cur_x.ndim - 2)),
                        gather(pool_x, parent), gather(cur_x, parent))
                    d = (d_score, jnp.take_along_axis(cand_fin, d_idx, axis=1),
                         pick(d[2], c_tokens), pick(d[3], c_u), pick(d[4], c_g),
                         tuple((pick(ph, ch), pick(pc, cc))
                               for (ph, pc), (ch, cc) in zip(d[5], c_states)))

                if e == max_symbols - 1:
                    break  # budget exhausted: remaining actives were forced blank above

                # label extensions -> new active pool (top_lp/top_id hold
                # the per-hypothesis label candidates, blank/eos/pad masked)
                can_lab = live & (c_u < L)
                kw = top_lp.shape[-1]  # kv
                lab_sc = jnp.where(can_lab[:, :, None], c_score[:, :, None] + top_lp, NEG)
                n_score, flat = jax.lax.top_k(lab_sc.reshape(B, K * kw), K)
                parent = flat // kw
                n_tok = jnp.take_along_axis(
                    top_id.reshape(B, K * kw), flat, axis=1).astype(jnp.int32)  # [B, K]
                n_u = gather(c_u, parent)
                n_tokens = gather(c_tokens, parent)
                write = jnp.arange(L)[None, None, :] == n_u[:, :, None]
                n_tokens = jnp.where(write & (n_score > NEG / 2)[:, :, None],
                                     n_tok[:, :, None], n_tokens)
                p_states = tuple((gather(h, parent).reshape(B * K, H),
                                  gather(c, parent).reshape(B * K, H))
                                 for h, c in c_states)
                n_g, n_states = self._pred_step(n_tok.reshape(B * K), p_states, emb, cells, wp)
                c_score, c_fin = n_score, jnp.zeros((B, K), bool)
                c_tokens, c_u = n_tokens, n_u + (n_score > NEG / 2).astype(jnp.int32)
                c_g = n_g.reshape(B, K, J)
                c_states = tuple((h.reshape(B, K, H), c.reshape(B, K, H)) for h, c in n_states)

            return d, None

        final, _ = jax.lax.scan(
            frame, carry0,
            (jnp.swapaxes(enc_proj, 0, 1), jnp.arange(T, dtype=jnp.int32)),
        )
        f_score, _, f_tokens, _, _, _ = final
        order_score, order = jax.lax.top_k(f_score, K)
        return gather(f_tokens, order), jnp.exp(order_score)
