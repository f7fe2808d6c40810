"""Losses and metrics (pure functions over logits).

Counterpart of reference speech_recognition/measure.py.  All
reductions are computed in float32 regardless of the model's compute dtype
(the reference casts to fp32 the same way, measure.py:39).
"""

from typing import Tuple

import jax
import jax.numpy as jnp


def sparse_categorical_crossentropy(y_true, logits, ignore_index: int = 0):
    """Masked sparse CE from logits, averaged over non-pad positions
    (reference measure.py:4-21: boolean_mask + SUM_OVER_BATCH_SIZE).

    Computed as logsumexp(logits) - logits[y] rather than via log_softmax:
    mathematically identical, but log_softmax materializes a full [B, N, V]
    float32 tensor that the fused reduction + gather form never writes to
    device memory.
    """
    y = y_true[..., None].astype(jnp.int32)
    lse = jax.scipy.special.logsumexp(logits.astype(jnp.float32), axis=-1)
    gathered = jnp.take_along_axis(logits, y, axis=-1)[..., 0].astype(jnp.float32)
    nll = lse - gathered
    mask = (y_true != ignore_index).astype(jnp.float32)
    return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1.0)


def sparse_categorical_accuracy(y_true, logits, ignore_index: int = 0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Masked accuracy as (correct_sum, count) for streaming aggregation
    (reference measure.py:45-69)."""
    pred = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    mask = y_true != ignore_index
    correct = jnp.sum(jnp.where(mask, (pred == y_true).astype(jnp.float32), 0.0))
    count = jnp.sum(mask.astype(jnp.float32))
    return correct, count


_NEG = -1e30


@jax.custom_vjp
def _emission_logprobs(logits, ids):
    """log softmax(logits) gathered at ``ids`` -> [B, T, K].

    Forward is a fused lse + tiny gather.  The custom backward replaces the
    gather's transpose — a scatter-add into [B, T, V] — with a one-hot
    batched matmul, plus the softmax term from the lse.  Whether the
    scatter-add or the matmul is faster on the GPU is an open A/B.
    """
    lse = jax.scipy.special.logsumexp(logits.astype(jnp.float32), axis=-1)
    vals = jnp.take_along_axis(logits, ids[:, None, :], axis=2).astype(jnp.float32)
    return vals - lse[..., None]


def _emission_logprobs_fwd(logits, ids):
    lse = jax.scipy.special.logsumexp(logits.astype(jnp.float32), axis=-1)
    vals = jnp.take_along_axis(logits, ids[:, None, :], axis=2).astype(jnp.float32)
    return vals - lse[..., None], (logits, ids, lse)


def _emission_logprobs_bwd(residuals, dvals):
    import numpy as np

    logits, ids, lse = residuals
    V = logits.shape[-1]
    dlse = -jnp.sum(dvals, axis=-1)  # [B,T]
    softmax = jnp.exp(logits.astype(jnp.float32) - lse[..., None])
    onehot = (ids[:, :, None] == jnp.arange(V)[None, None, :]).astype(jnp.float32)
    dlogits = jnp.einsum("btk,bkv->btv", dvals, onehot) + softmax * dlse[..., None]
    return dlogits.astype(logits.dtype), np.zeros(ids.shape, jax.dtypes.float0)


_emission_logprobs.defvjp(_emission_logprobs_fwd, _emission_logprobs_bwd)


def ctc_negative_log_likelihood(y_true, logits, blank_index: int, pad_index: int = 0):
    """Per-sequence CTC -log P(y | logits), full padded T as logit length.

    Own log-space forward DP instead of optax.ctc_loss: optax materializes
    log_softmax over the whole [B, T, V] vocabulary (and again in
    backward); only the blank and the N label
    log-probs are ever needed, so compute lse as one fused reduction and
    gather [B, T, N+1] values.  Numerical equivalence with optax is tested
    (tests/models/test_deepspeech2.py).
    """
    B = logits.shape[0]
    y = y_true.astype(jnp.int32)
    ids = jnp.concatenate([y, jnp.full((B, 1), blank_index, jnp.int32)], axis=1)
    emission = _emission_logprobs(logits, ids)  # [B,T,N+1]
    return _ctc_nll_from_emission(y, emission, pad_index)


def _ctc_nll_from_emission(y, emission, pad_index: int):
    """CTC forward DP given emission log-probs [B, T, N+1] (labels then
    blank as the last column)."""
    B, T, _ = emission.shape
    N = y.shape[1]
    lab_lp = emission[..., :N]
    blank_lp = emission[..., N]

    # augmented label sequence z = [blank, y1, blank, y2, ..., blank], S=2N+1.
    # skip transition s-2 -> s allowed only at odd s>=3 with y[k] != y[k-1].
    S = 2 * N + 1
    odd = jnp.arange(S) % 2 == 1
    same_prev = jnp.concatenate(
        [jnp.zeros((B, 1), bool), y[:, 1:] == y[:, :-1]], axis=1
    )  # [B,N]: label k equals label k-1
    skip_ok = jnp.zeros((B, S), bool).at[:, 3::2].set(~same_prev[:, 1:])

    def emissions():
        e = jnp.zeros((B, T, S), jnp.float32)
        e = e.at[:, :, 0::2].set(blank_lp[:, :, None])
        e = e.at[:, :, 1::2].set(lab_lp)
        return e

    e_all = emissions()
    alpha0 = jnp.full((B, S), _NEG, jnp.float32)
    alpha0 = alpha0.at[:, 0].set(e_all[:, 0, 0])
    alpha0 = alpha0.at[:, 1].set(e_all[:, 0, 1])

    neg = jnp.full((B, 1), _NEG, jnp.float32)

    def step(alpha, e_t):
        a1 = jnp.concatenate([neg, alpha[:, :-1]], axis=1)
        a2 = jnp.concatenate([neg, neg, alpha[:, :-2]], axis=1)
        a2 = jnp.where(skip_ok, a2, _NEG)
        new = e_t + jnp.logaddexp(jnp.logaddexp(alpha, a1), a2)
        return new, None

    alpha, _ = jax.lax.scan(step, alpha0, jnp.swapaxes(e_all, 0, 1)[1:])

    label_lengths = jnp.sum((y != pad_index).astype(jnp.int32), axis=-1)  # [B]
    idx_last = jnp.clip(2 * label_lengths, 0, S - 1)
    idx_prev = jnp.clip(2 * label_lengths - 1, 0, S - 1)
    ll = jnp.logaddexp(
        jnp.take_along_axis(alpha, idx_last[:, None], axis=1)[:, 0],
        jnp.take_along_axis(alpha, idx_prev[:, None], axis=1)[:, 0],
    )
    return -ll, label_lengths.astype(jnp.float32)


def ctc_loss(y_true, logits, blank_index: int, pad_index: int = 0):
    """CTC loss normalized by label length, averaged over valid rows
    (reference measure.py:24-42: full padded time as logit length).

    Rows with an empty label (all pad) are batch padding — short final
    batches are padded up to the static batch size with zero rows — and
    contribute neither loss nor gradient; the mean is taken over real rows
    only, matching the reference where padded rows never exist.

    :param y_true: [B, N] int labels, pad_index-padded
    :param logits: [B, T, V] float logits
    """
    per_seq, label_lengths = ctc_negative_log_likelihood(y_true, logits, blank_index, pad_index)
    return _ctc_normalize(per_seq, label_lengths)


def _ctc_normalize(per_seq, label_lengths):
    valid_row = (label_lengths > 0).astype(jnp.float32)
    per_seq = per_seq / jnp.maximum(label_lengths, 1.0) * valid_row
    return jnp.sum(per_seq) / jnp.maximum(jnp.sum(valid_row), 1.0)
