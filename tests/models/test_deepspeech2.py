"""DeepSpeech2 model tests (mirrors reference tests/models/test_deepspeech2.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_tpu.models import DeepSpeech2
from speech_recognition_tpu.models.deepspeech2 import Convolution, Recurrent


def test_convolution_shapes_and_mask():
    rng = jax.random.PRNGKey(0)
    conv = Convolution(2, (4, 8), ((11, 5), (7, 3)), ((2, 2), (2, 1)))
    audio = jax.random.uniform(rng, (3, 64, 20, 3), minval=0.1)
    variables = conv.init(rng, audio)
    out, mask = conv.apply(variables, audio)
    t1 = (64 - 11) // 2 + 1
    t2 = (t1 - 7) // 2 + 1
    f1 = (20 - 5) // 2 + 1
    f2 = (f1 - 3) // 1 + 1
    assert out.shape == (3, t2, f2 * 8)
    assert mask.shape == (3, t2) and bool(mask.all())


def test_convolution_mask_tracks_lengths():
    rng = jax.random.PRNGKey(1)
    conv = Convolution(1, (4,), ((5, 3),), ((2, 2),))
    audio = jnp.ones((2, 32, 8, 1))
    # second example: only first 16 frames valid
    audio = audio.at[1, 16:].set(0.0)
    variables = conv.init(rng, audio)
    _, mask = conv.apply(variables, audio)
    # reference-intended collapse: min(ceil(L / time_stride_prod), T_out)
    t_out = (32 - 5) // 2 + 1
    assert int(mask[0].sum()) == t_out
    assert int(mask[1].sum()) == min((16 + 1) // 2, t_out)


@pytest.mark.parametrize("rnn_type", ["rnn", "lstm", "gru"])
def test_recurrent_pad_invariance(rnn_type):
    rng = jax.random.PRNGKey(2)
    rec = Recurrent(rnn_type, 2, 16)
    x = jax.random.normal(rng, (2, 10, 8))
    mask = jnp.ones((2, 10), bool)
    variables = rec.init(rng, x, mask)
    out = rec.apply(variables, x, mask)
    assert out.shape == (2, 10, 32)

    x_pad = jnp.concatenate([x, jax.random.normal(rng, (2, 4, 8))], axis=1)
    mask_pad = jnp.concatenate([mask, jnp.zeros((2, 4), bool)], axis=1)
    out_pad = rec.apply(variables, x_pad, mask_pad)
    np.testing.assert_allclose(out_pad[:, :10], out, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "rnn_type,vocab,batch,audio_len,audio_dim",
    [("gru", 64, 2, 50, 20), ("lstm", 111, 3, 64, 16)],
)
def test_deepspeech2_output_shape(rnn_type, vocab, batch, audio_len, audio_dim):
    rng = jax.random.PRNGKey(3)
    model = DeepSpeech2(
        2, (4, 8), ((11, 5), (7, 3)), ((2, 2), (2, 1)), rnn_type, 2, 16, 0.1, 0.0, vocab, 14
    )
    audio = jax.random.uniform(rng, (batch, audio_len, audio_dim, 3), minval=0.1)
    variables = model.init({"params": rng}, audio)
    out = model.apply(variables, audio)
    t1 = (audio_len - 11) // 2 + 1
    t2 = (t1 - 7) // 2 + 1
    assert out.shape == (batch, t2, vocab)

    out_t, mutated = model.apply(
        variables, audio, training=True, rngs={"dropout": rng}, mutable=["batch_stats"]
    )
    assert out_t.shape == out.shape and "batch_stats" in mutated


def test_deepspeech2_ctc_loss():
    rng = jax.random.PRNGKey(4)
    model = DeepSpeech2(1, (4,), ((11, 5),), ((2, 2),), "gru", 1, 16, 0.0, 0.0, 30, 14)
    audio = jax.random.uniform(rng, (2, 64, 12, 1), minval=0.1)
    variables = model.init({"params": rng}, audio)
    logits = model.apply(variables, audio)
    labels = jnp.array([[5, 6, 7, 0, 0], [3, 4, 0, 0, 0]], jnp.int32)
    loss = model.get_loss_fn()(labels, logits)
    assert np.isfinite(float(loss)) and float(loss) > 0
    assert model.get_metrics() == []


def test_ctc_nll_matches_optax():
    """Our gather-based CTC forward DP must match optax.ctc_loss exactly
    (same blank conventions, repeated labels, full-T logit lengths) — for
    values AND gradients."""
    import optax

    from speech_recognition_tpu.measure import ctc_negative_log_likelihood

    rng = jax.random.PRNGKey(13)
    B, T, V, N = 4, 17, 30, 6
    logits = jax.random.normal(rng, (B, T, V))
    labels = jnp.array(
        [
            [5, 5, 7, 2, 0, 0],  # repeated label (skip-transition edge)
            [3, 4, 3, 4, 3, 4],  # full length
            [9, 0, 0, 0, 0, 0],  # single label
            [14, 1, 2, 3, 4, 5],  # includes the blank id as a label-adjacent value
        ],
        jnp.int32,
    )

    def ours(lg):
        nll, _ = ctc_negative_log_likelihood(labels, lg, blank_index=14)
        return nll

    def theirs(lg):
        label_pad = (labels == 0).astype(jnp.float32)
        logit_pad = jnp.zeros((B, T), jnp.float32)
        return optax.ctc_loss(lg.astype(jnp.float32), logit_pad, labels, label_pad, blank_id=14)

    np.testing.assert_allclose(np.asarray(ours(logits)), np.asarray(theirs(logits)), rtol=1e-5, atol=1e-5)
    g_ours = jax.grad(lambda lg: ours(lg).sum())(logits)
    g_theirs = jax.grad(lambda lg: theirs(lg).sum())(logits)
    np.testing.assert_allclose(np.asarray(g_ours), np.asarray(g_theirs), rtol=1e-4, atol=1e-5)


def test_ctc_loss_ignores_padded_rows():
    """Zero rows appended by pad_to_batch must contribute neither loss nor
    gradient (reference semantics: padded rows never exist, measure.py:24-42)."""
    from speech_recognition_tpu.measure import ctc_loss

    rng = jax.random.PRNGKey(7)
    logits = jax.random.normal(rng, (2, 20, 30))
    labels = jnp.array([[5, 6, 7, 0, 0], [3, 4, 0, 0, 0]], jnp.int32)
    loss_real = ctc_loss(labels, logits, blank_index=14)

    # pad the batch with two all-zero rows (short final batch, static shapes)
    logits_pad = jnp.concatenate([logits, jnp.zeros((2, 20, 30))])
    labels_pad = jnp.concatenate([labels, jnp.zeros((2, 5), jnp.int32)])
    loss_pad = ctc_loss(labels_pad, logits_pad, blank_index=14)
    np.testing.assert_allclose(float(loss_real), float(loss_pad), rtol=1e-6)

    # gradient w.r.t. the padded logit rows must be exactly zero
    grad = jax.grad(lambda lg: ctc_loss(labels_pad, lg, blank_index=14))(logits_pad)
    assert float(jnp.abs(grad[2:]).max()) == 0.0
    assert float(jnp.abs(grad[:2]).max()) > 0.0


def test_deepspeech2_explicit_lengths():
    """(features, frame_lengths) input must override zero-frame detection."""
    rng = jax.random.PRNGKey(8)
    model = DeepSpeech2(1, (4,), ((11, 5),), ((2, 2),), "gru", 1, 16, 0.0, 0.0, 30, 14)
    audio = jax.random.uniform(rng, (2, 64, 12, 1), minval=0.1)
    # zero some interior frames (as SpecAugment time masks would)
    audio = audio.at[:, 20:30].set(0.0)
    audio = audio.at[1, 48:].set(0.0)  # example 1 really ends at 48
    lengths = jnp.array([64, 48], jnp.int32)
    variables = model.init({"params": rng}, audio)
    out_explicit = model.apply(variables, (audio, lengths))
    # full-length input without interior zeros -> same mask as explicit lengths
    audio_clean = audio.at[:, 20:30].set(0.5)
    out_clean_mask = model.apply(variables, (audio_clean, lengths))
    assert out_explicit.shape == out_clean_mask.shape


def test_deepspeech2_example_plumbing():
    audio = np.zeros((10, 4, 1), np.float32)
    tokens = np.arange(5, dtype=np.int32)
    a, y = DeepSpeech2.make_example(audio, tokens)
    assert a is audio and y is tokens
    assert DeepSpeech2.get_batching_shape(100, 20, 80, 3) == ([100, 80, 3], [20])
