"""Conformer-CTC model tests (beyond-parity family, models/conformer.py).

Mirrors the DS2/LAS test strategy: shape checks, exact pad-invariance on
the real prefix, and a gradient sanity check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speech_recognition_tpu.models import Conformer
from speech_recognition_tpu.models.conformer import ConvSubsampler, rope_rotate


def _mini_model(**overrides):
    kwargs = dict(
        vocab_size=30,
        encoder_dim=32,
        num_layers=2,
        num_attention_heads=2,
        conv_kernel_size=7,
        ffn_expansion=2,
        dropout=0.1,
        subsample_channels=(4, 4),
        blank_index=14,
        pad_index=0,
    )
    kwargs.update(overrides)
    return Conformer(**kwargs)


def test_subsampler_shapes_and_mask():
    rng = jax.random.PRNGKey(0)
    sub = ConvSubsampler((4, 8), 32)
    audio = jax.random.uniform(rng, (3, 64, 20, 3), minval=0.1)
    variables = sub.init(rng, audio)
    out, mask = sub.apply(variables, audio)
    t1 = (64 - 3) // 2 + 1
    t2 = (t1 - 3) // 2 + 1
    assert out.shape == (3, t2, 32)
    assert mask.shape == (3, t2) and bool(mask.all())


def test_subsampler_mask_exact_conv_arithmetic():
    rng = jax.random.PRNGKey(1)
    sub = ConvSubsampler((4,), 16)
    audio = jnp.ones((2, 32, 8, 1))
    audio = audio.at[1, 17:].set(0.0)  # second example: 17 valid frames
    variables = sub.init(rng, audio)
    _, mask = sub.apply(variables, audio)
    # a subsampled frame is valid iff its receptive field [2t, 2t+3) lies
    # entirely within real frames: floor((L-3)/2)+1
    assert int(mask[0].sum()) == (32 - 3) // 2 + 1
    assert int(mask[1].sum()) == (17 - 3) // 2 + 1


def test_rope_is_relative():
    # RoPE guarantee: q_i . k_j depends only on i - j.  Shift the position
    # of a fixed (q, k) pair and the dot product must not change.
    rng = jax.random.PRNGKey(2)
    q = jax.random.normal(rng, (1, 1, 1, 8))
    k = jax.random.normal(jax.random.PRNGKey(3), (1, 1, 1, 8))
    tile = lambda x, t: jnp.tile(x, (1, t, 1, 1))
    scores = []
    for offset in range(3):
        qr = rope_rotate(tile(q, 8))[:, 2 + offset]
        kr = rope_rotate(tile(k, 8))[:, 5 + offset]
        scores.append(float(jnp.sum(qr * kr)))
    np.testing.assert_allclose(scores[0], scores[1:], rtol=1e-5)


def test_conformer_output_shape_and_training_mode():
    rng = jax.random.PRNGKey(4)
    model = _mini_model()
    audio = jax.random.uniform(rng, (2, 50, 20, 3), minval=0.1)
    variables = model.init({"params": rng}, audio)
    out = model.apply(variables, audio)
    t1 = (50 - 3) // 2 + 1
    t2 = (t1 - 3) // 2 + 1
    assert out.shape == (2, t2, 30)

    out_t = model.apply(variables, audio, training=True, rngs={"dropout": rng})
    assert out_t.shape == out.shape
    # dropout actually fires in training mode
    assert not np.allclose(np.asarray(out_t), np.asarray(out))


def test_conformer_pad_invariance():
    """Real-prefix outputs are bit-invariant to trailing padding: the mask
    must gate attention keys and the depthwise conv against pad frames."""
    rng = jax.random.PRNGKey(5)
    model = _mini_model(dropout=0.0)
    audio = jax.random.uniform(rng, (2, 41, 12, 1), minval=0.1)
    variables = model.init({"params": rng}, audio)
    out = model.apply(variables, audio)

    pad = jnp.zeros((2, 15, 12, 1))
    out_pad = model.apply(variables, jnp.concatenate([audio, pad], axis=1))
    t_valid = out.shape[1]
    np.testing.assert_allclose(out_pad[:, :t_valid], out, rtol=1e-5, atol=1e-6)
    # padded-region logits are bias-only rows (hidden states zeroed)
    np.testing.assert_allclose(
        out_pad[:, t_valid:],
        np.broadcast_to(np.asarray(out_pad)[0, -1], out_pad[:, t_valid:].shape),
        rtol=1e-5,
        atol=1e-6,
    )


def test_conformer_internal_time_pad_equivalent(monkeypatch):
    """The encoder-internal tile-alignment pad (hidden_states pads T' to a
    multiple of TIME_PAD_MULTIPLE and slices back) must not change any
    valid-frame output: pad frames are mask-False so attention key-masks
    them and the conv module zeroes them before the depthwise conv."""
    import speech_recognition_tpu.models.conformer as conf_mod

    rng = jax.random.PRNGKey(11)
    model = _mini_model(dropout=0.0)
    audio = jax.random.uniform(rng, (2, 47, 12, 1), minval=0.1)
    audio = audio.at[1, 33:].set(0.0)  # ragged lengths through the pad path
    variables = model.init({"params": rng}, audio)

    monkeypatch.setattr(conf_mod, "TIME_PAD_GATE", 1)
    monkeypatch.setattr(conf_mod, "TIME_PAD_MULTIPLE", 16)
    out_padded = model.apply(variables, audio)  # T'=10 -> padded to 16

    monkeypatch.setattr(conf_mod, "TIME_PAD_MULTIPLE", 1)  # pad = 0
    out_plain = model.apply(variables, audio)

    np.testing.assert_allclose(
        np.asarray(out_padded), np.asarray(out_plain), rtol=1e-5, atol=1e-6
    )


def test_conformer_explicit_lengths_match_detection():
    rng = jax.random.PRNGKey(6)
    model = _mini_model(dropout=0.0)
    audio = jax.random.uniform(rng, (2, 40, 12, 1), minval=0.1)
    audio = audio.at[1, 30:].set(0.0)
    variables = model.init({"params": rng}, audio)
    out_detect = model.apply(variables, audio)
    out_explicit = model.apply(variables, (audio, jnp.array([40, 30])))
    np.testing.assert_allclose(out_explicit, out_detect, rtol=1e-5, atol=1e-6)


def test_conformer_grads_finite():
    rng = jax.random.PRNGKey(8)
    model = _mini_model(dropout=0.0)
    audio = jax.random.uniform(rng, (2, 50, 20, 3), minval=0.1)
    tokens = jnp.array([[1, 5, 9, 0], [2, 7, 0, 0]], jnp.int32)
    variables = model.init({"params": rng}, audio)
    loss_fn = model.get_loss_fn()

    def loss(params):
        logits = model.apply({"params": params}, audio)
        return loss_fn(tokens, logits)

    val, grads = jax.value_and_grad(loss)(variables["params"])
    assert np.isfinite(float(val))
    for leaf in jax.tree_util.tree_leaves(grads):
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_conformer_remat_transparent():
    """remat=True must leave the variable tree, outputs, and gradients
    unchanged — it only changes what the backward pass rematerializes."""
    rng = jax.random.PRNGKey(9)
    plain = _mini_model(dropout=0.0)
    remat = _mini_model(dropout=0.0, remat=True)
    audio = jax.random.uniform(rng, (2, 50, 20, 3), minval=0.1)
    tokens = jnp.array([[1, 5, 9, 0], [2, 7, 0, 0]], jnp.int32)
    variables = plain.init({"params": rng}, audio)
    assert jax.tree_util.tree_structure(remat.init({"params": rng}, audio)) == (
        jax.tree_util.tree_structure(variables)
    )

    out = plain.apply(variables, audio)
    out_r = remat.apply(variables, audio)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out_r))

    def loss(model, params):
        return model.get_loss_fn()(tokens, model.apply({"params": params}, audio))

    g = jax.grad(lambda p: loss(plain, p))(variables["params"])
    g_r = jax.grad(lambda p: loss(remat, p))(variables["params"])
    for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(g_r)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_conformer_scan_layers_matches_unrolled():
    """scan_layers=True is the same math: with the unrolled params stacked
    (stack_block_params) the logits and the parameter gradients must match
    the unrolled model's."""
    from speech_recognition_tpu.models.conformer import stack_block_params

    rng = jax.random.PRNGKey(12)
    unrolled = _mini_model(dropout=0.0)
    scanned = _mini_model(dropout=0.0, scan_layers=True)
    audio = jax.random.uniform(rng, (2, 50, 20, 3), minval=0.1)
    audio = audio.at[1, 37:].set(0.0)
    tokens = jnp.array([[1, 5, 9, 0], [2, 7, 0, 0]], jnp.int32)
    params_u = unrolled.init({"params": rng}, audio)["params"]
    params_s = stack_block_params(params_u, unrolled.num_layers)

    out_u = unrolled.apply({"params": params_u}, audio)
    out_s = scanned.apply({"params": params_s}, audio)
    np.testing.assert_allclose(np.asarray(out_s), np.asarray(out_u), rtol=1e-5, atol=1e-6)

    def loss(model, params):
        return model.get_loss_fn()(tokens, model.apply({"params": params}, audio))

    g_u = jax.grad(lambda p: loss(unrolled, p))(params_u)
    g_s = jax.grad(lambda p: loss(scanned, p))(params_s)
    g_u_stacked = stack_block_params(g_u, unrolled.num_layers)
    assert jax.tree_util.tree_structure(g_s) == jax.tree_util.tree_structure(g_u_stacked)
    for a, b in zip(jax.tree_util.tree_leaves(g_u_stacked), jax.tree_util.tree_leaves(g_s)):
        # rtol 1e-4: scan-vs-unrolled XLA scheduling plus the tap-sum
        # dkernel reduction order (ops/dw_conv.py) shift the last float bits
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_conformer_scan_layers_init_structure_and_roundtrip():
    """The scan model's own init matches the stacked layout exactly (tree
    structure + shapes), and stack/unstack are inverses."""
    from speech_recognition_tpu.models.conformer import (
        stack_block_params,
        unstack_block_params,
    )

    rng = jax.random.PRNGKey(13)
    unrolled = _mini_model(dropout=0.0)
    scanned = _mini_model(dropout=0.0, scan_layers=True)
    audio = jax.random.uniform(rng, (2, 40, 12, 1), minval=0.1)
    params_u = unrolled.init({"params": rng}, audio)["params"]
    params_s_init = scanned.init({"params": rng}, audio)["params"]
    params_s = stack_block_params(params_u, unrolled.num_layers)

    assert jax.tree_util.tree_structure(params_s_init) == jax.tree_util.tree_structure(params_s)
    for a, b in zip(
        jax.tree_util.tree_leaves(params_s_init), jax.tree_util.tree_leaves(params_s)
    ):
        assert a.shape == b.shape and a.dtype == b.dtype

    back = unstack_block_params(params_s, unrolled.num_layers)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params_u)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params_u)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_conformer_scan_layers_dropout_and_remat():
    """Dropout rngs split per scanned layer (training mode runs and is
    non-deterministic across keys), and remat composes inside the scan
    without changing outputs."""
    from speech_recognition_tpu.models.conformer import stack_block_params

    rng = jax.random.PRNGKey(14)
    scanned = _mini_model(scan_layers=True)
    audio = jax.random.uniform(rng, (2, 40, 12, 1), minval=0.1)
    variables = scanned.init({"params": rng}, audio)
    out_det = scanned.apply(variables, audio)
    out_a = scanned.apply(variables, audio, training=True, rngs={"dropout": jax.random.PRNGKey(1)})
    out_b = scanned.apply(variables, audio, training=True, rngs={"dropout": jax.random.PRNGKey(2)})
    assert not np.allclose(np.asarray(out_a), np.asarray(out_det))
    assert not np.allclose(np.asarray(out_a), np.asarray(out_b))

    scanned_remat = _mini_model(dropout=0.0, scan_layers=True, remat=True)
    plain = _mini_model(dropout=0.0, scan_layers=True)
    params = stack_block_params(
        _mini_model(dropout=0.0).init({"params": rng}, audio)["params"], 2
    )
    out_r = scanned_remat.apply({"params": params}, audio)
    out_p = plain.apply({"params": params}, audio)
    np.testing.assert_array_equal(np.asarray(out_r), np.asarray(out_p))

    g_p = jax.grad(lambda p: plain.apply({"params": p}, audio).sum())(params)
    g_r = jax.grad(lambda p: scanned_remat.apply({"params": p}, audio).sum())(params)
    # remat's recomputed forward re-associates a few contractions inside the
    # scan body, so grads agree to float32 noise, not bitwise
    for a, b in zip(jax.tree_util.tree_leaves(g_p), jax.tree_util.tree_leaves(g_r)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-4, atol=1e-5)


def test_conformer_config_registry(tmp_path):
    from speech_recognition_tpu.configs import get_model_config
    from speech_recognition_tpu.configs.data_config import ConfigValidationError

    from ..const import TEST_CONFORMER_CONFIG

    config = get_model_config(TEST_CONFORMER_CONFIG)
    model = config.create_model()
    assert isinstance(model, Conformer)
    assert model.encoder_dim == 32 and model.num_layers == 2

    bad = tmp_path / "bad.yml"
    bad.write_text(
        "model_name: conformer\nvocab_size: 30\nencoder_dim: 33\nnum_layers: 1\n"
        "num_attention_heads: 2\nconv_kernel_size: 7\nffn_expansion: 2\n"
        "dropout: 0.1\nsubsample_channels: [4]\nblank_index: 14\npad_index: 0\n"
    )
    with pytest.raises(ConfigValidationError):
        get_model_config(str(bad))
