"""Pruned (banded) RNN-T lattice: band construction, banded-joint parity
with the dense joint, the path-subset loss law, the brute-force oracle on
NEG-floored planes.

The pruned objective restricts each frame to an s_range-wide label band
(ops/transducer_pruned.py); correctness decomposes into
(a) the band covers the path endpoints (band_offsets properties),
(b) the banded joint equals the dense joint gathered on the band
    (values and all gradients),
(c) the NEG-floored dense planes drive the UNCHANGED lattice DP to the
    pruned path sum (oracle + the upper-bound law vs the dense loss).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from speech_recognition_tpu.ops.transducer import (
    _NEG,
    joint_log_planes,
    joint_log_planes_dense,
    transducer_loss,
    transducer_loss_oracle,
)
from speech_recognition_tpu.ops.transducer_pruned import (
    band_offsets,
    band_to_dense,
    banded_joint_planes,
    pruned_log_planes,
)

bf = jnp.bfloat16


def _case(seed, B, T, J, U1, V, dtype=jnp.float32):
    rng = np.random.RandomState(seed)
    enc = jnp.asarray(rng.randn(B, T, J).astype(np.float32) * 0.4, dtype)
    pred = jnp.asarray(rng.randn(B, U1, J).astype(np.float32) * 0.4, dtype)
    wo = jnp.asarray(rng.randn(J, V).astype(np.float32) * 0.3, dtype)
    bo = jnp.asarray(rng.randn(V).astype(np.float32) * 0.1, dtype)
    ids = jnp.asarray(rng.randint(1, V, (B, U1 - 1)), jnp.int32)
    frame_lens = jnp.asarray(rng.randint(max(T // 2, 1), T + 1, (B,)), jnp.int32)
    label_lens = jnp.asarray(rng.randint(1, U1, (B,)), jnp.int32)
    return enc, pred, wo, bo, ids, frame_lens, label_lens


# ------------------------------------------------------------ band offsets


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("s_range", [2, 4, 8])
def test_band_offsets_properties(seed, s_range):
    rng = np.random.RandomState(seed)
    B, T, U1 = 16, 23, 17
    frame_lens = jnp.asarray(rng.randint(1, T + 1, (B,)), jnp.int32)
    label_lens = jnp.asarray(rng.randint(0, U1, (B,)), jnp.int32)
    p = np.asarray(band_offsets(frame_lens, label_lens, T, s_range))
    fl, ll = np.asarray(frame_lens), np.asarray(label_lens)
    assert (p[:, 0] == 0).all(), "path start (0, 0) must be in band"
    assert (np.diff(p, axis=1) >= 0).all(), "band must be monotone"
    top = np.maximum(ll + 1 - s_range, 0)
    assert (p <= top[:, None]).all() and (p >= 0).all()
    # terminal coverage holds whenever a band path can exist at all (rows
    # with more labels than an S-wide band over T_b frames can carry are
    # legitimately pruned to +inf — the loss filters them)
    feasible = (ll <= s_range - 1) | (
        (fl > 1) & (ll + 1 - s_range <= (fl - 1) * (s_range - 1))
    )
    assert feasible.any()
    for b in range(B):
        if not feasible[b]:
            continue
        last = p[b, fl[b] - 1]
        assert last <= ll[b] <= last + s_range - 1, "terminal node must be in band"


def test_band_to_dense_roundtrip_and_grad():
    rng = np.random.RandomState(0)
    B, T, S, W = 3, 5, 2, 7
    band = jnp.asarray(rng.randn(B, T, S).astype(np.float32))
    p = jnp.asarray(rng.randint(0, W - S + 1, (B, T)), jnp.int32)
    dense = band_to_dense(band, p, W)
    d = np.asarray(dense)
    pb = np.asarray(p)
    for b in range(B):
        for t in range(T):
            for u in range(W):
                s = u - pb[b, t]
                want = band[b, t, s] if 0 <= s < S else _NEG
                assert d[b, t, u] == pytest.approx(float(want))
    # gradient transpose: every band slot receives exactly its dense cot
    cot = jnp.asarray(rng.randn(B, T, W).astype(np.float32))
    g = jax.grad(lambda x: jnp.sum(band_to_dense(x, p, W) * cot))(band)
    g = np.asarray(g)
    for b in range(B):
        for t in range(T):
            for s in range(S):
                u = pb[b, t] + s
                want = float(cot[b, t, u]) if u < W else 0.0
                assert g[b, t, s] == pytest.approx(want)


# ---------------------------------------------- banded joint vs dense joint


@pytest.mark.parametrize("seed,s_range", [(0, 2), (1, 3), (2, 5)])
def test_banded_joint_matches_dense_gather(seed, s_range):
    """banded_joint_planes == joint_log_planes_dense gathered on the band,
    values and all four gradients (f32, tight tolerance)."""
    B, T, J, U1, V = 3, 6, 8, 5, 32
    enc, pred, wo, bo, ids, frame_lens, label_lens = _case(seed, B, T, J, U1, V)
    p = band_offsets(frame_lens, label_lens, T, s_range)
    u_true = np.asarray(p)[:, :, None] + np.arange(s_range)[None, None, :]
    valid_e = jnp.asarray(u_true <= U1 - 2)  # emit slots need u <= U - 1
    rng = np.random.RandomState(seed + 7)
    cb = jnp.asarray(rng.randn(B, T, s_range).astype(np.float32))
    ce = jnp.asarray(rng.randn(B, T, s_range).astype(np.float32)) * valid_e

    def banded_scalar(enc, pred, wo, bo):
        lpb, lpe = banded_joint_planes(0, s_range, enc, pred, wo, bo, ids, p)
        return jnp.sum(lpb * cb) + jnp.sum(lpe * ce)

    def dense_scalar(enc, pred, wo, bo):
        lpb, lpe = joint_log_planes_dense(0, enc, pred, wo, bo, ids)
        idx = jnp.clip(p[:, :, None] + jnp.arange(s_range), 0, U1 - 1)
        gb = jnp.take_along_axis(lpb, idx, axis=2)
        ge = jnp.take_along_axis(
            jnp.pad(lpe, ((0, 0), (0, 0), (0, 1))), idx, axis=2
        )
        return jnp.sum(gb * cb) + jnp.sum(ge * ce)

    lb, gb_ = jax.value_and_grad(banded_scalar, argnums=(0, 1, 2, 3))(enc, pred, wo, bo)
    ld, gd = jax.value_and_grad(dense_scalar, argnums=(0, 1, 2, 3))(enc, pred, wo, bo)
    assert float(lb) == pytest.approx(float(ld), rel=1e-5)
    for name, a, b in zip(("enc", "pred", "wo", "bo"), gd, gb_):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=0,
            atol=1e-5 * (np.abs(np.asarray(a)).max() + 1.0), err_msg=name,
        )


# -------------------------------------------------------- pruned loss laws


def _loss_from_planes(lpb, lpe, frame_lens, label_lens):
    return transducer_loss(lpb, lpe, frame_lens, label_lens)


def test_pruned_equals_dense_when_band_covers_everything():
    B, T, J, U1, V = 3, 6, 8, 4, 32
    enc, pred, wo, bo, ids, frame_lens, label_lens = _case(3, B, T, J, U1, V)
    lpb_d, lpe_d = joint_log_planes(0, enc, pred, wo, bo, ids)
    loss_d = _loss_from_planes(lpb_d, lpe_d, frame_lens, label_lens)
    lpb_p, lpe_p = pruned_log_planes(
        0, U1, enc, pred, wo, bo, ids, frame_lens, label_lens
    )
    loss_p = _loss_from_planes(lpb_p, lpe_p, frame_lens, label_lens)
    np.testing.assert_allclose(
        np.asarray(loss_p), np.asarray(loss_d), rtol=1e-6, atol=1e-5
    )


@pytest.mark.parametrize("s_range", [2, 3])
def test_pruned_upper_bounds_dense_loss(s_range):
    """The pruned objective sums a SUBSET of the dense loss's paths, so its
    NLL can never be lower."""
    for seed in range(4):
        B, T, J, U1, V = 4, 7, 8, 5, 32
        enc, pred, wo, bo, ids, frame_lens, label_lens = _case(seed, B, T, J, U1, V)
        lpb_d, lpe_d = joint_log_planes(0, enc, pred, wo, bo, ids)
        loss_d = np.asarray(_loss_from_planes(lpb_d, lpe_d, frame_lens, label_lens))
        lpb_p, lpe_p = pruned_log_planes(
            0, s_range, enc, pred, wo, bo, ids, frame_lens, label_lens
        )
        loss_p = np.asarray(_loss_from_planes(lpb_p, lpe_p, frame_lens, label_lens))
        assert (loss_p >= loss_d - 1e-4).all(), (seed, loss_p, loss_d)
        assert np.isfinite(loss_p).all()


def test_pruned_loss_matches_path_enumeration_oracle():
    """The lattice DP over NEG-floored banded planes must equal brute-force
    path enumeration (which drops floored paths by probability underflow)."""
    B, T, J, U1, V, S = 3, 5, 8, 4, 32, 2
    enc, pred, wo, bo, ids, frame_lens, label_lens = _case(11, B, T, J, U1, V)
    lpb, lpe = pruned_log_planes(0, S, enc, pred, wo, bo, ids, frame_lens, label_lens)
    # oracle needs in-range planes only; it enumerates within (T_b, U_b)
    got = np.asarray(_loss_from_planes(lpb, lpe, frame_lens, label_lens))
    want = transducer_loss_oracle(
        np.asarray(lpb, np.float64), np.asarray(lpe, np.float64),
        np.asarray(frame_lens), np.asarray(label_lens),
    )
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_pruned_loss_gradients_flow_and_are_finite():
    B, T, J, U1, V, S = 2, 6, 8, 5, 32, 3
    enc, pred, wo, bo, ids, frame_lens, label_lens = _case(21, B, T, J, U1, V)

    def loss(enc, pred, wo, bo):
        lpb, lpe = pruned_log_planes(
            0, S, enc, pred, wo, bo, ids, frame_lens, label_lens
        )
        return jnp.sum(_loss_from_planes(lpb, lpe, frame_lens, label_lens))

    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(enc, pred, wo, bo)
    assert np.isfinite(float(val))
    for g in grads:
        g = np.asarray(g, np.float32)
        assert np.isfinite(g).all()
        assert np.abs(g).max() > 0  # gradient reaches every operand


def test_overfit_curve_pruned_tracks_dense():
    """Learning-curve comparison (the pruned objective must optimize like
    the dense one): overfit the same tiny batch with both losses; both
    curves collapse and the pruned final loss lands near the dense one."""
    import optax

    from speech_recognition_tpu.train import TrainState, make_train_step

    B, T, J, U1, V, S = 4, 10, 8, 5, 32, 2
    enc, pred, wo, bo, ids, frame_lens, label_lens = _case(42, B, T, J, U1, V)

    def fit(use_pruned):
        def loss_fn(params):
            if use_pruned:
                lpb, lpe = pruned_log_planes(
                    0, S, params["enc"], params["pred"], params["wo"],
                    params["bo"], ids, frame_lens, label_lens,
                )
            else:
                lpb, lpe = joint_log_planes(
                    0, params["enc"], params["pred"], params["wo"], params["bo"], ids
                )
            per = transducer_loss(lpb, lpe, frame_lens, label_lens)
            return jnp.mean(per / jnp.maximum(label_lens, 1))

        params = {"enc": enc, "pred": pred, "wo": wo, "bo": bo}
        tx = optax.adam(5e-2)
        opt = tx.init(params)
        curve = []
        step = jax.jit(jax.value_and_grad(loss_fn))
        for _ in range(60):
            val, g = step(params)
            updates, opt = tx.update(g, opt)
            params = optax.apply_updates(params, updates)
            curve.append(float(val))
        return curve

    dense_curve, pruned_curve = fit(False), fit(True)
    assert pruned_curve[-1] < 0.25 * pruned_curve[0], "pruned curve must collapse"
    assert dense_curve[-1] < 0.25 * dense_curve[0]
    # same optimum neighborhood: the band contains the learned alignment
    assert abs(pruned_curve[-1] - dense_curve[-1]) < 0.15 * (dense_curve[0] + 1e-6)


# --------------------------------------------------------- model integration


def _mini_model(**over):
    from speech_recognition_tpu.models import Transducer

    kw = dict(
        vocab_size=23, encoder_dim=16, num_encoder_layers=2,
        num_attention_heads=2, conv_kernel_size=5, ffn_expansion=2,
        subsample_channels=(4, 4), pred_dim=8, num_pred_layers=1,
        joint_dim=12, dropout=0.0, blank_index=0, pad_index=0,
    )
    kw.update(over)
    return Transducer(**kw)


def _model_batch():
    audio = jax.random.uniform(jax.random.PRNGKey(0), (2, 50, 20, 3), minval=0.1)
    audio = audio.at[1, 37:].set(0.0)
    tokens = jnp.array([[1, 5, 9, 12, 2, 0], [1, 7, 2, 0, 0, 0]], jnp.int32)
    return audio, tokens[:, :-1], tokens[:, 1:]


def test_model_pruned_loss_trains_and_bounds_dense():
    import optax

    from speech_recognition_tpu.train import TrainState, make_train_step

    audio, dec_in, y_true = _model_batch()
    dense = _mini_model()
    variables = dense.init({"params": jax.random.PRNGKey(1)}, (audio, dec_in))
    out = dense.apply(variables, (audio, dec_in))
    loss_d = float(dense.get_loss_fn()(y_true, out))
    pruned = _mini_model(pruned_range=2)
    loss_p = float(pruned.get_loss_fn()(y_true, out))
    assert np.isfinite(loss_p) and loss_p >= loss_d - 1e-5
    # wide band == dense exactly
    full = _mini_model(pruned_range=dec_in.shape[1])
    np.testing.assert_allclose(
        float(full.get_loss_fn()(y_true, out)), loss_d, rtol=1e-5
    )
    # a full train step optimizes the pruned objective
    state = TrainState.create(dict(variables), optax.adam(1e-3))
    step = make_train_step(pruned, pruned.get_loss_fn(), pruned.get_metrics())
    l0 = None
    for i in range(5):
        state, metrics = step(state, (audio, dec_in), y_true, jax.random.PRNGKey(i))
        l0 = l0 if l0 is not None else float(metrics["loss"])
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["loss"]) < l0, "pruned loss must decrease under adam"


def test_model_pruned_excludes_infeasible_rows():
    """A row whose labels outnumber what the band can carry is pruned to
    the floor and must be EXCLUDED from the batch mean, not poison it."""
    model = _mini_model(pruned_range=2)
    audio = jax.random.uniform(jax.random.PRNGKey(2), (2, 50, 20, 3), minval=0.1)
    # row 1: only ~2 encoder frames of real audio but 4 labels -> with
    # s_range=2 the band over so few frames cannot reach u=4
    audio = audio.at[1, 9:].set(0.0)
    tokens = jnp.array([[1, 5, 9, 12, 2, 0], [1, 7, 8, 9, 10, 2]], jnp.int32)
    dec_in, y_true = tokens[:, :-1], tokens[:, 1:]
    variables = model.init({"params": jax.random.PRNGKey(3)}, (audio, dec_in))
    out = model.apply(variables, (audio, dec_in))
    loss = float(model.get_loss_fn()(y_true, out))
    assert np.isfinite(loss) and loss < 1e6

    # config registry carries the knob
    from speech_recognition_tpu.configs.model_config import TransducerConfig

    cfg = TransducerConfig(
        vocab_size=23, encoder_dim=16, num_encoder_layers=2,
        num_attention_heads=2, conv_kernel_size=5, ffn_expansion=2,
        subsample_channels=[4, 4], pred_dim=8, num_pred_layers=1,
        joint_dim=12, dropout=0.0, blank_index=0, pad_index=0,
        pruned_range=4,
    )
    assert cfg.create_model().pruned_range == 4
