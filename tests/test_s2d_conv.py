"""Phase-split (time-s2d) conv fast path: equivalence to the direct conv."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from speech_recognition_tpu.ops.s2d_conv import (
    Conv2DValid,
    time_s2d_valid_conv2d,
    valid_conv2d,
)


@pytest.mark.parametrize(
    "T,F,C,O,kt,kf,sf",
    [
        (64, 20, 1, 8, 11, 5, 2),   # DS2-like conv0
        (64, 20, 8, 8, 7, 5, 1),    # DS2-like conv1/2 (freq stride 1)
        (33, 10, 2, 4, 3, 3, 2),    # odd T, LAS-like 3x3
        (32, 10, 2, 4, 4, 3, 2),    # even kernel taps
        (35, 10, 2, 4, 6, 3, 1),    # odd T + even taps
    ],
)
def test_phase_split_matches_direct(T, F, C, O, kt, kf, sf):
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(2, T, F, C), jnp.float32)
    w = jnp.asarray(rng.randn(kt, kf, C, O) * 0.2, jnp.float32)
    ref = valid_conv2d(x, w, (2, sf))
    got = time_s2d_valid_conv2d(x, w, (2, sf))
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-5)

    # gradients through the rearrangement
    loss = lambda f: lambda x, w: jnp.sum(f(x, w, (2, sf)) ** 2)
    gx_r, gw_r = jax.grad(loss(valid_conv2d), argnums=(0, 1))(x, w)
    gx_g, gw_g = jax.grad(loss(time_s2d_valid_conv2d), argnums=(0, 1))(x, w)
    np.testing.assert_allclose(np.asarray(gx_g), np.asarray(gx_r), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gw_g), np.asarray(gw_r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "T,F,C,O,kt,kf",
    [
        (64, 40, 1, 8, 11, 11),   # DS2-like conv0 (stride 2,2 both split)
        (33, 21, 2, 4, 9, 8),     # odd T, odd F
        (32, 22, 2, 4, 10, 8),    # even taps both axes
    ],
)
def test_phase_split_both_axes(T, F, C, O, kt, kf):
    from speech_recognition_tpu.ops.s2d_conv import time_s2d_valid_conv2d as s2d

    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(2, T, F, C), jnp.float32)
    w = jnp.asarray(rng.randn(kt, kf, C, O) * 0.2, jnp.float32)
    ref = valid_conv2d(x, w, (2, 2))
    got = s2d(x, w, (2, 2), split_freq=True)
    assert got.shape == ref.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
    loss_ref = lambda x, w: jnp.sum(valid_conv2d(x, w, (2, 2)) ** 2)
    loss_got = lambda x, w: jnp.sum(s2d(x, w, (2, 2), split_freq=True) ** 2)
    gx_r, gw_r = jax.grad(loss_ref, argnums=(0, 1))(x, w)
    gx_g, gw_g = jax.grad(loss_got, argnums=(0, 1))(x, w)
    np.testing.assert_allclose(np.asarray(gx_g), np.asarray(gx_r), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(gw_g), np.asarray(gw_r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "T,F,C,O,kt,kf,st,sf",
    [
        (33, 11, 3, 8, 3, 3, 2, 2),   # LAS conv1-like (odd T/F)
        (32, 12, 8, 8, 3, 3, 2, 2),   # even T/F
        (33, 11, 4, 8, 4, 5, 2, 2),   # even time taps, odd freq taps
        (33, 11, 4, 8, 3, 3, 2, 1),   # freq stride 1
        (33, 11, 4, 8, 3, 3, 1, 2),   # time stride 1
        (35, 13, 2, 4, 5, 2, 2, 2),   # wider taps / even freq taps
    ],
)
def test_pdx_grads_match_autodiff(T, F, C, O, kt, kf, st, sf):
    """valid_conv2d_pdx: same forward, and dx/dW equal to autodiff of the
    plain conv (the dx path is the phase-decomposed correlation)."""
    from speech_recognition_tpu.ops.s2d_conv import valid_conv2d_pdx

    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(2, T, F, C), jnp.float32)
    w = jnp.asarray(rng.randn(kt, kf, C, O) * 0.2, jnp.float32)
    ref = valid_conv2d(x, w, (st, sf))
    got = valid_conv2d_pdx(x, w, (st, sf))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6, atol=1e-6)

    co = jnp.asarray(rng.randn(*ref.shape), jnp.float32)
    loss_ref = lambda x, w: jnp.sum(valid_conv2d(x, w, (st, sf)) * co)
    loss_got = lambda x, w: jnp.sum(valid_conv2d_pdx(x, w, (st, sf)) * co)
    gx_r, gw_r = jax.grad(loss_ref, argnums=(0, 1))(x, w)
    gx_g, gw_g = jax.grad(loss_got, argnums=(0, 1))(x, w)
    np.testing.assert_allclose(np.asarray(gx_g), np.asarray(gx_r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gw_g), np.asarray(gw_r), rtol=1e-5, atol=1e-5)


def test_conv2dvalid_module_dispatch(monkeypatch):
    """Module path parity: forced s2d == disabled s2d, same param pytree as
    nn.Conv (names/shapes), on any backend."""
    nn = pytest.importorskip("flax.linen")

    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(2, 30, 12, 3), jnp.float32)
    mod = Conv2DValid(8, kernel_size=(5, 3), strides=(2, 2))
    variables = mod.init(jax.random.PRNGKey(0), x)
    ref_mod = nn.Conv(8, kernel_size=(5, 3), strides=(2, 2), padding="VALID")
    ref_vars = ref_mod.init(jax.random.PRNGKey(0), x)
    assert jax.tree_util.tree_structure(variables) == jax.tree_util.tree_structure(ref_vars)
    for a, b in zip(jax.tree_util.tree_leaves(variables), jax.tree_util.tree_leaves(ref_vars)):
        assert a.shape == b.shape

    monkeypatch.setenv("SRT_S2D_CONV", "0")
    y_plain = mod.apply(variables, x)
    y_nnconv = ref_mod.apply(variables, x)
    np.testing.assert_allclose(np.asarray(y_plain), np.asarray(y_nnconv), rtol=1e-6, atol=1e-6)
    monkeypatch.setenv("SRT_S2D_CONV", "force")
    y_s2d = mod.apply(variables, x)
    np.testing.assert_allclose(np.asarray(y_s2d), np.asarray(y_plain), rtol=1e-5, atol=1e-5)
