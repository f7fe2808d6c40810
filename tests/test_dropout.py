"""Counter-based hash dropout (ops/dropout.py).

Pins: uniform marginals, coordinate purity (layout/shape independence —
the property that lets the backward regenerate the forward's mask), exact
dropout semantics (zeros + 1/(1-p) scaling), custom-VJP == autodiff of the
same forward math, and module-level rng independence between sites.
"""

import jax
import jax.numpy as jnp
import numpy as np
from speech_recognition_tpu import nn
import pytest

from speech_recognition_tpu.ops.dropout import FastDropout, hash_dropout, hash_uniform


def test_hash_uniform_range_and_marginals():
    u = hash_uniform(jnp.int32(1234), (256, 512))
    u = np.asarray(u)
    assert u.min() >= 0.0 and u.max() < 1.0
    # 2^17 samples: mean se ~ 0.0008, be generous
    assert abs(u.mean() - 0.5) < 5e-3
    for p in (0.1, 0.25, 0.5):
        assert abs((u < p).mean() - p) < 5e-3


def test_hash_uniform_coordinate_purity():
    # the value at a coordinate depends only on (seed, salt, coords) — a
    # smaller tensor is literally the corner of a bigger one
    big = hash_uniform(jnp.int32(7), (64, 48, 8))
    small = hash_uniform(jnp.int32(7), (16, 8, 4))
    np.testing.assert_array_equal(np.asarray(big)[:16, :8, :4], np.asarray(small))


def test_hash_uniform_seed_and_salt_decorrelate():
    a = np.asarray(hash_uniform(jnp.int32(1), (128, 128)))
    b = np.asarray(hash_uniform(jnp.int32(2), (128, 128)))
    c = np.asarray(hash_uniform(jnp.int32(1), (128, 128), salt=1))
    assert abs(np.corrcoef(a.ravel(), b.ravel())[0, 1]) < 0.02
    assert abs(np.corrcoef(a.ravel(), c.ravel())[0, 1]) < 0.02
    # and adjacent rows/cols of one draw don't correlate either
    assert abs(np.corrcoef(a[:-1].ravel(), a[1:].ravel())[0, 1]) < 0.02
    assert abs(np.corrcoef(a[:, :-1].ravel(), a[:, 1:].ravel())[0, 1]) < 0.02


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hash_dropout_semantics(rate):
    x = jax.random.normal(jax.random.PRNGKey(0), (64, 96), jnp.float32)
    seed = jnp.int32(99)
    out = np.asarray(hash_dropout(x, seed, rate))
    keep = np.asarray(hash_uniform(seed, x.shape)) >= rate
    np.testing.assert_allclose(out, np.where(keep, np.asarray(x) / (1 - rate), 0.0), rtol=1e-6)
    assert abs(keep.mean() - (1 - rate)) < 0.02


def test_hash_dropout_rate_zero_is_identity():
    x = jnp.ones((4, 4))
    assert hash_dropout(x, jnp.int32(0), 0.0) is x


def test_hash_dropout_custom_vjp_matches_autodiff():
    # the custom bwd regenerates the mask; it must equal autodiff of the
    # same forward math (mask saved as a residual)
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 64), jnp.float32)
    seed = jnp.int32(5)
    rate = 0.3

    def plain(x):  # same math (multiply by the f32 reciprocal), no custom_vjp
        keep = hash_uniform(seed, x.shape) >= rate
        return jnp.where(keep, x * jnp.float32(1.0 / (1.0 - rate)), 0.0)

    ct = jax.random.normal(jax.random.PRNGKey(2), (32, 64), jnp.float32)
    g_custom = jax.vjp(lambda x: hash_dropout(x, seed, rate), x)[1](ct)[0]
    g_plain = jax.vjp(plain, x)[1](ct)[0]
    np.testing.assert_array_equal(np.asarray(g_custom), np.asarray(g_plain))


def test_hash_dropout_bf16_dtype_preserved():
    x = jnp.ones((8, 128), jnp.bfloat16)
    out = hash_dropout(x, jnp.int32(3), 0.1)
    assert out.dtype == jnp.bfloat16
    vals = {float(v) for v in np.unique(np.asarray(out, np.float32))}
    # survivors carry the bf16-rounded 1/0.9 scale, dropped are exact zeros
    assert vals <= {0.0, float(jnp.bfloat16(1 / 0.9))}


class _TwoSite(nn.Module):
    @nn.compact
    def __call__(self, x, deterministic=False):
        a = FastDropout(0.5)(x, deterministic=deterministic)
        b = FastDropout(0.5)(x, deterministic=deterministic)
        return a, b


def test_fast_dropout_module_sites_independent():
    x = jnp.ones((64, 64))
    a, b = _TwoSite().apply({}, x, rngs={"dropout": jax.random.PRNGKey(0)})
    ma, mb = np.asarray(a) != 0, np.asarray(b) != 0
    assert 0.4 < ma.mean() < 0.6 and 0.4 < mb.mean() < 0.6
    # distinct rng folds per site -> different masks
    assert (ma != mb).mean() > 0.3


def test_fast_dropout_deterministic_and_reproducible():
    x = jnp.ones((16, 16))
    det = _TwoSite().apply({}, x, rngs={"dropout": jax.random.PRNGKey(0)}, deterministic=True)
    np.testing.assert_array_equal(np.asarray(det[0]), np.asarray(x))
    r1 = _TwoSite().apply({}, x, rngs={"dropout": jax.random.PRNGKey(7)})
    r2 = _TwoSite().apply({}, x, rngs={"dropout": jax.random.PRNGKey(7)})
    np.testing.assert_array_equal(np.asarray(r1[0]), np.asarray(r2[0]))
