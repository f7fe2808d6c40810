"""Counter-based hash dropout — the cheap path for dropout-heavy models.

Why: standard dropout (``nn.Dropout``) draws bits with threefry2x32, a
~dozen-round integer cipher per 64 output bits.  For a model like the
Conformer — 6 dropout sites per block x 16 blocks on up-to-[B, T, 4D]
tensors, ~1.6e9 draws per forward at bench shapes — the bit generation
plus the fusion breaks it forces are a large share of a train step.  The reference framework's equivalents are the
Keras Dropout layers (e.g. reference speech_recognition/models/las.py:66,
deepspeech2.py:158); dropout *semantics* here are identical — Bernoulli(1-p)
keep, survivors scaled by 1/(1-p) — only the bit source differs.

How: each element's keep decision is a pure function of
(seed, element coordinates) — a murmur3-fmix32-style avalanche over a
linear combination of the coordinate iotas.  Two consequences:

- cheap: ~10 plain int32 ops per element, all fusable into the
  surrounding elementwise chain — no separate RNG kernel, no [shape] mask
  tensor round-tripped through device memory;
- recomputable: the backward regenerates the mask from the scalar seed
  (``jax.custom_vjp`` below), so autodiff saves NO residual for dropout —
  zero activation memory, zero extra HBM traffic.

Statistical quality is what dropout needs (uniform marginals, no visible
lattice correlation after the avalanche), not cryptographic strength; the
keep threshold uses 24 uniform bits (exact at f32 resolution).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import nn

__all__ = ["hash_uniform", "hash_dropout", "FastDropout"]


def _c(v: int) -> jnp.ndarray:
    """int32 constant from an unsigned 32-bit literal (two's complement)."""
    return jnp.int32(v - (1 << 32) if v >= (1 << 31) else v)


# Large odd multipliers (golden-ratio / murmur / xxhash constants); one per
# coordinate axis, cycled for rank > 6.  All that matters is that they are
# odd (bijective mod 2^32) and differ per axis — the fmix avalanche does
# the mixing.
_COEF = (0xC2B2AE35, 0x27D4EB2F, 0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09)


def hash_uniform(seed, shape, salt: int = 0):
    """Uniform [0, 1) f32 tensor, a pure function of (seed, salt, coords).

    ``seed`` is a scalar int32 (traced ok).  The value at each position is
    layout-independent — slicing/resharding the output equals slicing the
    full tensor — which is what lets a backward pass regenerate a forward's
    mask by construction.
    """
    x = jnp.asarray(seed, jnp.int32) * _c(0x9E3779B1) + jnp.int32(salt) * _c(0x85EBCA6B)
    for axis, _ in enumerate(shape):
        x = x + jax.lax.broadcasted_iota(jnp.int32, shape, axis) * _c(_COEF[axis % len(_COEF)])
    # fmix32 finalizer.  Shifts are ARITHMETIC on int32, so every right
    # shift is &-masked back to the intended logical bits.
    x = x ^ ((x >> 16) & 0xFFFF)
    x = x * _c(0x85EBCA6B)
    x = x ^ ((x >> 13) & 0x7FFFF)
    x = x * _c(0xC2B2AE35)
    x = x ^ ((x >> 16) & 0xFFFF)
    return (x & 0x00FFFFFF).astype(jnp.float32) * (1.0 / (1 << 24))


@functools.lru_cache(maxsize=None)
def _dropout_fn(p: float):
    """custom_vjp dropout closed over a static rate: bwd recomputes the mask
    from the seed instead of saving it (no residual tensor)."""
    assert 0.0 < p < 1.0

    def _apply(x, seed):
        keep = hash_uniform(seed, x.shape) >= p
        scale = jnp.asarray(1.0 / (1.0 - p), x.dtype)
        return jnp.where(keep, x * scale, jnp.zeros((), x.dtype))

    @jax.custom_vjp
    def drop(x, seed):
        return _apply(x, seed)

    def fwd(x, seed):
        return _apply(x, seed), seed

    def bwd(seed, dout):
        return _apply(dout, seed), np.zeros((), jax.dtypes.float0)

    drop.defvjp(fwd, bwd)
    return drop


def hash_dropout(x, seed, rate: float):
    """dropout(x) with keep mask = hash_uniform(seed, x.shape) >= rate."""
    if rate <= 0.0:
        return x
    return _dropout_fn(float(rate))(x, jnp.asarray(seed, jnp.int32))


class FastDropout(nn.Module):
    """Drop-in for ``nn.Dropout(rate)(x, deterministic=...)``.

    Draws ONE scalar int32 seed from the module's ``dropout`` rng stream
    (one tiny threefry call) and expands it positionally with
    ``hash_uniform``.  No params, no variables — swapping with nn.Dropout
    never touches checkpoint structure.
    """

    rate: float

    @nn.compact
    def __call__(self, x, deterministic: bool = False):
        if self.rate == 0.0 or deterministic:
            return x
        seed = jax.random.randint(
            self.make_rng("dropout"), (), 0, np.iinfo(np.int32).max, dtype=jnp.int32
        )
        return hash_dropout(x, seed, float(self.rate))
