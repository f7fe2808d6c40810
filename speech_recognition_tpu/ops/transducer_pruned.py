"""Pruned (banded) RNN-T joint planes — the structural fix for the dense
O(T'·U·V) joint lattice.

The dense transducer objective evaluates the joint network at EVERY lattice
node (t, u): at bench shapes (T'=256, U+1=64, V=16K) that is ~43 analytic
TFLOP/step and 86% of the 836 ms Transducer train step (PERF.md round-14
floor declaration).  But the probability mass of the lattice concentrates
in a narrow monotone band around the utterance's alignment path: pruned
RNN-T (k2's pruned transducer loss; Kuang et al., "Pruned RNN-T for fast,
memory-efficient ASR training", Interspeech 2022) restricts each encoder
frame t to a window of ``s_range`` consecutive label positions
[p_t, p_t + s_range) and evaluates the joint only there — an s_range/U1
FLOP cut (8x at bench shapes with s_range=8).

Design (static shapes, not a port of k2's CUDA two-pass scheme):

* The band ``p`` is STATIC-SHAPE data: one int per (b, t), computed from
  the length ratio (``band_offsets`` — the linear-alignment band).  k2
  derives its band from a first "trivial joint" pass; the linear band
  needs no extra pass, is exact at the tails (p_0 = 0, the terminal node
  is always in band), and keeps every shape static for XLA.  With
  frames >= labels (always true after 4x time subsampling at sane speech
  rates) the per-frame drift is <= 1 slot, far inside the band.
* The banded planes [B, T, S] are scattered into the dense [B, T, U+1]
  plane layout with a -1e30 floor (``band_to_dense`` — a differentiable
  gather whose transpose is the scatter) and fed to the UNCHANGED lattice
  DP ``ops/transducer.transducer_loss``: off-band nodes carry no
  probability, so the DP itself implements the pruned objective and all
  of its masking/NaN-safety discipline is reused as-is.  The DP cost is
  O(T·U) elementwise work — noise next to the joint.
* ``banded_joint_planes`` (this module) is the XLA scan implementation
  with a custom VJP that recomputes each frame's [B, S, V] logits in the
  backward (mirror of ops/transducer.joint_log_planes, which it falls
  back to the layout of).
* The pruned loss sums a SUBSET of the dense loss's paths, so it upper-
  bounds the dense NLL and equals it exactly when s_range >= U+1
  (pinned in tests/test_transducer_pruned.py, along with the brute-force
  path-enumeration oracle on the NEG-filled dense planes).

Reference objective: beyond-parity — cosmoquester/speech-recognition
ships no transducer at all; the dense lattice loss docstring
(ops/transducer.py) covers the parity story.
"""

import functools

import jax
import jax.numpy as jnp

from .transducer import _NEG


def band_offsets(frame_lens, label_lens, T: int, s_range: int):
    """Linear-alignment band start per (b, t): ``p [B, T] int32``.

    p[b, t] = round(t * (U_b + 1 - S) / (T_b - 1)) clipped to
    [0, max(U_b + 1 - S, 0)], held constant past the last valid frame.
    Properties (pinned in tests): monotone non-decreasing in t, p_0 = 0
    (the path start (0, 0) is in band), and p_{T_b-1} + S > U_b (the
    terminal blank node (T_b - 1, U_b) is in band).  Paths need at most
    ceil(top / (T_b - 1)) emits per frame to stay in band; with
    frames >= labels that is <= 1 << s_range - 1.
    """
    t = jnp.arange(T, dtype=jnp.float32)[None, :]
    tl = jnp.maximum(frame_lens[:, None] - 1, 1).astype(jnp.float32)
    tc = jnp.minimum(t, tl)
    top = jnp.maximum(label_lens[:, None] + 1 - s_range, 0).astype(jnp.float32)
    p = jnp.floor(tc * top / tl + 0.5).astype(jnp.int32)
    return jnp.clip(p, 0, top.astype(jnp.int32))


def band_to_dense(band, p, width: int, fill=_NEG):
    """Scatter banded values [B, T, S] into the dense plane layout
    [B, T, width]: dense[b, t, u] = band[b, t, u - p[b, t]] when the slot
    is in band, else ``fill``.

    Implemented as S unrolled compare-selects over the static band axis —
    pure VPU elementwise work that XLA fuses into one kernel.  The obvious
    ``take_along_axis`` gather formulation lowers to a per-lane dynamic
    gather that cost 41 ms/step at bench shapes (trace, PERF round-15) —
    ~40% of the entire banded joint pair — where the select chain is noise.
    Autodiff of the selects routes each dense cotangent back to its band
    slot (S masked reductions).  Falls back to the gather for very wide
    bands where an S-deep select chain would bloat the program."""
    B, T, S = band.shape
    idx = jnp.arange(width, dtype=jnp.int32)[None, None, :] - p[:, :, None]
    if S > 32:
        valid = (idx >= 0) & (idx < S)
        g = jnp.take_along_axis(band, jnp.clip(idx, 0, S - 1), axis=-1)
        return jnp.where(valid, g, jnp.asarray(fill, band.dtype))
    out = jnp.full((B, T, width), fill, band.dtype)
    for s in range(S):
        out = jnp.where(idx == s, band[:, :, s : s + 1], out)
    return out


def _band_gather(pred_proj, ids, p_t, S: int):
    """Per-frame band operands: (pred_band [B,S,J], ids_band [B,S], u_idx)."""
    U1 = pred_proj.shape[1]
    U = ids.shape[1]
    u_idx = p_t[:, None] + jnp.arange(S, dtype=jnp.int32)[None, :]  # [B, S]
    pred_band = jnp.take_along_axis(
        pred_proj, jnp.clip(u_idx, 0, U1 - 1)[:, :, None], axis=1
    )
    ids_band = jnp.take_along_axis(ids, jnp.clip(u_idx, 0, max(U - 1, 0)), axis=1)
    return pred_band, ids_band, u_idx


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def banded_joint_planes(blank_index, s_range, enc_proj, pred_proj, wo, bo, ids, p):
    """Banded joint-network log-prob planes (XLA scan path).

    blank_index, s_range   static ints
    enc_proj   [B, T, J]   encoder projection (pre-tanh)
    pred_proj  [B, U+1, J] prediction-net projection (pre-tanh)
    wo, bo     [J, V], [V] vocab projection of the joint
    ids        [B, U] int32 target labels
    p          [B, T] int32 band starts (band_offsets)
    Returns (lpb_band [B, T, S] f32, lpe_band [B, T, S] f32) where slot
    (b, t, s) holds the log-softmax blank / target log-prob of lattice
    node (t, p[b, t] + s).  Out-of-range slots (p + s > U) hold finite
    garbage — band_to_dense replaces them with the -1e30 floor and the
    lattice DP masks them, so they never carry probability or gradient.
    """
    out, _ = _banded_fwd(blank_index, s_range, enc_proj, pred_proj, wo, bo, ids, p)
    return out


def _banded_fwd_scan(blank_index, s_range, enc_proj, pred_proj, wo, bo, ids, p):
    f32 = jnp.float32

    def body(_, inp):
        enc_t, p_t = inp  # [B, J], [B]
        pred_band, ids_band, _ = _band_gather(pred_proj, ids, p_t, s_range)
        h = jnp.tanh(enc_t[:, None, :] + pred_band)  # [B, S, J]
        z = jax.lax.dot_general(
            h, wo, (((2,), (0,)), ((), ())), preferred_element_type=f32
        ) + bo.astype(f32)  # [B, S, V]
        lse = jax.scipy.special.logsumexp(z, axis=-1)  # [B, S]
        zb = z[:, :, blank_index]
        ze = jnp.take_along_axis(z, ids_band[:, :, None], axis=2)[:, :, 0]
        return None, (zb - lse, ze - lse)

    _, (lpb, lpe) = jax.lax.scan(
        body, None, (jnp.swapaxes(enc_proj, 0, 1), p.T)
    )
    return jnp.swapaxes(lpb, 0, 1), jnp.swapaxes(lpe, 0, 1)


def _banded_fwd(blank_index, s_range, enc_proj, pred_proj, wo, bo, ids, p):
    out = _banded_fwd_scan(blank_index, s_range, enc_proj, pred_proj, wo, bo, ids, p)
    return out, (enc_proj, pred_proj, wo, bo, ids, p)


def _banded_bwd(blank_index, s_range, res, cots):
    import numpy as np

    enc_proj, pred_proj, wo, bo, ids, p = res
    dlpb, dlpe = cots  # [B, T, S] f32
    B, T, J = enc_proj.shape
    U1 = pred_proj.shape[1]
    V = wo.shape[1]
    f32 = jnp.float32
    e_blank = (jnp.arange(V) == blank_index).astype(f32)  # [V]
    u_cols = jnp.arange(U1, dtype=jnp.int32)[None, None, :]  # [1, 1, U1]

    def body(carry, inp):
        dpred, dwo, dbo = carry
        enc_t, p_t, dlpb_t, dlpe_t = inp  # [B,J], [B], [B,S], [B,S]
        pred_band, ids_band, u_idx = _band_gather(pred_proj, ids, p_t, s_range)
        h = jnp.tanh(enc_t[:, None, :] + pred_band)  # [B, S, J]
        z = jax.lax.dot_general(
            h, wo, (((2,), (0,)), ((), ())), preferred_element_type=f32
        ) + bo.astype(f32)
        sm = jax.nn.softmax(z, axis=-1)  # [B, S, V] f32
        total = dlpb_t + dlpe_t  # [B, S]
        dz = -sm * total[:, :, None]
        dz = dz + dlpb_t[:, :, None] * e_blank[None, None, :]
        onehot_ids = (ids_band[:, :, None] == jnp.arange(V)[None, None, :]).astype(f32)
        dz = dz + dlpe_t[:, :, None] * onehot_ids
        dh = jax.lax.dot_general(
            dz.astype(wo.dtype), wo, (((2,), (1,)), ((), ())),
            preferred_element_type=f32,
        )  # [B, S, J]
        dpre = dh * (1.0 - jnp.square(h.astype(f32)))  # tanh'
        denc_t = jnp.sum(dpre, axis=1)  # [B, J]
        # scatter the band's pred gradients back to their label slots
        onehot_u = (u_idx[:, :, None] == u_cols).astype(f32)  # [B, S, U1]
        dpred = dpred + jax.lax.dot_general(
            onehot_u, dpre, (((1,), (1,)), ((0,), (0,)))
        )  # [B, U1, J]
        dwo = dwo + jax.lax.dot_general(
            h, dz.astype(h.dtype), (((0, 1), (0, 1)), ((), ())),
            preferred_element_type=f32,
        )  # [J, V]
        dbo = dbo + jnp.sum(dz, axis=(0, 1))
        return (dpred, dwo, dbo), denc_t

    carry0 = (
        jnp.zeros((B, U1, J), f32),
        jnp.zeros((J, V), f32),
        jnp.zeros((V,), f32),
    )
    (dpred, dwo, dbo), denc = jax.lax.scan(
        body,
        carry0,
        (
            jnp.swapaxes(enc_proj, 0, 1),
            p.T,
            jnp.swapaxes(dlpb, 0, 1),
            jnp.swapaxes(dlpe, 0, 1),
        ),
    )
    f0 = lambda a: np.zeros(a.shape, jax.dtypes.float0)
    return (
        jnp.swapaxes(denc, 0, 1).astype(enc_proj.dtype),
        dpred.astype(pred_proj.dtype),
        dwo.astype(wo.dtype),
        dbo.astype(bo.dtype),
        f0(ids),
        f0(p),
    )


banded_joint_planes.defvjp(_banded_fwd, _banded_bwd)


def pruned_log_planes(
    blank_index, s_range, enc_proj, pred_proj, wo, bo, ids, frame_lens, label_lens
):
    """Dense-layout (lp_blank [B,T,U+1], lp_emit [B,T,U]) planes of the
    PRUNED objective: the banded joint scan scattered onto the -1e30
    floor.  Drop-in for joint_log_planes ahead of transducer_loss."""
    U1 = pred_proj.shape[1]
    T = enc_proj.shape[1]
    p = jax.lax.stop_gradient(band_offsets(frame_lens, label_lens, T, s_range))
    lpb_band, lpe_band = banded_joint_planes(
        blank_index, s_range, enc_proj, pred_proj, wo, bo, ids, p
    )
    lpb = band_to_dense(lpb_band, p, U1)
    lpe = band_to_dense(lpe_band, p, U1 - 1)
    return lpb, lpe
