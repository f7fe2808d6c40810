"""Recurrent layers as lax.scan time-loops.

Replaces the reference's Keras RNN stack (reference: speech_recognition/
models/las.py:10-17, 62-126) with mask-aware scan recurrences:

- The input projection ``x @ W_in`` for the whole sequence is hoisted out of
  the scan as one large [B*T, D] x [D, G*H] matmul; the per-step body only
  computes the [B, H] x [H, G*H] recurrent
  matmul.
- Masked timesteps leave the carried state untouched and emit zeros, which
  yields exact pad-invariance (tests/models assert the reference's
  prefix-invariance property) and makes reversed scans start from the last
  valid frame automatically.
- Parameter layout matches Keras (kernel / recurrent_kernel / bias with
  i,f,c,o LSTM gate order, z,r,h GRU order with reset_after biases) so the
  reference's published TF checkpoints map 1:1 onto this pytree.
"""

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .. import nn

RNN_TYPES = ("rnn", "lstm", "gru")


def _gate_count(rnn_type: str) -> int:
    return {"rnn": 1, "lstm": 4, "gru": 3}[rnn_type]


def num_states(rnn_type: str) -> int:
    return 2 if rnn_type == "lstm" else 1


def _keras_lstm_bias(key, shape, dtype=jnp.float32):
    """Zeros with forget-gate bias 1 (Keras unit_forget_bias)."""
    units = shape[0] // 4
    return jnp.concatenate(
        [jnp.zeros(units, dtype), jnp.ones(units, dtype), jnp.zeros(2 * units, dtype)]
    )


class RNNParams(nn.Module):
    """Holds Keras-layout parameters for one recurrent direction/cell."""

    rnn_type: str
    units: int
    param_dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, in_dim: int):
        gates = _gate_count(self.rnn_type)
        kernel = self.param(
            "kernel", nn.initializers.glorot_uniform(), (in_dim, gates * self.units), self.param_dtype
        )
        recurrent_kernel = self.param(
            "recurrent_kernel",
            nn.initializers.orthogonal(),
            (self.units, gates * self.units),
            self.param_dtype,
        )
        if self.rnn_type == "gru":
            # reset_after GRU keeps separate input/recurrent biases
            bias = self.param("bias", nn.initializers.zeros, (2, gates * self.units), self.param_dtype)
        elif self.rnn_type == "lstm":
            bias = self.param("bias", _keras_lstm_bias, (gates * self.units,), self.param_dtype)
        else:
            bias = self.param("bias", nn.initializers.zeros, (gates * self.units,), self.param_dtype)
        return kernel, recurrent_kernel, bias


def init_state(rnn_type: str, batch: int, units: int, dtype) -> Tuple[jnp.ndarray, ...]:
    zeros = jnp.zeros((batch, units), dtype)
    return (zeros, zeros) if rnn_type == "lstm" else (zeros,)


def cell_step(
    rnn_type: str,
    x_proj_t: jnp.ndarray,
    state: Tuple[jnp.ndarray, ...],
    recurrent_kernel: jnp.ndarray,
    recurrent_bias: Optional[jnp.ndarray],
    units: int,
):
    """One recurrence step. ``x_proj_t`` is the precomputed input projection
    (already includes the input bias)."""
    if rnn_type == "lstm":
        h, c = state
        z = x_proj_t + h @ recurrent_kernel
        zi, zf, zc, zo = jnp.split(z, 4, axis=-1)
        i = jax.nn.sigmoid(zi)
        f = jax.nn.sigmoid(zf)
        c_new = f * c + i * jnp.tanh(zc)
        o = jax.nn.sigmoid(zo)
        h_new = o * jnp.tanh(c_new)
        return h_new, (h_new, c_new)
    if rnn_type == "gru":
        (h,) = state
        inner = h @ recurrent_kernel
        if recurrent_bias is not None:
            inner = inner + recurrent_bias
        xz, xr, xh = jnp.split(x_proj_t, 3, axis=-1)
        rz, rr, rh = jnp.split(inner, 3, axis=-1)
        z = jax.nn.sigmoid(xz + rz)
        r = jax.nn.sigmoid(xr + rr)
        hh = jnp.tanh(xh + r * rh)
        h_new = z * h + (1.0 - z) * hh
        return h_new, (h_new,)
    (h,) = state
    h_new = jnp.tanh(x_proj_t + h @ recurrent_kernel)
    return h_new, (h_new,)


# --------------------------------------------------------- custom LSTM VJP
# XLA's autodiff of the LSTM scan accumulates the recurrent-weight gradient
# with a [H,B]x[B,4H] matmul INSIDE every backward step — on the sequential
# critical path.  This custom VJP's backward scan computes only the gate
# grads and the dh chain (one matmul per step); dR is then ONE
# [H, T*B] x [T*B, 4H] matmul over the saved trajectories.  Forward math
# is identical to the body in RNN.__call__ (gates saved as residuals, same
# as XLA's own backward).
@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def _lstm_scan(x_proj_t, mask_f_t, recurrent_kernel, h0, c0, reverse: bool):
    (h_last, c_last), (out, *_rest) = _lstm_scan_fwd_core(
        x_proj_t, mask_f_t, recurrent_kernel, h0, c0, reverse
    )
    return out, h_last, c_last


def _lstm_scan_fwd_core(x_proj_t, mask_f_t, rk, h0, c0, reverse):
    H = h0.shape[-1]

    def body(state, inp):
        x_t, m_t = inp
        h, c = state
        z = x_t + h @ rk
        zi, zf, zc, zo = jnp.split(z, 4, axis=-1)
        i = jax.nn.sigmoid(zi)
        f = jax.nn.sigmoid(zf)
        g = jnp.tanh(zc)
        o = jax.nn.sigmoid(zo)
        c_p = f * c + i * g
        h_p = o * jnp.tanh(c_p)
        h_new = m_t * h_p + (1.0 - m_t) * h
        c_new = m_t * c_p + (1.0 - m_t) * c
        return (h_new, c_new), (h_p * m_t, i, f, g, o, c_p, h, c)

    return jax.lax.scan(body, (h0, c0), (x_proj_t, mask_f_t), reverse=reverse)


def _lstm_scan_fwd(x_proj_t, mask_f_t, recurrent_kernel, h0, c0, reverse):
    (h_last, c_last), (out, i, f, g, o, c_p, h_prev, c_prev) = _lstm_scan_fwd_core(
        x_proj_t, mask_f_t, recurrent_kernel, h0, c0, reverse
    )
    residuals = (mask_f_t, recurrent_kernel, i, f, g, o, c_p, h_prev, c_prev)
    return (out, h_last, c_last), residuals


def _lstm_scan_bwd(reverse, residuals, cotangents):
    mask_f_t, rk, i, f, g, o, c_p, h_prev, c_prev = residuals
    dout, dh_last, dc_last = cotangents
    rk_T = rk.T

    def body(carry, inp):
        dh, dc = carry
        dout_t, m, i_t, f_t, g_t, o_t, cp_t, hprev_t, cprev_t = inp
        tanh_cp = jnp.tanh(cp_t)
        dh_p = m * dout_t + m * dh
        dh_prev = (1.0 - m) * dh
        dc_p = m * dc
        dc_prev = (1.0 - m) * dc
        do = dh_p * tanh_cp
        dc_p = dc_p + dh_p * o_t * (1.0 - tanh_cp * tanh_cp)
        df = dc_p * cprev_t
        dc_prev = dc_prev + dc_p * f_t
        di = dc_p * g_t
        dg = dc_p * i_t
        dz = jnp.concatenate(
            [
                di * i_t * (1.0 - i_t),
                df * f_t * (1.0 - f_t),
                dg * (1.0 - g_t * g_t),
                do * o_t * (1.0 - o_t),
            ],
            axis=-1,
        )
        dh_prev = dh_prev + dz @ rk_T
        return (dh_prev, dc_prev), dz

    # walk time in the opposite order of the forward scan
    (dh0, dc0), dz = jax.lax.scan(
        body,
        (dh_last, dc_last),
        (dout, mask_f_t, i, f, g, o, c_p, h_prev, c_prev),
        reverse=not reverse,
    )
    dx = dz  # z = x + h @ R
    # the hoisted weight gradient: one big matmul over the trajectory
    drk = jnp.einsum("tbh,tbg->hg", h_prev, dz)
    dmask = jnp.zeros_like(mask_f_t)
    return dx, dmask, drk, dh0, dc0


_lstm_scan.defvjp(_lstm_scan_fwd, _lstm_scan_bwd)


# Same hoisted-dW trick for the (reset_after) GRU — DS2's recurrent stack
# ships as 7 BiGRU layers (resources/configs/deepspeech.yml).
@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def _gru_scan(x_proj_t, mask_f_t, recurrent_kernel, recurrent_bias, h0, reverse: bool):
    h_last, (out, *_rest) = _gru_scan_fwd_core(
        x_proj_t, mask_f_t, recurrent_kernel, recurrent_bias, h0, reverse
    )
    return out, h_last


def _gru_scan_fwd_core(x_proj_t, mask_f_t, rk, rb, h0, reverse):
    H = h0.shape[-1]

    def body(h, inp):
        x_t, m_t = inp
        inner = h @ rk + rb
        xz, xr, xh = jnp.split(x_t, 3, axis=-1)
        rz, rr, rh = jnp.split(inner, 3, axis=-1)
        z = jax.nn.sigmoid(xz + rz)
        r = jax.nn.sigmoid(xr + rr)
        hh = jnp.tanh(xh + r * rh)
        h_p = z * h + (1.0 - z) * hh
        h_new = m_t * h_p + (1.0 - m_t) * h
        return h_new, (h_p * m_t, z, r, hh, rh, h)

    return jax.lax.scan(body, h0, (x_proj_t, mask_f_t), reverse=reverse)


def _gru_scan_fwd(x_proj_t, mask_f_t, recurrent_kernel, recurrent_bias, h0, reverse):
    h_last, (out, z, r, hh, rh, h_prev) = _gru_scan_fwd_core(
        x_proj_t, mask_f_t, recurrent_kernel, recurrent_bias, h0, reverse
    )
    residuals = (mask_f_t, recurrent_kernel, z, r, hh, rh, h_prev)
    return (out, h_last), residuals


def _gru_scan_bwd(reverse, residuals, cotangents):
    mask_f_t, rk, z, r, hh, rh, h_prev = residuals
    dout, dh_last = cotangents
    rk_T = rk.T

    def body(dh, inp):
        dout_t, m, z_t, r_t, hh_t, rh_t, hprev_t = inp
        dh_p = m * dout_t + m * dh
        dh_prev = (1.0 - m) * dh
        # h' = z*h_prev + (1-z)*hh
        dz = dh_p * (hprev_t - hh_t)
        dh_prev = dh_prev + dh_p * z_t
        dhh = dh_p * (1.0 - z_t)
        # hh = tanh(xh + r*rh)
        da = dhh * (1.0 - hh_t * hh_t)
        dxh = da
        dr = da * rh_t
        d_rh = da * r_t
        # r = sigmoid(xr + rr), z = sigmoid(xz + rz)
        db = dr * r_t * (1.0 - r_t)
        dc = dz * z_t * (1.0 - z_t)
        d_inner = jnp.concatenate([dc, db, d_rh], axis=-1)
        dx = jnp.concatenate([dc, db, dxh], axis=-1)
        dh_prev = dh_prev + d_inner @ rk_T
        return dh_prev, (dx, d_inner)

    dh0, (dx, d_inner) = jax.lax.scan(
        body,
        dh_last,
        (dout, mask_f_t, z, r, hh, rh, h_prev),
        reverse=not reverse,
    )
    drk = jnp.einsum("tbh,tbg->hg", h_prev, d_inner)
    drb = jnp.sum(d_inner, axis=(0, 1))
    dmask = jnp.zeros_like(mask_f_t)
    return dx, dmask, drk, drb, dh0


_gru_scan.defvjp(_gru_scan_fwd, _gru_scan_bwd)


class RNN(nn.Module):
    """Unidirectional mask-aware recurrent layer.

    Call: (inputs [B,T,D], mask [B,T] bool, initial_state tuple or None)
    Returns: (outputs [B,T,H] — zeros at masked steps, final_state tuple).
    """

    rnn_type: str
    units: int
    dropout: float = 0.0
    recurrent_dropout: float = 0.0
    reverse: bool = False
    dtype: jnp.dtype = jnp.float32
    # rematerialize the scan body in the backward pass (trade FLOPs for the
    # per-step gate activation memory; lets bigger batches fit HBM)
    remat: bool = False
    # scan unroll factor; 0 = SRT_RNN_UNROLL (default 1): the body is a
    # single dependent matmul, so unrolling mostly inflates the schedule
    unroll: int = 0

    def _unroll(self) -> int:
        if self.unroll:
            return self.unroll
        import os

        return int(os.environ.get("SRT_RNN_UNROLL", 1))

    @nn.compact
    def __call__(self, inputs, mask, initial_state=None, training: bool = False):
        if self.rnn_type not in RNN_TYPES:
            raise ValueError(f"rnn_type: {self.rnn_type} is invalid!")
        B, T, D = inputs.shape
        kernel, recurrent_kernel, bias = RNNParams(self.rnn_type, self.units, name="cell")(D)
        kernel = kernel.astype(self.dtype)
        recurrent_kernel = recurrent_kernel.astype(self.dtype)
        bias = bias.astype(self.dtype)
        inputs = inputs.astype(self.dtype)

        if self.rnn_type == "gru":
            input_bias, recurrent_bias = bias[0], bias[1]
        else:
            input_bias, recurrent_bias = bias, None

        if training and self.dropout > 0.0:
            # Keras semantics: one dropout mask per sequence, shared across time
            keep = 1.0 - self.dropout
            drop_mask = jax.random.bernoulli(self.make_rng("dropout"), keep, (B, 1, D))
            inputs = inputs * drop_mask.astype(inputs.dtype) / keep
        rec_drop_mask = None
        if training and self.recurrent_dropout > 0.0:
            keep = 1.0 - self.recurrent_dropout
            rec_drop_mask = (
                jax.random.bernoulli(self.make_rng("dropout"), keep, (B, self.units)).astype(self.dtype)
                / keep
            )

        # hoisted input projection: one big matmul
        x_proj = inputs @ kernel + input_bias  # [B, T, G*H]

        if initial_state is None:
            state0 = init_state(self.rnn_type, B, self.units, self.dtype)
        else:
            state0 = tuple(s.astype(self.dtype) for s in initial_state)

        mask_t = jnp.swapaxes(mask, 0, 1)[..., None]  # [T, B, 1]
        x_proj_t = jnp.swapaxes(x_proj, 0, 1)  # [T, B, G*H]

        import os

        remat = self.remat or os.environ.get("SRT_RNN_REMAT", "0") == "1"
        custom_vjp_ok = (
            rec_drop_mask is None
            and not remat
            and os.environ.get("SRT_LSTM_CUSTOM_VJP", "1") == "1"
        )
        if self.rnn_type == "lstm" and custom_vjp_ok:
            # custom-VJP path: backward does one matmul per step instead of
            # two (weight-gradient accumulation hoisted out of the scan)
            out_t, h_last, c_last = _lstm_scan(
                x_proj_t,
                mask_t.astype(self.dtype),
                recurrent_kernel,
                state0[0],
                state0[1],
                self.reverse,
            )
            return jnp.swapaxes(out_t, 0, 1), (h_last, c_last)
        if self.rnn_type == "gru" and custom_vjp_ok:
            out_t, h_last = _gru_scan(
                x_proj_t,
                mask_t.astype(self.dtype),
                recurrent_kernel,
                recurrent_bias.astype(self.dtype),
                state0[0],
                self.reverse,
            )
            return jnp.swapaxes(out_t, 0, 1), (h_last,)

        def body(state, inp):
            x_t, m_t = inp
            h_state = state
            if rec_drop_mask is not None:
                h_state = (state[0] * rec_drop_mask,) + state[1:]
            h_new, new_state = cell_step(
                self.rnn_type, x_t, h_state, recurrent_kernel, recurrent_bias, self.units
            )
            m = m_t.astype(h_new.dtype)
            new_state = tuple(m * ns + (1.0 - m) * os for ns, os in zip(new_state, state))
            return new_state, h_new * m

        body_fn = jax.checkpoint(body) if remat else body
        final_state, outputs = jax.lax.scan(
            body_fn, state0, (x_proj_t, mask_t), reverse=self.reverse, unroll=self._unroll()
        )
        return jnp.swapaxes(outputs, 0, 1), final_state


class BiRNN(nn.Module):
    """Bidirectional wrapper (reference models/las.py:62-126).

    Returns [output [B,T,2H]] + list(forward states) + list(backward states).
    The backward direction is a reverse-order scan whose mask gating makes it
    start from each sequence's last valid frame.
    """

    rnn_type: str
    units: int
    dropout: float = 0.0
    recurrent_dropout: float = 0.0
    dtype: jnp.dtype = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(self, inputs, mask, initial_state=None, training: bool = False):
        n = num_states(self.rnn_type)
        if initial_state is None:
            fwd_init = bwd_init = None
        else:
            fwd_init = tuple(initial_state[:n])
            bwd_init = tuple(initial_state[n : 2 * n])
        fwd_out, fwd_state = RNN(
            self.rnn_type,
            self.units,
            self.dropout,
            self.recurrent_dropout,
            dtype=self.dtype,
            remat=self.remat,
            name="forward_rnn",
        )(inputs, mask, fwd_init, training)
        bwd_out, bwd_state = RNN(
            self.rnn_type,
            self.units,
            self.dropout,
            self.recurrent_dropout,
            reverse=True,
            dtype=self.dtype,
            remat=self.remat,
            name="backward_rnn",
        )(inputs, mask, bwd_init, training)
        output = jnp.concatenate([fwd_out, bwd_out], axis=-1)
        return [output] + list(fwd_state) + list(bwd_state)
