"""Custom-VJP teacher-forced LAS decoder scan (attention + stacked LSTM).

The decoder loop (models/las.py AttendAndSpeller.step_hidden scanned over
token positions, mirroring reference las.py:361-379) is the train step's
largest remaining block after the encoder custom VJP.  XLA's autodiff of the
scan accumulates EVERY weight gradient (cell kernels, recurrent kernels,
query projection, projected keys, attention values) with matmuls inside each
sequential backward step.  This implementation's backward scan computes only
the per-step data grads (gate math + the dh chain + attention softmax VJP)
and emits ONLY the per-cell pre-activation grads ``dz``; every weight
gradient is then ONE post-scan einsum over the saved trajectories:

    dK_i  = sum_t x_in_i^T dz_i          dR_i = sum_t h_rec_i^T dz_i
    dqw   = sum_t h_start^T dq           dpk  = sum_t dscores_t (x) q_t
    dvalue= sum_t probs_t (x) dctx_t

Residuals are minimal: the forward scan emits per step only the threaded
state ``h_start``/``c_in0`` and each cell's pre-activation ``z`` and
candidate cell state ``c_p``.  Everything else the backward needs — the
query/score/prob/context trajectories, each cell's input ``x_in`` and
recurrent-entry ``h_rec`` — is recomputed OUTSIDE the sequential loops as
large batched einsums / elementwise passes, so the scans carry fewer
per-step device-memory streams.

Semantics are IDENTICAL to the scan in models/las.py (same state threading
through the cell stack — reference las.py:285-288 — same pad gating, same
constant dropout masks); equivalence of outputs and all gradients against
XLA autodiff is tested in tests/models/test_las.py.
"""

import os

import jax
import jax.numpy as jnp


def _unroll() -> int:
    """Scan unroll for the decoder forward/backward (several small dependent
    matmuls per body); ``SRT_DEC_UNROLL`` overrides the default of 1."""
    return int(os.environ.get("SRT_DEC_UNROLL", 1))


def _lstm_gates(z):
    zi, zf, zc, zo = jnp.split(z, 4, axis=-1)
    return jax.nn.sigmoid(zi), jax.nn.sigmoid(zf), jnp.tanh(zc), jax.nn.sigmoid(zo)


@jax.custom_vjp
def decoder_scan_lstm(
    emb,  # [N, B, He] embedded tokens after embedding dropout
    token_mask,  # [N, B, 1] float pad gate
    pk,  # [B, S, H] projected keys
    value,  # [B, S, Dv] attention values (listener output)
    attn_bias,  # [B, S] additive mask (0 valid / -1e9 pad)
    qw,  # [H, H] query projection
    qb,  # [H]
    kernels,  # tuple of [in_i, 4H]
    rkernels,  # tuple of [H, 4H]
    biases,  # tuple of [4H]
    cell_masks,  # tuple of [B, in_i] dropout masks (ones when disabled)
    out_mask,  # [B, H] output dropout mask (ones when disabled)
    h0,  # [B, H] initial threaded state
    c0,  # [B, H]
):
    (h_last, c_last), (hidden, *_rest) = _decoder_fwd_core(
        emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels, biases,
        cell_masks, out_mask, h0, c0,
    )
    return hidden, h_last, c_last


def _decoder_fwd_core(
    emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels, biases,
    cell_masks, out_mask, h0, c0,
):
    n_cells = len(kernels)

    def body(carry, inp):
        h, c = carry
        emb_t, m = inp
        h_start = h
        c_in0 = c
        q = h @ qw + qb
        scores = jnp.einsum("bh,bsh->bs", q, pk) + attn_bias
        probs = jax.nn.softmax(scores, axis=-1)
        ctx = jnp.einsum("bs,bsd->bd", probs, value)
        x = jnp.concatenate([emb_t, ctx], axis=-1)

        zs, c_ps = [], []
        for i in range(n_cells):
            x_in = x * cell_masks[i]
            z = x_in @ kernels[i] + biases[i] + h @ rkernels[i]
            gi, gf, gg, go = _lstm_gates(z)
            c_p = gf * c + gi * gg
            h_p = go * jnp.tanh(c_p)
            zs.append(z)
            c_ps.append(c_p)
            h = m * h_p + (1.0 - m) * h
            c = m * c_p + (1.0 - m) * c
            x = h_p * m
        hidden = x * out_mask
        saved = (hidden, h_start, c_in0, tuple(zs), tuple(c_ps))
        return (h, c), saved

    return jax.lax.scan(body, (h0, c0), (emb, token_mask), unroll=_unroll())


def _decoder_fwd(
    emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels, biases,
    cell_masks, out_mask, h0, c0,
):
    (h_last, c_last), saved = _decoder_fwd_core(
        emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels, biases,
        cell_masks, out_mask, h0, c0,
    )
    hidden, h_start, c_in0, zs, c_ps = saved
    residuals = (
        emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels,
        cell_masks, out_mask, h_start, c_in0, zs, c_ps,
    )
    return (hidden, h_last, c_last), residuals


def _decoder_bwd(residuals, cotangents):
    (
        emb, token_mask, pk, value, attn_bias, qw, qb, kernels, rkernels,
        cell_masks, out_mask, h_start, c_in0, zs, c_ps,
    ) = residuals
    dhidden, dh_last, dc_last = cotangents
    n_cells = len(kernels)
    He = emb.shape[-1]
    qw_T = qw.T
    k_T = tuple(k.T for k in kernels)
    r_T = tuple(r.T for r in rkernels)

    # ---- recompute the attention trajectory outside the scans: one batched
    # einsum each instead of a per-step stream through both loops
    q = h_start @ qw + qb  # true q: feeds dpk directly, not just the softmax
    scores = jnp.einsum("nbh,bsh->nbs", q, pk) + attn_bias[None]
    probs = jax.nn.softmax(scores, axis=-1)

    def body(carry, inp):
        dh, dc = carry
        dhidden_t, m, probs_t, cin0_t, z_t, cp_t = inp

        # reconstruct each cell's entering c from the single saved stream
        cins = [cin0_t]
        for i in range(1, n_cells):
            cins.append(m * cp_t[i - 1] + (1.0 - m) * cins[i - 1])

        dzs = [None] * n_cells
        # x emitted by the LAST cell feeds the output (after out_mask)
        dxout = dhidden_t * out_mask
        dh_cur, dc_cur = dh, dc
        for i in range(n_cells - 1, -1, -1):
            gi, gf, gg, go = _lstm_gates(z_t[i])
            tanh_cp = jnp.tanh(cp_t[i])
            dh_p = m * dh_cur + m * dxout
            dh_prev = (1.0 - m) * dh_cur
            dc_p = m * dc_cur
            dc_prev = (1.0 - m) * dc_cur
            do = dh_p * tanh_cp
            dc_p = dc_p + dh_p * go * (1.0 - tanh_cp * tanh_cp)
            df = dc_p * cins[i]
            dc_prev = dc_prev + dc_p * gf
            di = dc_p * gg
            dg = dc_p * gi
            dz = jnp.concatenate(
                [di * gi * (1.0 - gi), df * gf * (1.0 - gf), dg * (1.0 - gg * gg), do * go * (1.0 - go)],
                axis=-1,
            )
            dzs[i] = dz
            dh_prev = dh_prev + dz @ r_T[i]
            if i > 0:
                # cell i-1's gated h/c are this cell's state AND recurrent h;
                # its emitted x (h'_{i-1} * m) is this cell's input
                dh_cur = dh_prev
                dc_cur = dc_prev
                dxout = (dz @ k_T[i]) * cell_masks[i]
            else:
                dx0 = (dz @ k_T[0]) * cell_masks[0]
                dctx_t = dx0[:, He:]
                # attention backward (softmax VJP) — only the dh chain is
                # computed here; dpk/dvalue/dqw come from post-scan einsums
                dprobs = jnp.einsum("bd,bsd->bs", dctx_t, value)
                dscores_t = probs_t * (dprobs - jnp.sum(probs_t * dprobs, axis=-1, keepdims=True))
                dq_t = jnp.einsum("bs,bsh->bh", dscores_t, pk)
                dh_prev = dh_prev + dq_t @ qw_T
                carry_out = (dh_prev, dc_prev)
        return carry_out, tuple(dzs)

    (dh0, dc0), dzs = jax.lax.scan(
        body,
        (dh_last, dc_last),
        (dhidden, token_mask, probs, c_in0, zs, c_ps),
        reverse=True,
        unroll=_unroll(),
    )

    # ------------------------------------------------ hoisted trajectories
    # (recomputed from the minimal residual streams; elementwise or einsum)
    dz0 = dzs[0]
    dx0 = (dz0 @ k_T[0]) * cell_masks[0][None]
    demb = dx0[..., :He]
    dctx = dx0[..., He:]
    dprobs = jnp.einsum("nbd,bsd->nbs", dctx, value)
    dscores = probs * (dprobs - jnp.sum(probs * dprobs, axis=-1, keepdims=True))
    dq = jnp.einsum("nbs,bsh->nbh", dscores, pk)
    return _decoder_bwd_tail(
        emb, token_mask, pk, value, qw, kernels, cell_masks, out_mask,
        h_start, zs, c_ps, q, probs, dzs, demb, dctx, dscores, dq, dh0, dc0,
    )


def _decoder_bwd_tail(
    emb, token_mask, pk, value, qw, kernels, cell_masks, out_mask,
    h_start, zs, c_ps, q, probs, dzs, demb, dctx, dscores, dq, dh0, dc0,
):
    """Post-scan weight-gradient einsums: every dW is one large batched
    contraction over the per-step streams (never inside the sequential
    loop)."""
    n_cells = len(kernels)
    He = emb.shape[-1]
    dz0 = dzs[0]
    ctx = jnp.einsum("nbs,bsd->nbd", probs, value)

    # ------------------------------------------------ hoisted weight grads
    cm0 = cell_masks[0]
    dk0 = jnp.concatenate(
        [
            jnp.einsum("nbx,nbz->xz", emb * cm0[None, :, :He], dz0),
            jnp.einsum("nbd,nbz->dz", ctx * cm0[None, :, He:], dz0),
        ],
        axis=0,
    )
    dkernels = [dk0]
    drkernels = [jnp.einsum("nbh,nbz->hz", h_start, dz0)]
    h_rec = h_start
    for i in range(1, n_cells):
        zo_prev = zs[i - 1][..., 3 * (zs[i - 1].shape[-1] // 4):]
        h_p_prev = jax.nn.sigmoid(zo_prev) * jnp.tanh(c_ps[i - 1])
        x_i = h_p_prev * token_mask
        h_rec = token_mask * h_p_prev + (1.0 - token_mask) * h_rec
        dkernels.append(jnp.einsum("nbh,nbz->hz", x_i * cell_masks[i][None], dzs[i]))
        drkernels.append(jnp.einsum("nbh,nbz->hz", h_rec, dzs[i]))
    dbiases = tuple(jnp.sum(dzs[i], axis=(0, 1)) for i in range(n_cells))
    dqw = jnp.einsum("nbh,nbq->hq", h_start, dq)
    dqb = jnp.sum(dq, axis=(0, 1))
    dpk = jnp.einsum("nbs,nbh->bsh", dscores, q)
    dvalue = jnp.einsum("nbs,nbd->bsd", probs, dctx)
    dattn_bias = jnp.sum(dscores, axis=0)
    dcell_masks = tuple(jnp.zeros_like(cm) for cm in cell_masks)
    dout_mask = jnp.zeros_like(out_mask)
    dtoken_mask = jnp.zeros_like(token_mask)

    return (
        demb, dtoken_mask, dpk, dvalue, dattn_bias, dqw, dqb,
        tuple(dkernels), tuple(drkernels), dbiases, dcell_masks, dout_mask, dh0, dc0,
    )


decoder_scan_lstm.defvjp(_decoder_fwd, _decoder_bwd)
