"""RNN-Transducer (RNN-T) lattice loss.

Beyond-parity addition (the reference — cosmoquester/speech-recognition —
ships LAS and DeepSpeech2 only): the transducer objective (Graves 2012,
"Sequence Transduction with Recurrent Neural Networks") for streaming ASR.

Design notes (why this shape, not a port of warp-transducer):

* The DP runs over per-node log-probs ``lp_blank [B, T, U+1]`` and
  ``lp_emit [B, T, U]`` — NOT the full ``[B, T, U+1, V]`` logits lattice.
  The caller gathers those two planes out of the joint's log-softmax (see
  ``models/transducer.py``); the loss itself never touches vocab space.
* The alpha recursion is a ``lax.scan`` over T rows.  Within a row the
  left-to-right dependency  ``r[u] = logaddexp(a[u], e[u-1] + r[u-1])``
  is a first-order linear recurrence in the (logaddexp, +) semiring, so it
  runs as a ``lax.associative_scan`` over U — O(log U) vector steps on the
  VPU instead of a U-long sequential inner loop.  Sequential depth is T,
  not T+U (the anti-diagonal wavefront formulation).
* ``jax.custom_vjp``: the backward runs the mirror-image beta scan and
  emits the analytic occupancy gradients
  ``d(-logZ)/d lp = -exp(alpha + lp + beta_next - logZ)`` — one reverse
  scan, no saved per-step residuals beyond alpha (f32 [B, T, U+1], ~8 MB at
  bench shapes).  Equivalence vs autodiff of the same forward is pinned in
  tests/test_transducer.py, values vs a brute-force path-enumeration
  oracle.
* Static shapes throughout: padded lattices + ``frame_lens``/``label_lens``
  masks, per the repo's static-shape discipline.  Out-of-range emit
  slots carry ``_NEG`` (finite -1e30, not -inf: -inf + -inf = -inf is fine
  but -inf - -inf = nan in the logaddexp grads).
"""

import functools

import jax
import jax.numpy as jnp

_NEG = -1e30


def _logaddexp(a, b):
    """True-max-centered logaddexp.  Centering at max(a, b) (NOT clamped to
    the _NEG floor) keeps one exp term exactly 1, so the log never sees 0
    even when floor terms stack below _NEG in the garbage region past
    frame_lens — a clamped center there produced -inf forwards whose
    0-cotangent backward still NaN'd (0 * inf).  Floors are finite by
    construction, so a == b == -inf can't happen."""
    mx = jnp.maximum(a, b)
    return mx + jnp.log(jnp.exp(a - mx) + jnp.exp(b - mx))


def _row_recurrence(above, emit_prev):
    """Solve r[u] = logaddexp(above[u], emit_prev[u] + r[u-1]) along axis -1.

    ``above``     [..., U1] — the blank-transition contribution into row t
    ``emit_prev`` [..., U1] — lp_emit[t, u-1] shifted so slot u holds the
                              edge INTO u (slot 0 = _NEG: no left edge)
    Associative composition of pairs (g, a) meaning r = logaddexp(a, g + r_prev):
      (g2, a2) after (g1, a1)  ->  (g1 + g2, logaddexp(a2, g2 + a1))
    """

    def combine(x, y):
        g1, a1 = x
        g2, a2 = y
        return g1 + g2, _logaddexp(a2, g2 + a1)

    _, r = jax.lax.associative_scan(combine, (emit_prev, above), axis=-1)
    return r


def _alpha_scan(lp_blank, lp_emit):
    """Forward lattice pass.  Returns alpha [B, T, U1]:
    alpha[t, u] = log P(first t frames consumed, first u labels emitted).
    """
    B, T, U1 = lp_blank.shape
    # row 0: only emit edges — log-space prefix products of lp_emit[0]
    row0 = jnp.concatenate(
        [jnp.zeros((B, 1), lp_blank.dtype), jnp.cumsum(lp_emit[:, 0, :], axis=-1)], axis=-1
    )
    # slot u holds the emit edge INTO u (from u-1); slot 0 has no left edge
    emit_in = jnp.pad(lp_emit, ((0, 0), (0, 0), (1, 0)), constant_values=_NEG)

    def body(prev_row, inp):
        blank_prev, emit_prev = inp  # lp_blank[t-1], emit edges of row t
        above = prev_row + blank_prev
        row = _row_recurrence(above, emit_prev)
        return row, row

    _, rows = jax.lax.scan(
        body,
        row0,
        (jnp.swapaxes(lp_blank, 0, 1)[:-1], jnp.swapaxes(emit_in, 0, 1)[1:]),
    )
    return jnp.concatenate([row0[:, None], jnp.swapaxes(rows, 0, 1)], axis=1)


def _beta_scan(lp_blank, lp_emit, frame_lens, label_lens):
    """Backward lattice pass.  beta[t, u] = log P(completing from node
    (t, u)) including the final blank at (T_b - 1, U_b).  Rows at or beyond
    frame_lens stay at the _NEG floor except the terminal seed."""
    B, T, U1 = lp_blank.shape
    u_idx = jnp.arange(U1)[None, :]
    # terminal: beta[T_b - 1, U_b] = lp_blank[T_b - 1, U_b]; seed the scan
    # with a one-hot "after the lattice" row and inject per-row validity
    terminal_row = jnp.where(u_idx == label_lens[:, None], 0.0, _NEG)
    emit_out = jnp.pad(lp_emit, ((0, 0), (0, 0), (0, 1)), constant_values=_NEG)

    t_idx = jnp.arange(T)
    is_last = t_idx[None, :] == (frame_lens[:, None] - 1)  # [B, T]
    in_range = t_idx[None, :] < frame_lens[:, None]

    def body(next_row, inp):
        blank_t, emit_t, last_t, valid_t = inp
        # from (t, u): blank -> (t+1, u) [or terminal], emit -> (t, u+1)
        down = jnp.where(last_t[:, None], terminal_row, next_row) + blank_t
        # right-to-left recurrence: beta[u] = logaddexp(down[u], emit[u] + beta[u+1])
        row = _row_recurrence(down[:, ::-1], emit_t[:, ::-1])[:, ::-1]
        row = jnp.where(valid_t[:, None], row, _NEG)
        return row, row

    _, rows = jax.lax.scan(
        body,
        jnp.full((B, U1), _NEG, lp_blank.dtype),
        (
            jnp.swapaxes(lp_blank, 0, 1),
            jnp.swapaxes(emit_out, 0, 1),
            is_last.T,
            in_range.T,
        ),
        reverse=True,
    )
    return jnp.swapaxes(rows, 0, 1)


def _mask_planes(lp_blank, lp_emit, frame_lens, label_lens):
    """Clamp out-of-range lattice slots to the _NEG floor so padded frames
    and labels contribute no probability mass."""
    B, T, U1 = lp_blank.shape
    t_ok = jnp.arange(T)[None, :, None] < frame_lens[:, None, None]
    u_blank_ok = jnp.arange(U1)[None, None, :] <= label_lens[:, None, None]
    u_emit_ok = jnp.arange(U1 - 1)[None, None, :] < label_lens[:, None, None]
    lp_blank = jnp.where(t_ok & u_blank_ok, lp_blank, _NEG)
    lp_emit = jnp.where(t_ok & u_emit_ok, lp_emit, _NEG)
    return lp_blank, lp_emit


def _loss_core(lp_blank, lp_emit, frame_lens, label_lens):
    lp_blank = lp_blank.astype(jnp.float32)
    lp_emit = lp_emit.astype(jnp.float32)
    lp_blank, lp_emit = _mask_planes(lp_blank, lp_emit, frame_lens, label_lens)
    alpha = _alpha_scan(lp_blank, lp_emit)
    B, T, U1 = lp_blank.shape
    b_idx = jnp.arange(B)
    last_t = frame_lens - 1
    logz = (
        alpha[b_idx, last_t, label_lens]
        + lp_blank[b_idx, last_t, label_lens]
    )
    return -logz, (alpha, lp_blank, lp_emit)


@functools.partial(jax.custom_vjp, nondiff_argnums=())
def transducer_loss(lp_blank, lp_emit, frame_lens, label_lens):
    """Per-utterance RNN-T negative log-likelihood.

    lp_blank   [B, T, U+1] f32: log P(blank | frame t, u labels emitted)
    lp_emit    [B, T, U]   f32: log P(label_{u+1} | frame t, u emitted)
    frame_lens [B] int32 valid frame counts (1 <= l <= T)
    label_lens [B] int32 valid label counts (0 <= l <= U)
    Returns [B] f32 losses ( -log P(labels | frames) ).
    """
    loss, _ = _loss_core(lp_blank, lp_emit, frame_lens, label_lens)
    return loss


def _transducer_fwd(lp_blank, lp_emit, frame_lens, label_lens):
    loss, (alpha, mb, me) = _loss_core(lp_blank, lp_emit, frame_lens, label_lens)
    # zero-size dtype tokens: residual leaves must be arrays, not dtypes
    dtypes = (jnp.zeros((0,), lp_blank.dtype), jnp.zeros((0,), lp_emit.dtype))
    return loss, (alpha, mb, me, frame_lens, label_lens, loss, dtypes)


def _transducer_bwd(res, g):
    alpha, lp_blank, lp_emit, frame_lens, label_lens, loss, dtypes = res
    B, T, U1 = lp_blank.shape
    beta = _beta_scan(lp_blank, lp_emit, frame_lens, label_lens)
    logz = -loss  # [B]

    # blank edge (t, u) -> (t+1, u); at t = T_b - 1, u = U_b it exits the
    # lattice (beta_next := 0 exactly there)
    beta_down = jnp.concatenate([beta[:, 1:], jnp.full((B, 1, U1), _NEG)], axis=1)
    t_idx = jnp.arange(T)[None, :, None]
    terminal = (t_idx == (frame_lens - 1)[:, None, None]) & (
        jnp.arange(U1)[None, None, :] == label_lens[:, None, None]
    )
    beta_down = jnp.where(terminal, 0.0, beta_down)
    occ_blank = jnp.exp(
        jnp.clip(alpha + lp_blank + beta_down - logz[:, None, None], _NEG, 0.0)
    )
    # emit edge (t, u) -> (t, u+1)
    occ_emit = jnp.exp(
        jnp.clip(alpha[:, :, :-1] + lp_emit + beta[:, :, 1:] - logz[:, None, None], _NEG, 0.0)
    )
    import numpy as np

    gb = (-occ_blank * g[:, None, None]).astype(dtypes[0].dtype)
    ge = (-occ_emit * g[:, None, None]).astype(dtypes[1].dtype)
    f0 = lambda a: np.zeros(a.shape, jax.dtypes.float0)
    return gb, ge, f0(frame_lens), f0(label_lens)


transducer_loss.defvjp(_transducer_fwd, _transducer_bwd)


# ---------------------------------------------------------------------------
# Fused streaming joint: additive joint -> tanh -> vocab -> log-softmax ->
# (blank, target) planes, computed one encoder frame at a time inside a scan
# so the [B, T, U+1, V] logits lattice never exists in HBM (at real shapes it
# would be tens of GB; the planes are [B, T, U+1] + [B, T, U] f32).  The
# custom VJP recomputes each frame's joint row in the backward (remat by
# construction — the only residuals are the op's own inputs) and accumulates
# the weight gradients in f32 scan carries.
# ---------------------------------------------------------------------------


def _joint_row(enc_t, pred_proj, wo, bo):
    """One encoder frame's joint activations: [B, U1, J] tanh row."""
    return jnp.tanh(enc_t[:, None, :] + pred_proj)


def _row_planes(h, wo, bo, ids, blank_index):
    """Row logits -> (lse, z_blank, z_emit) without keeping z around."""
    z = jax.lax.dot_general(
        h, wo, (((2,), (0,)), ((), ())), preferred_element_type=jnp.float32
    ) + bo.astype(jnp.float32)  # [B, U1, V]
    lse = jax.scipy.special.logsumexp(z, axis=-1)  # [B, U1]
    z_blank = z[:, :, blank_index]
    z_emit = jnp.take_along_axis(z[:, :-1, :], ids[:, :, None], axis=2)[:, :, 0]
    return lse, z_blank, z_emit


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def joint_log_planes(blank_index, enc_proj, pred_proj, wo, bo, ids):
    """Streamed joint-network log-prob planes.

    blank_index  static int
    enc_proj     [B, T, J]  encoder projection (W_e @ enc + b_e, pre-tanh)
    pred_proj    [B, U+1, J] prediction-net projection (pre-tanh)
    wo, bo       [J, V], [V] vocab projection of the joint
    ids          [B, U] int32 target labels (ids[:, u] = (u+1)-th label)
    Returns (lp_blank [B, T, U+1] f32, lp_emit [B, T, U] f32) where
    lp_*[b, t, u] = log softmax(joint(b, t, u))[blank / ids[b, u]].
    """
    lpb, lpe = _joint_planes_fwd_scan(blank_index, enc_proj, pred_proj, wo, bo, ids)
    return lpb, lpe


def _joint_planes_fwd_scan(blank_index, enc_proj, pred_proj, wo, bo, ids):
    def body(_, enc_t):
        h = _joint_row(enc_t, pred_proj, wo, bo)
        lse, z_blank, z_emit = _row_planes(h, wo, bo, ids, blank_index)
        return None, (z_blank - lse, z_emit - lse[:, :-1])

    _, (lpb, lpe) = jax.lax.scan(body, None, jnp.swapaxes(enc_proj, 0, 1))
    return jnp.swapaxes(lpb, 0, 1), jnp.swapaxes(lpe, 0, 1)


def _joint_planes_fwd(blank_index, enc_proj, pred_proj, wo, bo, ids):
    out = _joint_planes_fwd_scan(blank_index, enc_proj, pred_proj, wo, bo, ids)
    return out, (enc_proj, pred_proj, wo, bo, ids)


def _joint_planes_bwd(blank_index, res, cots):
    import numpy as np

    enc_proj, pred_proj, wo, bo, ids = res
    dlpb, dlpe = cots  # [B, T, U1], [B, T, U] f32
    B, T, J = enc_proj.shape
    U1 = pred_proj.shape[1]
    V = wo.shape[1]
    f32 = jnp.float32
    e_blank = (jnp.arange(V) == blank_index).astype(f32)  # [V]
    onehot_ids = (ids[:, :, None] == jnp.arange(V)[None, None, :]).astype(
        f32
    )  # [B, U, V] — matmul scatter (measure.py convention); per-step transient

    def body(carry, inp):
        dpred, dwo, dbo = carry
        enc_t, dlpb_t, dlpe_t = inp  # [B,J], [B,U1], [B,U]
        h = _joint_row(enc_t, pred_proj, wo, bo)  # [B, U1, J]
        z = jax.lax.dot_general(
            h, wo, (((2,), (0,)), ((), ())), preferred_element_type=f32
        ) + bo.astype(f32)
        p = jax.nn.softmax(z, axis=-1)  # [B, U1, V] f32
        total = dlpb_t + jnp.pad(dlpe_t, ((0, 0), (0, 1)))  # [B, U1]
        dz = -p * total[:, :, None]
        dz = dz + dlpb_t[:, :, None] * e_blank[None, None, :]
        dz = dz.at[:, :-1, :].add(dlpe_t[:, :, None] * onehot_ids)
        dh = jax.lax.dot_general(
            dz.astype(wo.dtype), wo, (((2,), (1,)), ((), ())),
            preferred_element_type=f32,
        )  # [B, U1, J]
        dpre = dh * (1.0 - jnp.square(h.astype(f32)))  # tanh'
        denc_t = jnp.sum(dpre, axis=1)  # [B, J]
        dpred = dpred + dpre
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
            jnp.swapaxes(dlpb, 0, 1),
            jnp.swapaxes(dlpe, 0, 1),
        ),
    )
    return (
        jnp.swapaxes(denc, 0, 1).astype(enc_proj.dtype),
        dpred.astype(pred_proj.dtype),
        dwo.astype(wo.dtype),
        dbo.astype(bo.dtype),
        np.zeros(ids.shape, jax.dtypes.float0),
    )


joint_log_planes.defvjp(_joint_planes_fwd, _joint_planes_bwd)


def joint_log_planes_dense(blank_index, enc_proj, pred_proj, wo, bo, ids):
    """Reference full-lattice implementation (tests only): materializes the
    [B, T, U1, V] logits.  Identical math to joint_log_planes."""
    h = jnp.tanh(enc_proj[:, :, None, :] + pred_proj[:, None, :, :])
    z = jnp.einsum("btuj,jv->btuv", h, wo, preferred_element_type=jnp.float32)
    z = z + bo.astype(jnp.float32)
    lsm = jax.nn.log_softmax(z, axis=-1)
    lp_blank = lsm[:, :, :, blank_index]
    lp_emit = jnp.take_along_axis(
        lsm[:, :, :-1, :], ids[:, None, :, None], axis=3
    )[:, :, :, 0]
    return lp_blank, lp_emit


def transducer_loss_oracle(lp_blank, lp_emit, frame_lens, label_lens):
    """Brute-force path enumeration (test oracle, tiny shapes only).

    Sums P over every monotonic lattice path from (0,0) to the terminal
    blank at (T_b - 1, U_b).  Exponential in T+U — use T, U <= ~6.
    """
    import itertools

    import numpy as np

    lp_blank = np.asarray(lp_blank, np.float64)
    lp_emit = np.asarray(lp_emit, np.float64)
    B = lp_blank.shape[0]
    out = np.zeros((B,), np.float64)
    for b in range(B):
        T, U = int(frame_lens[b]), int(label_lens[b])
        total = -np.inf
        # a path = interleaving of (T-1) blanks and U emits, + final blank
        for positions in itertools.combinations(range(T - 1 + U), U):
            t, u, lp = 0, 0, 0.0
            for step in range(T - 1 + U):
                if step in positions:
                    lp += lp_emit[b, t, u]
                    u += 1
                else:
                    lp += lp_blank[b, t, u]
                    t += 1
            lp += lp_blank[b, T - 1, U]
            total = np.logaddexp(total, lp)
        out[b] = -total
    return out
