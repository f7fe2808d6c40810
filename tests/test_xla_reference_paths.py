"""The plain JAX paths of the LAS, CTC, Conformer and transducer hot spots
against independent references: float64 NumPy, optax, or plain autodiff.

These are the computations the model families run on every backend: the
vocab projection + masked CE, the decoder scan's custom VJP, CTC from the
encoder's hidden states, greedy and beam decoding, the in-loop top-k with
its log-sum-exp, Conformer attention with hash dropout, and the dense and
banded transducer joint planes.  Shapes include the shipped vocabularies
(V=8000 and V=16000).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from speech_recognition_tpu.measure import ctc_loss, sparse_categorical_crossentropy
from speech_recognition_tpu.models import LAS
from speech_recognition_tpu.ops import decoder as D
from speech_recognition_tpu.ops.dropout import hash_dropout, hash_uniform
from speech_recognition_tpu.ops.transducer import joint_log_planes
from speech_recognition_tpu.ops.transducer_pruned import band_offsets, banded_joint_planes
from speech_recognition_tpu.search import LASSearcher, topk_inloop


def _f64(x):
    return np.asarray(x, np.float64)


def _log_softmax(z):
    z = z - z.max(-1, keepdims=True)
    return z - np.log(np.exp(z).sum(-1, keepdims=True))


# ---------------------------------------------------------- CE from hidden
@pytest.mark.parametrize("N,B,H,V", [(3, 4, 16, 256), (5, 2, 32, 1000), (2, 3, 8, 8000), (4, 2, 16, 16000)])
def test_ce_from_hidden_matches_float64_reference(N, B, H, V):
    rng = np.random.RandomState(N * 7 + V)
    hid = rng.randn(N, B, H).astype(np.float32)
    W = (rng.randn(H, V) * 0.3).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    y = rng.randint(1, V, (N, B)).astype(np.int32)
    y[-1, 0] = 0  # padding positions carry no loss

    def loss(hid, W, b):
        return sparse_categorical_crossentropy(y, hid @ W + b, 0)

    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(hid, W, b)

    logits = _f64(hid) @ _f64(W) + _f64(b)
    lsm = _log_softmax(logits)
    mask = (y != 0).astype(np.float64)
    nll = -np.take_along_axis(lsm, y[..., None], -1)[..., 0]
    ref = (nll * mask).sum() / mask.sum()
    dlogits = (np.exp(lsm) - np.eye(V)[y]) * (mask / mask.sum())[..., None]
    ref_grads = (dlogits @ _f64(W).T, np.einsum("nbh,nbv->hv", _f64(hid), dlogits), dlogits.sum((0, 1)))

    np.testing.assert_allclose(float(val), ref, rtol=1e-5)
    for g, r in zip(grads, ref_grads):
        np.testing.assert_allclose(np.asarray(g), r, rtol=2e-4, atol=1e-6 * max(np.abs(r).max(), 1.0))


# ------------------------------------------------------ decoder scan VJP
def _decoder_args(seed, N, B, S, H, Dv, cells, dropout):
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=0.3: jnp.asarray(rng.randn(*s).astype(np.float32) * scale)
    lens = rng.randint(S // 2, S + 1, B)
    attn_bias = jnp.asarray(np.where(np.arange(S)[None] < lens[:, None], 0.0, -1e9).astype(np.float32))
    tok_mask = np.ones((N, B, 1), np.float32)
    tok_mask[-2:, 0] = 0.0  # trailing pad tokens on one row
    keep = lambda *s: jnp.asarray((rng.rand(*s) > dropout).astype(np.float32) / (1.0 - dropout))
    in_dims = [H + Dv] + [H] * (cells - 1)
    return (
        f(N, B, H), jnp.asarray(tok_mask), f(B, S, H), f(B, S, Dv), attn_bias, f(H, H), f(H, scale=0.1),
        tuple(f(d, 4 * H) for d in in_dims), tuple(f(H, 4 * H) for _ in range(cells)),
        tuple(f(4 * H, scale=0.1) for _ in range(cells)), tuple(keep(B, d) for d in in_dims), keep(B, H),
        f(B, H), f(B, H),
    )


@pytest.mark.parametrize(
    "seed,N,B,S,H,Dv,cells,dropout",
    [(0, 4, 2, 6, 8, 12, 1, 0.0), (1, 6, 3, 10, 16, 16, 2, 0.2), (2, 5, 2, 7, 8, 8, 3, 0.1)],
)
def test_decoder_scan_vjp_matches_autodiff(seed, N, B, S, H, Dv, cells, dropout):
    args = _decoder_args(seed, N, B, S, H, Dv, cells, dropout)
    rng = np.random.RandomState(seed + 1)
    w_hid, w_h, w_c = (jnp.asarray(rng.randn(*s).astype(np.float32)) for s in ((N, B, H), (B, H), (B, H)))

    def scalar(fn):
        def f(*a):
            hidden, h, c = fn(*a)
            return jnp.sum(hidden * w_hid) + jnp.sum(h * w_h) + jnp.sum(c * w_c)

        return f

    def plain(*a):
        (h, c), saved = D._decoder_fwd_core(*a)
        return saved[0], h, c

    diff = (0, 2, 3, 4, 5, 6, 7, 8, 9, 12, 13)  # every float operand but the masks
    with jax.default_matmul_precision("highest"):
        v_c, g_c = jax.value_and_grad(scalar(D.decoder_scan_lstm), argnums=diff)(*args)
        v_p, g_p = jax.value_and_grad(scalar(plain), argnums=diff)(*args)
    np.testing.assert_allclose(float(v_c), float(v_p), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g_c), jax.tree_util.tree_leaves(g_p)):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-4, atol=1e-5 * max(np.abs(b).max(), 1.0))


# ------------------------------------------------------ CTC from hidden
@pytest.mark.parametrize("B,T,H,V,N,blank", [(2, 12, 8, 32, 4, 0), (3, 20, 16, 256, 6, 255), (2, 16, 8, 8000, 5, 0)])
def test_ctc_from_hidden_matches_optax(B, T, H, V, N, blank):
    rng = np.random.RandomState(V + T)
    hid = rng.randn(B, T, H).astype(np.float32)
    W = (rng.randn(H, V) * 0.5).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32)
    pad = 0
    labels = rng.randint(1, V - 1, (B, N)).astype(np.int32)
    labels[labels == blank] = 1
    labels[0, N - 2:] = pad  # a shorter label row

    def ours(hid, W, b):
        return ctc_loss(labels, hid @ W + b, blank, pad)

    def reference(hid, W, b):
        per_seq = optax.ctc_loss(
            hid @ W + b, jnp.zeros((B, T)), labels, (labels == pad).astype(jnp.float32), blank_id=blank
        )
        lens = jnp.sum(labels != pad, axis=1).astype(jnp.float32)
        return jnp.mean(per_seq / lens)

    v_o, g_o = jax.value_and_grad(ours, argnums=(0, 1, 2))(hid, W, b)
    v_r, g_r = jax.value_and_grad(reference, argnums=(0, 1, 2))(hid, W, b)
    np.testing.assert_allclose(float(v_o), float(v_r), rtol=1e-4)
    for a, r in zip(g_o, g_r):
        r = np.asarray(r)
        np.testing.assert_allclose(np.asarray(a), r, rtol=1e-3, atol=1e-5 * max(np.abs(r).max(), 1.0))


# ----------------------------------------------------------- LAS decoding
def _las(rnn_type, vocab, seed, eos_bias=0.0):
    model = LAS(rnn_type, vocab, 16, 16, 1, 1, 0.0, 1.0)
    key = jax.random.PRNGKey(seed)
    audio = jax.random.uniform(key, (3, 12, 10, 3), maxval=4.0)
    variables = model.init({"params": key}, (audio, jnp.zeros((3, 4), jnp.int32)))
    if eos_bias:
        ff = variables["params"]["attend_and_speller"]["feedforward"]
        ff["bias"] = ff["bias"].at[3].add(eos_bias)
    return model, variables, audio


def _np_greedy(model, variables, audio, L, bos, eos, pad):
    """Host loop over the model's decode step: argmax in float64 NumPy."""
    enc, mask, *states = model.apply(variables, audio, method=LAS.encode)
    keys = model.apply(variables, enc, method=LAS.project_keys)
    step = jax.jit(lambda tok, st: model.apply(variables, enc, keys, tok, mask, st, method=LAS.decode_step))
    B = audio.shape[0]
    tokens = np.full((B, L), pad, np.int64)
    tokens[:, 0] = bos
    ended = np.zeros(B, bool)
    logp = np.zeros(B)
    lens = np.full(B, L)
    states = tuple(states)
    for t in range(1, L):
        logits, states = step(jnp.asarray(tokens[:, t - 1], jnp.int32), states)
        lsm = _log_softmax(_f64(logits))
        new = lsm.argmax(-1)
        logp = np.where(ended, logp, logp + lsm.max(-1))
        new = np.where(ended, pad, new)
        lens = np.where((new == eos) & ~ended, t + 1, lens)
        ended |= new == eos
        tokens[:, t] = new
        if ended.all():
            break
    return tokens, np.exp(logp) ** (-1.0 / lens)


@pytest.mark.parametrize("rnn_type,vocab,L,eos_bias", [("lstm", 40, 7, 0.0), ("gru", 30, 6, 0.0), ("lstm", 50, 9, 3.0)])
def test_greedy_decode_matches_numpy_step_loop(rnn_type, vocab, L, eos_bias):
    model, variables, audio = _las(rnn_type, vocab, seed=L, eos_bias=eos_bias)
    searcher = LASSearcher(model, variables, L, bos_id=2, eos_id=3, pad_id=0)
    tokens, ppl = searcher.greedy_search(audio)
    ref_tokens, ref_ppl = _np_greedy(model, variables, audio, L, 2, 3, 0)
    np.testing.assert_array_equal(np.asarray(tokens), ref_tokens)
    np.testing.assert_allclose(np.asarray(ppl), ref_ppl, rtol=1e-4)


def _np_beam(model, variables, audio, K, L, bos, eos, pad, alpha=1.0, beta=32):
    """Reference beam search (reference search.py:120-209) in NumPy over the
    model's tiled decode step: tokens and scores follow the selected beam
    ancestry, decoder states stay with their slot."""
    B = audio.shape[0]
    enc, mask, *states = model.apply(variables, audio, method=LAS.encode)
    keys = model.apply(variables, enc, method=LAS.project_keys)
    step = jax.jit(lambda e, k, m, tok, st: model.apply(variables, e, k, tok, m, st, method=LAS.decode_step))
    logits0, states0 = step(enc, keys, mask, jnp.full((B,), bos, jnp.int32), tuple(states))
    lsm0 = _log_softmax(_f64(logits0))
    first = np.argsort(-lsm0, axis=-1, kind="stable")[:, :K]
    tokens = np.full((B, K, L), pad, np.int64)
    tokens[:, :, 0] = bos
    tokens[:, :, 1] = first
    logp = np.take_along_axis(lsm0, first, -1)
    tile = lambda x: jnp.repeat(x, K, axis=0)
    enc_t, keys_t, mask_t = tile(enc), tile(keys), tile(mask)
    states = tuple(tile(s) for s in states0)

    def seq_len(tokens, cur):
        is_eos = tokens == eos
        return np.where(is_eos.any(-1), is_eos.argmax(-1) + 1, cur)

    for t in range(2, L):
        if (tokens == eos).any(-1).all():
            break
        logits, states = step(enc_t, keys_t, mask_t, jnp.asarray(tokens[:, :, t - 1].reshape(-1), jnp.int32), states)
        lsm = _log_softmax(_f64(logits)).reshape(B, K, -1)
        cand_tok = np.argsort(-lsm, axis=-1, kind="stable")[..., :K]
        step_lp = np.take_along_axis(lsm, cand_tok, -1)
        ended = (tokens == eos).any(-1)
        step_lp = np.where(ended[..., None], 0.0, step_lp)
        cand_logp = logp[..., None] + step_lp
        cand_len = np.broadcast_to(seq_len(tokens, t + 1)[..., None], (B, K, K))
        scores = (cand_logp * ((1.0 + cand_len) / (1.0 + beta)) ** alpha).reshape(B, K * K)
        top = np.argsort(-scores, axis=-1, kind="stable")[:, :K]
        beam, tok = top // K, top % K
        rows = np.arange(B)[:, None]
        new_tok = np.where(ended[rows, beam], pad, cand_tok[rows, beam, tok])
        tokens = tokens[rows, beam]
        tokens[:, :, t] = new_tok
        logp = cand_logp[rows, beam, tok]
    lens = seq_len(tokens, L)
    tokens = np.where(np.arange(L)[None, None] < lens[..., None], tokens, pad)
    return tokens, np.exp(logp) ** (-1.0 / lens)


@pytest.mark.parametrize("rnn_type,vocab,K,L,eos_bias", [("lstm", 40, 2, 7, 0.0), ("gru", 30, 4, 6, 0.0), ("lstm", 50, 3, 8, 2.5)])
def test_beam_search_matches_numpy_oracle(monkeypatch, rnn_type, vocab, K, L, eos_bias):
    model, variables, audio = _las(rnn_type, vocab, seed=K + L, eos_bias=eos_bias)
    monkeypatch.setenv("SRT_BEAM_UNTILED", "1")
    searcher = LASSearcher(model, variables, L, bos_id=2, eos_id=3, pad_id=0)
    tokens, ppl = searcher.beam_search(audio, K)
    ref_tokens, ref_ppl = _np_beam(model, variables, audio, K, L, 2, 3, 0)
    np.testing.assert_array_equal(np.asarray(tokens), ref_tokens)
    np.testing.assert_allclose(np.asarray(ppl), ref_ppl, rtol=1e-4)


# --------------------------------------------------- beam top-k and lse
@pytest.mark.parametrize(
    "rows,V,k,dtype", [(4, 256, 4, "float32"), (3, 1000, 8, "float32"), (2, 16000, 8, "float32"), (6, 512, 8, "bfloat16")]
)
def test_topk_and_lse_match_numpy_argsort(rows, V, k, dtype):
    rng = np.random.RandomState(V + k)
    x = rng.randn(rows, V).astype(np.float32)
    if dtype == "bfloat16":
        x = np.round(x * 4) / 4  # many exact ties after the cast
    xj = jnp.asarray(x, dtype)
    vals, idx = topk_inloop(xj, k)
    lse = jax.nn.logsumexp(xj.astype(jnp.float32), axis=-1)
    xr = _f64(xj.astype(jnp.float32))
    ref_idx = np.argsort(-xr, axis=-1, kind="stable")[:, :k]  # ties: lower index first
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    np.testing.assert_array_equal(_f64(vals.astype(jnp.float32)), np.take_along_axis(xr, ref_idx, -1))
    m = xr.max(-1)
    np.testing.assert_allclose(np.asarray(lse), m + np.log(np.exp(xr - m[:, None]).sum(-1)), rtol=1e-6)


# ------------------------------------------ Conformer attention + dropout
def _attention(q, k, v, mask, seed, p):
    d = q.shape[-1]
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, k) / jnp.sqrt(jnp.float32(d))
    scores = jnp.where(mask[:, None, None, :], scores, -1e9)
    probs = jax.nn.softmax(scores, axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", hash_dropout(probs, seed, p), v)


@pytest.mark.parametrize("B,T,H,d,p", [(2, 8, 2, 4, 0.1), (1, 16, 4, 8, 0.3), (2, 12, 2, 16, 0.1)])
def test_conformer_attention_with_regenerated_hash_dropout_mask(B, T, H, d, p):
    rng = np.random.RandomState(T * d)
    q, k, v = (rng.randn(B, T, H, d).astype(np.float32) for _ in range(3))
    mask = np.arange(T)[None] < np.array([T, T - 3][:B])[:, None]
    seed = 1234 + T
    out = _attention(q, k, v, mask, seed, p)

    # float64 reference with the mask regenerated from the seed
    scores = np.einsum("bqhd,bkhd->bhqk", _f64(q), _f64(k)) / np.sqrt(d)
    scores = np.where(mask[:, None, None, :], scores, -1e9)
    probs = np.exp(_log_softmax(scores))
    keep = np.asarray(hash_uniform(seed, probs.shape)) >= p
    ref = np.einsum("bhqk,bkhd->bqhd", np.where(keep, probs / (1 - p), 0.0), _f64(v))
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-5)
    assert 0.0 < 1.0 - keep.mean() < 2 * p + 0.1

    # the backward regenerates the same mask: autodiff with it as a constant
    w = rng.randn(B, T, H, d).astype(np.float32)

    def with_constant_mask(q, k, v):
        scores = jnp.einsum("bqhd,bkhd->bhqk", q, k) / jnp.sqrt(jnp.float32(d))
        probs = jax.nn.softmax(jnp.where(mask[:, None, None, :], scores, -1e9), axis=-1)
        return jnp.sum(jnp.einsum("bhqk,bkhd->bqhd", jnp.where(keep, probs / (1 - p), 0.0), v) * w)

    g = jax.grad(lambda q, k, v: jnp.sum(_attention(q, k, v, mask, seed, p) * w), argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(with_constant_mask, argnums=(0, 1, 2))(q, k, v)
    for a, r in zip(g, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(r), rtol=1e-4, atol=1e-5)


# ------------------------------------------ dense and banded joint planes
def _joint_case(seed, B, T, J, U1, V):
    rng = np.random.RandomState(seed)
    enc = rng.randn(B, T, J).astype(np.float32) * 0.4
    pred = rng.randn(B, U1, J).astype(np.float32) * 0.4
    wo = rng.randn(J, V).astype(np.float32) * 0.3
    bo = rng.randn(V).astype(np.float32) * 0.1
    ids = rng.randint(1, V, (B, U1 - 1)).astype(np.int32)
    frame_lens = rng.randint(max(T // 2, 1), T + 1, (B,)).astype(np.int32)
    label_lens = rng.randint(1, U1, (B,)).astype(np.int32)
    return enc, pred, wo, bo, ids, frame_lens, label_lens


def _np_joint(blank, enc, pred, wo, bo, ids, cb, ce):
    """Dense float64 joint: planes lp_blank [B,T,U1], lp_emit [B,T,U1-1]
    and the gradients of sum(lp_blank*cb) + sum(lp_emit*ce)."""
    enc, pred, wo, bo = map(_f64, (enc, pred, wo, bo))
    B, T, _ = enc.shape
    U1, V = pred.shape[1], wo.shape[1]
    h = np.tanh(enc[:, :, None] + pred[:, None])  # [B,T,U1,J]
    lsm = _log_softmax(h @ wo + bo)
    lpb = lsm[..., blank]
    lpe = np.take_along_axis(lsm[:, :, :-1], ids[:, None, :, None], -1)[..., 0]
    sm = np.exp(lsm)
    dz = -(cb + np.pad(ce, ((0, 0), (0, 0), (0, 1))))[..., None] * sm
    dz[..., blank] += cb
    onehot = np.zeros((B, 1, U1, V))
    np.put_along_axis(onehot, np.pad(ids, ((0, 0), (0, 1)))[:, None, :, None], 1.0, -1)
    dz += np.pad(ce, ((0, 0), (0, 0), (0, 1)))[..., None] * onehot
    da = (dz @ wo.T) * (1 - h**2)
    grads = (da.sum(2), da.sum(1), np.einsum("btuj,btuv->jv", h, dz), dz.sum((0, 1, 2)))
    return lpb, lpe, grads


def _check_grads(got, ref, tol):
    for name, a, r in zip(("enc", "pred", "wo", "bo"), got, ref):
        np.testing.assert_allclose(np.asarray(a), r, rtol=tol, atol=tol * max(np.abs(r).max(), 1e-3), err_msg=name)


@pytest.mark.parametrize(
    "seed,B,T,J,U1,V,blank",
    [(0, 2, 4, 16, 3, 256, 0), (1, 3, 6, 8, 5, 128, 0), (2, 2, 3, 16, 100, 256, 0), (5, 2, 5, 16, 3, 256, 77)],
)
def test_dense_joint_planes_match_numpy_joint(seed, B, T, J, U1, V, blank):
    enc, pred, wo, bo, ids, *_ = _joint_case(seed, B, T, J, U1, V)
    rng = np.random.RandomState(seed + 9)
    cb, ce = rng.randn(B, T, U1), rng.randn(B, T, U1 - 1)

    def scalar(enc, pred, wo, bo):
        lpb, lpe = joint_log_planes(blank, enc, pred, wo, bo, jnp.asarray(ids))
        return jnp.sum(lpb * cb) + jnp.sum(lpe * ce)

    lpb, lpe = joint_log_planes(blank, enc, pred, wo, bo, jnp.asarray(ids))
    grads = jax.grad(scalar, argnums=(0, 1, 2, 3))(enc, pred, wo, bo)
    ref_b, ref_e, ref_g = _np_joint(blank, enc, pred, wo, bo, ids, cb, ce)
    np.testing.assert_allclose(np.asarray(lpb), ref_b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(lpe), ref_e, rtol=1e-5, atol=1e-5)
    _check_grads(grads, ref_g, 1e-4)


@pytest.mark.parametrize(
    "seed,B,T,J,U1,V,S,blank",
    [
        (0, 2, 5, 16, 6, 256, 2, 0),
        (1, 3, 16, 8, 5, 128, 3, 0),
        (4, 2, 6, 16, 6, 256, 4, 0),
        (5, 2, 5, 16, 8, 256, 8, 0),
        (2, 2, 3, 16, 100, 256, 8, 0),
        (3, 2, 4, 16, 6, 256, 12, 0),
        (6, 2, 4, 16, 40, 256, 24, 0),
        (7, 2, 4, 8, 4, 128, 2, 77),
    ],
)
def test_banded_joint_planes_match_numpy_joint(seed, B, T, J, U1, V, S, blank):
    enc, pred, wo, bo, ids, frame_lens, label_lens = _joint_case(seed, B, T, J, U1, V)
    p = np.asarray(band_offsets(jnp.asarray(frame_lens), jnp.asarray(label_lens), T, S))
    u = p[:, :, None] + np.arange(S)[None, None]
    # only in-range band slots are contractual (band_to_dense drops the rest)
    valid_b, valid_e = u <= U1 - 1, u <= U1 - 2
    rng = np.random.RandomState(seed + 9)
    cb_band = rng.randn(B, T, S) * valid_b
    ce_band = rng.randn(B, T, S) * valid_e

    def scalar(enc, pred, wo, bo):
        lpb, lpe = banded_joint_planes(blank, S, enc, pred, wo, bo, jnp.asarray(ids), jnp.asarray(p))
        return jnp.sum(lpb * cb_band) + jnp.sum(lpe * ce_band)

    lpb, lpe = banded_joint_planes(blank, S, enc, pred, wo, bo, jnp.asarray(ids), jnp.asarray(p))
    grads = jax.grad(scalar, argnums=(0, 1, 2, 3))(enc, pred, wo, bo)

    # scatter the band coefficients onto the dense lattice for the reference
    cb, ce = np.zeros((B, T, U1)), np.zeros((B, T, U1 - 1))
    bi, ti, si = np.nonzero(valid_b)
    cb[bi, ti, u[bi, ti, si]] = cb_band[bi, ti, si]
    bi, ti, si = np.nonzero(valid_e)
    ce[bi, ti, u[bi, ti, si]] = ce_band[bi, ti, si]
    ref_b, ref_e, ref_g = _np_joint(blank, enc, pred, wo, bo, ids, cb, ce)
    uc = np.minimum(u, U1 - 1)
    np.testing.assert_allclose(
        np.where(valid_b, np.asarray(lpb), 0.0), np.where(valid_b, np.take_along_axis(ref_b, uc, -1), 0.0),
        rtol=1e-5, atol=1e-5,
    )
    ue = np.minimum(u, U1 - 2)
    np.testing.assert_allclose(
        np.where(valid_e, np.asarray(lpe), 0.0), np.where(valid_e, np.take_along_axis(ref_e, ue, -1), 0.0),
        rtol=1e-5, atol=1e-5,
    )
    _check_grads(grads, ref_g, 1e-4)
