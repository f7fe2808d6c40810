"""Expert parallelism: a Switch/GShard-style routed FFN over an ``expert``
mesh axis.

The reference framework has no mixture-of-experts layer (it scales by data
parallelism only, reference speech_recognition/utils.py:130-156); this is a
beyond-parity scaling capability completing the parallelism axes (dp / tp /
pp / sp / ep).  The design is the standard static-shape MoE recipe (GShard,
arXiv:2006.16668; Switch Transformer, arXiv:2101.03961) expressed the
XLA-native way:

- routing, dispatch and combine are one-hot einsums (matmul work, static
  shapes — capacity ``C`` bounds the per-expert buffer so nothing is
  data-dependently shaped),
- expert weights live sharded over the ``expert`` mesh axis; tokens travel
  to their experts and back with ONE ``lax.all_to_all`` each way (rides
  ICI),
- the per-expert FFN is a batched einsum over the ``[E_local, tokens, D]``
  buffer — large, bf16-friendly matmuls.

Tokens routed beyond an expert's capacity are dropped (their combine
weight is zero) — standard Switch behaviour; callers keep them identity
via the residual connection.  ``moe_ffn`` is the dense single-device
reference implementation (every token through every expert, then masked):
``expert_parallel_moe`` must match it exactly when nothing drops, and must
match it per source shard when capacity binds — both pinned in
``tests/test_expert_parallel.py``.
"""

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def init_moe_params(
    key, n_experts: int, d_model: int, d_hidden: int, dtype=jnp.float32
) -> Dict[str, Any]:
    """Router + per-expert FFN parameters.

    Leaves carry a leading expert axis ``[E, ...]`` (except the router),
    ready to shard over the mesh's ``expert`` axis with ``P('expert', ...)``.
    """
    k_r, k_i, k_o = jax.random.split(key, 3)
    scale_in = 1.0 / np.sqrt(d_model)
    scale_out = 1.0 / np.sqrt(d_hidden)
    return {
        "router": (jax.random.normal(k_r, (d_model, n_experts)) * scale_in).astype(dtype),
        "w_in": (jax.random.normal(k_i, (n_experts, d_model, d_hidden)) * scale_in).astype(dtype),
        "b_in": jnp.zeros((n_experts, d_hidden), dtype),
        "w_out": (jax.random.normal(k_o, (n_experts, d_hidden, d_model)) * scale_out).astype(dtype),
        "b_out": jnp.zeros((n_experts, d_model), dtype),
    }


def _route(params, x, k: int, capacity: int, mask=None):
    """Top-k routing with per-expert capacity.

    Returns ``(dispatch [n, E, C], combine [n, E, C], aux_loss)`` for local
    tokens ``x [n, D]``.  Slot 0 assignments rank ahead of slot 1 (Switch
    convention: the primary expert fills first), ranks within a slot follow
    token order — deterministic, so the expert-parallel path reproduces the
    dense oracle bit-for-bit in expectation terms.

    ``mask [n]`` (optional): False tokens (padding) are never dispatched,
    consume no capacity, and are excluded from the aux statistics — so a
    padded batch routes its real tokens exactly like the unpadded one.
    """
    E = params["router"].shape[-1]
    logits = x.astype(jnp.float32) @ params["router"].astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)  # [n, E]
    gate_vals, idx = jax.lax.top_k(probs, k)  # [n, k]
    if k > 1:
        # renormalize the kept gates (GShard top-2 convention)
        gate_vals = gate_vals / jnp.sum(gate_vals, -1, keepdims=True)

    valid = None if mask is None else mask.reshape(-1).astype(jnp.int32)
    counts = jnp.zeros((E,), jnp.int32)
    dispatch = jnp.zeros((x.shape[0], E, capacity), x.dtype)
    combine = jnp.zeros((x.shape[0], E, capacity), jnp.float32)
    for slot in range(k):
        m = jax.nn.one_hot(idx[:, slot], E, dtype=jnp.int32)  # [n, E]
        if valid is not None:
            m = m * valid[:, None]
        pos = jnp.cumsum(m, axis=0) - 1 + counts[None, :]  # rank within expert
        counts = counts + jnp.sum(m, axis=0)
        pos_tok = jnp.sum(pos * m, axis=-1)  # [n] position at the chosen expert
        keep = (pos_tok < capacity) & (jnp.sum(m, -1) > 0)
        slot_hot = (
            m[:, :, None] * jax.nn.one_hot(pos_tok, capacity, dtype=jnp.int32)[:, None, :]
        )
        slot_hot = jnp.where(keep[:, None, None], slot_hot, 0)
        dispatch = dispatch + slot_hot.astype(x.dtype)
        combine = combine + gate_vals[:, slot, None, None] * slot_hot

    # Switch load-balancing aux: E * sum_e f_e * P_e over the local group
    # (f_e = fraction of tokens whose slot-0 choice is e, P_e = mean prob)
    top1 = jax.nn.one_hot(idx[:, 0], E, dtype=jnp.float32)
    if valid is None:
        f = jnp.mean(top1, axis=0)
        p = jnp.mean(probs, axis=0)
    else:
        denom = jnp.maximum(jnp.sum(valid).astype(jnp.float32), 1.0)
        f = jnp.sum(top1 * valid[:, None], axis=0) / denom
        p = jnp.sum(probs * valid[:, None], axis=0) / denom
    aux = E * jnp.sum(f * p)
    return dispatch, combine, aux


def _capacity(n_tokens: int, n_experts: int, k: int, capacity_factor: float) -> int:
    return max(1, int(np.ceil(n_tokens * k * capacity_factor / n_experts)))


def _expert_ffn(params_local, buf):
    """Per-expert FFN over dispatch buffers ``[E_local, T, D] -> [E_local, T, D]``."""
    h = jnp.einsum("etd,edh->eth", buf, params_local["w_in"].astype(buf.dtype))
    h = jax.nn.relu(h + params_local["b_in"][:, None, :].astype(buf.dtype))
    y = jnp.einsum("eth,ehd->etd", h, params_local["w_out"].astype(buf.dtype))
    return y + params_local["b_out"][:, None, :].astype(buf.dtype)


def moe_ffn(
    params,
    x,
    k: int = 1,
    capacity_factor: float = 1.25,
    capacity: Optional[int] = None,
    mask=None,
):
    """Dense single-device routed FFN (the oracle / 1-device path).

    ``x [..., D]`` -> ``(y [..., D], aux_loss)``.  Every token runs through
    its top-k experts, tokens past an expert's capacity are dropped (zero
    output — add the residual outside).  ``mask [...]`` (x's lead shape)
    marks padding tokens, which get zero output and consume no capacity.
    """
    lead = x.shape[:-1]
    xt = x.reshape(-1, x.shape[-1])
    E = params["router"].shape[-1]
    if capacity is None:
        capacity = _capacity(xt.shape[0], E, k, capacity_factor)
    dispatch, combine, aux = _route(params, xt, k, capacity, mask)
    buf = jnp.einsum("nd,nec->ecd", xt, dispatch)  # [E, C, D]
    y = _expert_ffn(params, buf)  # [E, C, D]
    out = jnp.einsum("ecd,nec->nd", y, combine.astype(y.dtype))
    return out.reshape(lead + (x.shape[-1],)), aux


def expert_parallel_moe(
    params,
    x,
    mesh: Mesh,
    expert_axis: str = "expert",
    data_axis: Optional[str] = None,
    k: int = 1,
    capacity_factor: float = 1.25,
    capacity: Optional[int] = None,
    mask=None,
):
    """Expert-parallel routed FFN over ``mesh``.

    Expert weights shard over ``expert_axis`` (expert ``g * E_local + j``
    lives on expert-group ``g`` — the natural leading-axis layout); token
    rows shard over ``(data_axis, expert_axis)`` jointly, exactly how the
    surrounding non-MoE layers see the batch on a dp x ep mesh.  Routing and
    capacity are per source shard (GShard "groups"): each shard ranks its
    own tokens, so ``capacity`` bounds every shard->expert buffer and the
    all_to_all payload is static.

    :returns: ``(y, aux_loss)`` with ``y`` sharded like ``x``; ``aux_loss``
        is the mesh-mean Switch load-balancing loss (add to the objective
        scaled by ~1e-2).
    """
    E = params["router"].shape[-1]
    ep = mesh.shape[expert_axis]
    if E % ep:
        raise ValueError(f"{E} experts not divisible over expert axis of size {ep}")
    dp = mesh.shape[data_axis] if data_axis is not None else 1
    lead = x.shape[:-1]
    n_tokens = int(np.prod(lead))
    # rows shard over dim 0 only, so THAT dim must divide over the shards
    if lead[0] % (dp * ep):
        raise ValueError(f"{lead[0]} tokens/rows not divisible over {dp * ep} shards")
    if capacity is None:
        capacity = _capacity(n_tokens // (dp * ep), E, k, capacity_factor)

    row_axes = (data_axis, expert_axis) if data_axis is not None else expert_axis

    def _param_spec(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "router":
            return P(*([None] * leaf.ndim))
        return P(expert_axis, *([None] * (leaf.ndim - 1)))

    if mask is None:
        mask = jnp.ones(lead, bool)
    in_specs = (
        jax.tree_util.tree_map_with_path(_param_spec, params),
        P(row_axes, *([None] * (x.ndim - 1))),
        P(row_axes, *([None] * (x.ndim - 2))),
    )
    out_specs = (P(row_axes, *([None] * (x.ndim - 1))), P())

    def body(params_l, x_l, mask_l):
        xt = x_l.reshape(-1, x_l.shape[-1])  # [n_local, D]
        dispatch, combine, aux = _route(params_l, xt, k, capacity, mask_l)
        buf = jnp.einsum("nd,nec->ecd", xt, dispatch)  # [E, C, D]
        buf = buf.reshape(ep, E // ep, capacity, buf.shape[-1])
        if ep > 1:
            # scatter: slice g goes to expert-group g; gather the slices all
            # peers hold for OUR experts (dim 0 becomes the source shard)
            buf = jax.lax.all_to_all(buf, expert_axis, split_axis=0, concat_axis=0)
        # [source, local_expert, C, D] -> [local_expert, source*C, D]
        buf = buf.transpose(1, 0, 2, 3)
        y = _expert_ffn(params_l, buf.reshape(E // ep, ep * capacity, buf.shape[-1]))
        y = y.reshape(E // ep, ep, capacity, y.shape[-1]).transpose(1, 0, 2, 3)
        if ep > 1:
            # slice s returns to source shard s; dim 0 becomes the expert
            # group again, matching the dispatch one-hot's expert numbering
            y = jax.lax.all_to_all(y, expert_axis, split_axis=0, concat_axis=0)
        y = y.reshape(E, capacity, y.shape[-1])
        out = jnp.einsum("ecd,nec->nd", y, combine.astype(y.dtype))
        axes = (expert_axis,) if data_axis is None else (data_axis, expert_axis)
        aux = jax.lax.pmean(aux, axes)
        return out.reshape(x_l.shape), aux

    return jax.shard_map(
        body, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )(params, x, mask)
