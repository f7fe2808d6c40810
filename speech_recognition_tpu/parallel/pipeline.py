"""GPipe-style pipeline parallelism over a named mesh axis.

The reference framework scales only by data parallelism (its strategy
replicas, reference speech_recognition/utils.py:130-156).  This module adds
a third axis: a homogeneous stack of layers (the deep BiRNN
trunks of DeepSpeech2-style models — reference models/deepspeech.py:40-60 —
are exactly this shape) is split into S stages laid over a ``pipe`` mesh
axis, and microbatches stream through the stages GPipe-style
(arXiv:1811.06965): stage s computes microbatch m at tick ``m + s`` and
hands its activation to stage s+1 over ICI with ``lax.ppermute``.

Everything is expressed with XLA-friendly collectives inside one
``shard_map``:

- the tick loop is a ``lax.scan`` (static ``M + S - 1`` trip count),
- inter-stage transfer is a single ``ppermute`` per tick (a neighbour copy
  that rides ICI),
- the result broadcast off the last stage is one ``psum``.

``jax.grad`` through the whole thing yields the standard GPipe backward
schedule automatically: the scan transposes to a reverse-order scan and the
``ppermute`` to its inverse permutation, so cotangents flow last-stage →
first-stage with the same microbatch pipelining — no hand-written backward
pass.

Composes with data parallelism: run it on a ``('data', 'pipe')`` mesh and
shard the microbatch rows over ``data`` (see ``tests/test_pipeline_parallel.py``
for the dp x pp equivalence pin).

Bubble fraction is the usual (S-1)/(M+S-1); pick ``n_micro`` >= 4*S for
>=80% utilisation.  This is a scaling capability for stacks too deep or too
wide for one chip's HBM — at the shipped model sizes (LAS-small, DS2) a
single chip holds the whole model and plain DP is faster; nothing routes
through here by default.
"""

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def _stage_slice(params: Any) -> Any:
    """Drop the per-device singleton stage axis shard_map leaves on params."""
    return jax.tree_util.tree_map(lambda leaf: leaf[0], params)


def gpipe(
    stage_fn: Callable,
    stage_params: Any,
    x: jnp.ndarray,
    n_micro: int,
    mesh: Mesh,
    pipe_axis: str = "pipe",
    data_axis: Optional[str] = None,
    const: tuple = (),
):
    """Stream ``x`` through ``S = mesh.shape[pipe_axis]`` pipeline stages.

    :param stage_fn: ``stage_fn(params_s, x_mb, *const_mb) -> y_mb`` — one
        stage's computation.  Activations must be shape-homogeneous
        (``y_mb.shape == x_mb.shape``): that is what lets every device run
        the same program on its own stage's weights (SPMD).
    :param stage_params: pytree whose leaves carry a leading stage axis
        ``[S, ...]``; stage s uses ``leaf[s]`` (sharded over ``pipe_axis``).
    :param x: batch-leading input ``[B, ...]``; split into ``n_micro``
        microbatches of ``B / n_micro`` rows.
    :param const: batch-leading side inputs (e.g. the frame mask) handed to
        every stage alongside its current microbatch, never transformed.
    :param data_axis: optional mesh axis to shard microbatch rows over
        (composes pp with dp).
    :returns: ``y [B, ...]`` — the last stage's outputs, microbatch order
        restored.
    """
    S = mesh.shape[pipe_axis]
    M = int(n_micro)
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    if M < S:
        raise ValueError(f"need n_micro >= pipeline stages ({S}), got {M}")

    def _micro(a):
        return a.reshape((M, B // M) + a.shape[1:])

    xm = _micro(x)
    cm = tuple(_micro(c) for c in const)

    def _mb_spec(a):
        # [M, b, ...]: microbatch axis replicated, rows over data_axis
        return P(None, data_axis, *([None] * (a.ndim - 2)))

    def _param_spec(leaf):
        return P(pipe_axis, *([None] * (leaf.ndim - 1)))

    in_specs = (
        jax.tree_util.tree_map(_param_spec, stage_params),
        _mb_spec(xm),
        jax.tree_util.tree_map(_mb_spec, cm),
    )
    out_spec = _mb_spec(xm)

    def pipeline_body(params, xm, cm):
        p = _stage_slice(params)
        s = jax.lax.axis_index(pipe_axis)
        fwd = [(i, i + 1) for i in range(S - 1)]

        def tick(buf, t):
            # stage s works on microbatch t - s; clip keeps the index legal
            # during fill/drain ticks (those outputs are never consumed)
            mb = jnp.clip(t - s, 0, M - 1)
            inp = jnp.where(s == 0, xm[mb], buf)
            y = stage_fn(p, inp, *(c[mb] for c in cm))
            buf_next = jax.lax.ppermute(y, pipe_axis, fwd) if S > 1 else y
            return buf_next, y

        _, ys = jax.lax.scan(tick, jnp.zeros_like(xm[0]), jnp.arange(M + S - 1))
        # microbatch m finishes on the LAST stage at tick m + S - 1
        outs = ys[S - 1 :]
        outs = jnp.where(s == S - 1, outs, jnp.zeros_like(outs))
        return jax.lax.psum(outs, pipe_axis)

    ym = jax.shard_map(
        pipeline_body,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_spec,
        check_vma=False,
    )(stage_params, xm, cm)
    return ym.reshape((B,) + ym.shape[2:])


def stack_stage_fn(layer_fn: Callable) -> Callable:
    """Turn a per-layer fn into a stage fn running its chunk of the stack.

    ``layer_fn(layer_params, x, *const) -> y`` is applied sequentially over
    the stage's local layers (params leaves ``[layers_per_stage, ...]``) via
    ``lax.scan`` — one compiled layer body per stage regardless of depth.
    """

    def stage_fn(stage_params, x, *const):
        def body(h, layer_params):
            return layer_fn(layer_params, h, *const), None

        y, _ = jax.lax.scan(body, x, stage_params)
        return y

    return stage_fn


def stack_params(per_layer_params: list, n_stages: int) -> Any:
    """Stack L per-layer param pytrees into stage-major ``[S, L/S, ...]``
    leaves ready for ``gpipe(stack_stage_fn(...), ...)``."""
    L = len(per_layer_params)
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible into {n_stages} stages")
    stacked = jax.tree_util.tree_map(lambda *leaves: jnp.stack(leaves), *per_layer_params)
    return jax.tree_util.tree_map(
        lambda leaf: leaf.reshape((n_stages, L // n_stages) + leaf.shape[1:]), stacked
    )
