"""Sequence (time-axis) parallelism: halo exchange for time-local ops.

Audio frontends are local in time — an STFT frame depends only on its own
``frame_length`` samples — so the time axis can shard over a mesh axis with
each shard borrowing a small "halo" of samples from its right neighbour
(the standard spatial-partitioning trick; one ``lax.ppermute`` per
halo side, riding ICI).  This lets a tensor-parallel mesh use its ``model``
axis for the frontend too, instead of idling it through the feature stage.

The reference has no analog (its features ran per-example on the host,
reference run/train.py:70-116); this is a beyond-parity scaling capability.
See ``ops/frontend.py make_sp_batch_frontend`` for the user-facing wrapper
and ``tests/test_sequence_parallel.py`` for the equivalence pins.
"""

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def halo_exchange(x, axis_name: str, time_axis: int, left: int = 0, right: int = 0):
    """Extend a time-sharded block with neighbour edge slices.

    Prepends the LAST ``left`` time-slices of the left neighbour and appends
    the FIRST ``right`` time-slices of the right neighbour along
    ``time_axis``.  Chain ends receive zeros (``ppermute`` semantics), which
    matches zero-padded-signal behaviour at the sequence boundary.

    Call inside ``shard_map`` with the time axis laid over ``axis_name``.
    """
    n = jax.lax.axis_size(axis_name)
    parts = []
    T = x.shape[time_axis]
    if left:
        tail = jax.lax.slice_in_dim(x, T - left, T, axis=time_axis)
        parts.append(
            jax.lax.ppermute(tail, axis_name, [(i, i + 1) for i in range(n - 1)])
        )
    parts.append(x)
    if right:
        head = jax.lax.slice_in_dim(x, 0, right, axis=time_axis)
        parts.append(
            jax.lax.ppermute(head, axis_name, [(i + 1, i) for i in range(n - 1)])
        )
    return jnp.concatenate(parts, axis=time_axis) if len(parts) > 1 else x


def time_sharded(
    fn,
    mesh: Mesh,
    seq_axis: str,
    time_axis: int,
    halo_left: int = 0,
    halo_right: int = 0,
    data_axis: Optional[str] = None,
    out_time_axis: Optional[int] = None,
):
    """Wrap a time-local ``fn(x) -> y`` to run time-sharded over ``seq_axis``.

    ``x``'s ``time_axis`` is laid over the mesh's ``seq_axis``; each shard
    receives its block extended by the halo (neighbour edges, zeros at the
    chain ends) and must emit equal-length time-blocks at ``out_time_axis``
    (default: same as ``time_axis``).  Batch dims can shard over
    ``data_axis`` (axis 0) simultaneously.
    """
    if out_time_axis is None:
        out_time_axis = time_axis

    def _spec(ndim, t_axis):
        parts = [None] * ndim
        if data_axis is not None:
            parts[0] = data_axis
        parts[t_axis] = seq_axis
        return P(*parts)

    def wrapped(x):
        in_spec = _spec(x.ndim, time_axis)

        def body(x_local):
            x_ext = halo_exchange(x_local, seq_axis, time_axis, halo_left, halo_right)
            return fn(x_ext)

        traced = jax.eval_shape(lambda a: fn(a), jax.ShapeDtypeStruct(
            x.shape[:time_axis]
            + (x.shape[time_axis] // mesh.shape[seq_axis] + halo_left + halo_right,)
            + x.shape[time_axis + 1 :],
            x.dtype,
        ))
        out_specs = jax.tree_util.tree_map(lambda s: _spec(s.ndim, out_time_axis), traced)
        return jax.shard_map(
            body, mesh=mesh, in_specs=(in_spec,), out_specs=out_specs, check_vma=False
        )(x)

    return wrapped
