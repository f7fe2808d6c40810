"""Device mesh + sharding layer (replaces tf.distribute strategies).

The reference selected a tf.distribute strategy per device flag
(reference: speech_recognition/utils.py:130-156) and used data parallelism
only.  Here parallelism is expressed the XLA-native way: a
``jax.sharding.Mesh`` with ``('data', 'model')`` axes; batches are sharded
over ``data``, large vocab-dimension parameters optionally over ``model``
(tensor parallelism), everything else replicated.  Gradient reductions ride
ICI through XLA's automatic collectives — no explicit all-reduce calls.
"""

import contextlib
import re
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def get_num_devices(device: Optional[str] = None) -> int:
    return len(jax.devices())


# ---------------------------------------------------------------- active mesh
# Placement decisions (the MoE layer's expert-parallel dispatch,
# models/moe.py) happen at trace time inside jit, where operand shardings
# are not yet visible.  The mesh the run is built on is registered here so
# they can see its axes.
_ACTIVE_MESH: Optional[Mesh] = None


def set_active_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Register the mesh the current run executes on; returns the previous."""
    global _ACTIVE_MESH
    prev, _ACTIVE_MESH = _ACTIVE_MESH, mesh
    return prev


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


@contextlib.contextmanager
def active_mesh(mesh: Optional[Mesh]):
    prev = set_active_mesh(mesh)
    try:
        yield mesh
    finally:
        set_active_mesh(prev)


def data_axis_size() -> int:
    """Size of the active mesh's 'data' axis (1 when single device / no mesh)."""
    if len(jax.devices()) == 1:
        return 1
    mesh = _ACTIVE_MESH
    if mesh is None or "data" not in mesh.axis_names:
        return 1
    return mesh.shape["data"]


def get_device_mesh(
    data_parallel: Optional[int] = None, model_parallel: int = 1, devices=None
) -> Mesh:
    """Build a ('data', 'model') mesh over the available devices.

    :param data_parallel: size of the data axis (default: all remaining devices)
    :param model_parallel: size of the tensor-parallel axis
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if data_parallel is None:
        if n % model_parallel:
            raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
        data_parallel = n // model_parallel
    mesh_devices = np.asarray(devices[: data_parallel * model_parallel]).reshape(
        data_parallel, model_parallel
    )
    mesh = Mesh(mesh_devices, ("data", "model"))
    set_active_mesh(mesh)
    return mesh


def process_shard() -> Optional[tuple]:
    """(process_index, process_count) when running multi-host, else None.

    The dataset layer strides rows by this (data/dataset.py ``shard=``) so
    each host feeds a disjoint split — the role the reference strategy's automatic
    dataset distribution played for the reference (utils.py:130-156).
    """
    count = jax.process_count()
    return (jax.process_index(), count) if count > 1 else None


def shard_batch(batch, mesh: Mesh, multihost: Optional[bool] = None):
    """Place a pytree of host arrays with the leading batch dim over 'data'.

    Single-host: a plain ``device_put`` with the NamedSharding.  Multi-host
    (``jax.process_count() > 1``, or ``multihost=True`` for tests): each
    process holds only its LOCAL rows (``global_batch / process_count`` —
    the dataset layer's ``shard=`` stride), and
    ``jax.make_array_from_process_local_data`` assembles the global array
    across processes without any cross-host copy of remote rows.
    """
    if multihost is None:
        multihost = jax.process_count() > 1

    def _put(x):
        spec = P("data") if getattr(x, "ndim", 0) >= 1 else P()
        sharding = NamedSharding(mesh, spec)
        if multihost:
            return jax.make_array_from_process_local_data(sharding, np.asarray(x))
        return jax.device_put(x, sharding)

    return jax.tree_util.tree_map(_put, batch)


# tensor-parallel parameter placements: explicit (pattern, spec) pairs so
# the orientation travels with the pattern (order carries no semantics)
_TP_SPECS = (
    (r"feedforward/kernel$", P(None, "model")),      # LAS vocab projection (columns)
    (r"fully_connected/kernel$", P(None, "model")),  # DS2 / Conformer vocab projection
    (r"joint_kernel$", P(None, "model")),            # Transducer joint -> vocab projection
    (r"embedding/embedding$", P("model", None)),     # token embedding (vocab ROWS)
)


def param_spec(path: str, param) -> P:
    """Tensor-parallel PartitionSpec for a parameter path, replicated default."""
    for pat, spec in _TP_SPECS:
        if re.search(pat, path):
            return spec
    return P(*([None] * getattr(param, "ndim", 0)))


def fsdp_spec(param, data_size: int, min_size: int = 2**14) -> P:
    """ZeRO-3-style PartitionSpec: shard the largest axis over 'data'.

    Leaves smaller than ``min_size`` elements, and leaves with no axis
    divisible by ``data_size``, stay replicated (collective latency beats
    the memory win on tiny tensors).  Because the spec depends only on the
    leaf shape, a parameter and its optimizer moments always shard
    identically — updates stay local, XLA all-gathers weights at use sites
    and reduce-scatters their gradients (the ZeRO-3 schedule), all derived
    from these input shardings by SPMD partitioning.
    """
    ndim = getattr(param, "ndim", 0)
    shape = getattr(param, "shape", ())
    if ndim == 0 or int(np.prod(shape)) < min_size:
        return P(*([None] * ndim))
    order = sorted(range(ndim), key=lambda d: shape[d], reverse=True)
    for d in order:
        if shape[d] % data_size == 0:
            spec = [None] * ndim
            spec[d] = "data"
            return P(*spec)
    return P(*([None] * ndim))


def shard_params(
    variables,
    mesh: Mesh,
    tensor_parallel: bool = False,
    fsdp: bool = False,
    fsdp_min_size: int = 2**14,
):
    """Place model variables on the mesh: replicated by default; TP shards
    vocab-dimension params over 'model'; ``fsdp=True`` additionally shards
    every remaining large leaf over 'data' (ZeRO-3 parameter + optimizer
    sharding — beyond the reference's replicated-everything strategy,
    utils.py:130-156)."""
    data_size = mesh.shape.get("data", 1) if fsdp else 1

    def _path_str(path):
        return "/".join(str(getattr(k, "key", k)) for k in path)

    def _place(path, x):
        spec = None
        if tensor_parallel:
            tp = param_spec(_path_str(path), x)
            if any(e is not None for e in tp):
                spec = tp
        if spec is None and fsdp and data_size > 1:
            spec = fsdp_spec(x, data_size, fsdp_min_size)
        if spec is None:
            spec = P(*([None] * getattr(x, "ndim", 0)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map_with_path(_place, variables)
