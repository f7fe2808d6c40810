"""Depthwise temporal convolution with an SPMD-safe backward.

XLA's SPMD partitioner mis-partitions the KERNEL gradient of a grouped
(``feature_group_count=C``) convolution whenever the device mesh has more
than one axis: the grad comes back multiplied by the size of the axes the
operands aren't sharded over (measured on the virtual CPU mesh: a batch
sharded P('data') on a ('data','model') mesh yields dkernel scaled ~x2 at
model=2, ~x4 at model=4, while the forward and the input grad stay exact).
The grad of a grouped conv lowers to a batch_group_count conv — that is the
broken op; forward-type grouped convs partition correctly.

``depthwise_conv1d`` therefore wraps the grouped-conv forward in a
``jax.custom_vjp``:

* forward: ``lax.conv_general_dilated`` with ``feature_group_count=C`` —
  XLA's native depthwise conv, unchanged performance.
* dx: a forward-type grouped conv of ``dy`` with the tap-reversed kernel
  and mirrored explicit padding (the exact transpose of SAME stride-1).
* dkernel: an unrolled tap-sum — ``dk[k,c] = sum_{b,t} xp[b,t+k,c] *
  dy[b,t,c]`` over the SAME-padded input — K static-slice elementwise
  reductions, no grouped-grad conv anywhere, so SPMD partitioning is just
  elementwise + psum and stays exact on any mesh.

The workaround is only needed where the partitioner runs: on a single
device the plain grouped-conv autodiff is exact AND keeps the whole
backward as plain matmuls, so ``depthwise_conv1d`` auto-selects it there
(``spmd_safe=None`` -> devices > 1; ``SRT_SPMD_SAFE_DWCONV=0/1``
overrides).  The tap-sum accumulates in f32 (``jnp.sum(dtype=f32)``) —
bf16 products, f32 accumulation, matching the conv's own matmul semantics
over the ~B*T-term reduction.

Used by the Conformer convolution module (models/conformer.py) and through
it the Transducer encoder.  Gradient equivalence vs plain autodiff is
pinned in tests/test_dw_conv.py, sharded-mesh equivalence in
tests/test_parallel.py.
"""

import os

import jax
import jax.numpy as jnp

__all__ = ["depthwise_conv1d"]


def _same_pads(K: int):
    """XLA SAME padding for stride 1: (low, high) with high >= low."""
    return (K - 1) // 2, K // 2


def _forward(x, kernel):
    C = x.shape[-1]
    return jax.lax.conv_general_dilated(
        x,
        kernel,
        window_strides=(1,),
        padding="SAME",
        feature_group_count=C,
        dimension_numbers=("NTC", "TIO", "NTC"),
    )


@jax.custom_vjp
def _spmd_safe_conv(x, kernel):
    return _forward(x, kernel)


def _auto_spmd_safe() -> bool:
    """Conservative auto: safe on ANY multi-device run.  The grouped-grad
    bug needs >1 nontrivial mesh axes, and a pure data-parallel mesh is
    exact (pinned in tests/test_dw_conv.py::
    test_raw_grad_exact_on_single_axis_mesh) — but this module cannot see
    which mesh a caller actually shards over (the active-mesh registry is
    advisory; ad-hoc NamedSharding bypasses it, and a registry probe here
    mis-gated exactly that way under test).  Callers that KNOW their mesh
    is single-axis opt into the plain-autodiff backward with
    SRT_SPMD_SAFE_DWCONV=0 — run/train.py does so for its pure-dp mesh."""
    env = os.environ.get("SRT_SPMD_SAFE_DWCONV")
    if env is not None:
        return env == "1"
    return len(jax.devices()) > 1


def depthwise_conv1d(x, kernel, *, spmd_safe=None):
    """[B, T, C] x [K, 1, C] -> [B, T, C], SAME padding, stride 1.

    ``spmd_safe``: True -> custom-VJP tap-sum kernel grad (exact on any
    mesh); False -> plain XLA autodiff (fastest, single-device only);
    None -> auto (safe whenever more than one device is visible).
    """
    if spmd_safe is None:
        spmd_safe = _auto_spmd_safe()
    if spmd_safe:
        return _spmd_safe_conv(x, kernel)
    return _forward(x, kernel)


def _fwd(x, kernel):
    return _forward(x, kernel), (x, kernel)


def _bwd(res, dy):
    x, kernel = res
    K = kernel.shape[0]
    C = x.shape[-1]
    lo, hi = _same_pads(K)

    # dx: correlate dy with the tap-reversed kernel; the transpose of
    # SAME(lo, hi) is explicit padding (hi, lo).  Forward-type grouped
    # conv — the op class the partitioner handles correctly.
    dx = jax.lax.conv_general_dilated(
        dy,
        kernel[::-1],
        window_strides=(1,),
        padding=((hi, lo),),
        feature_group_count=C,
        dimension_numbers=("NTC", "TIO", "NTC"),
    )

    # dkernel[k, 0, c] = sum_{b,t} xp[b, t+k, c] * dy[b, t, c]; f32
    # accumulation over the B*T-term reduction (bf16 products would lose
    # the conv's f32-accumulate semantics under mixed precision)
    T = x.shape[1]
    xp = jnp.pad(x, ((0, 0), (lo, hi), (0, 0)))
    dk = jnp.stack(
        [jnp.sum(xp[:, k : k + T, :] * dy, axis=(0, 1), dtype=jnp.float32) for k in range(K)]
    )
    return dx, dk[:, None, :].astype(kernel.dtype)


_spmd_safe_conv.defvjp(_fwd, _bwd)
