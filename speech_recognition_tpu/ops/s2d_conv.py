"""VALID Conv2D with a time-space-to-depth fast path for stride-2 time.

A VALID conv whose time stride is 2 satisfies, for taps w[d] (d < kt):

    y[t'] = sum_d x[2t'+d] w[d] = sum_{p in {0,1}} sum_e x[2(t'+e)+p] w[2e+p]

so on the phase-split input xs[u, (p,c)] = x[2u+p, c] it becomes a
STRIDE-1 VALID conv with kernel k2[e, kf, (p,c), o] = w[2e+p, kf, c, o]
(taps zero-padded to an even count).  Stride-1 convs need no input
dilation in either gradient, which matters where the compiler's
dilated-correlation backward for the strided conv is slow (DeepSpeech2's
large 41x11 / 21x11 kernels).

``Conv2DValid`` is a drop-in for ``nn.Conv(..., padding="VALID")`` with an
identical parameter pytree ("kernel" [kt,kf,ci,co] lecun-normal, "bias"
[co] zeros — the Keras/TF layout the checkpoint converter maps onto;
reference conv stacks: speech_recognition/models/deepspeech2.py:47-59 and
models/las.py:159-164).  The weight rearrangement happens inside the
forward, so checkpoints and the converter are unaffected and autodiff
routes dW through the (exact) pad/reshape/transpose.

Gate: off by default; SRT_S2D_CONV=1 uses the phase-split path for
wide (>= 8 tap) time kernels with time stride 2, "force" for every
stride-2 conv (tests).  Whether it pays on the GPU is an open A/B.
"""

import functools
import os
from typing import Tuple

import jax
import jax.numpy as jnp

from .. import nn


def _s2d_enabled(time_stride: int, time_taps: int) -> bool:
    v = os.environ.get("SRT_S2D_CONV", "0")
    if v == "0" or time_stride != 2:
        return False
    if v == "force":
        return True
    # phase-split only pays when the dilated backward is the dominant
    # cost, i.e. for wide time kernels
    return time_taps >= 8


def valid_conv2d(x, kernel, strides):
    dn = jax.lax.conv_dimension_numbers(x.shape, kernel.shape, ("NHWC", "HWIO", "NHWC"))
    return jax.lax.conv_general_dilated(x, kernel, strides, "VALID", dimension_numbers=dn)


def _phase_split_time(x, kernel):
    """Rewrite (x, kernel) so a stride-2 conv over x's axis 1 becomes a
    stride-1 conv over the split pair.  Returns (xs, k2)."""
    B, T, F, C = x.shape
    kt, kf, ci, co = kernel.shape
    kt2 = (kt + 1) // 2
    if T % 2:
        # the pad frame is provably never read by the first t_out outputs
        x = jnp.pad(x, ((0, 0), (0, 1), (0, 0), (0, 0)))
        T += 1
    xs = x.reshape(B, T // 2, 2, F, C).transpose(0, 1, 3, 2, 4).reshape(B, T // 2, F, 2 * C)
    wp = jnp.pad(kernel, ((0, 2 * kt2 - kt), (0, 0), (0, 0), (0, 0)))
    k2 = wp.reshape(kt2, 2, kf, ci, co).transpose(0, 2, 1, 3, 4).reshape(kt2, kf, 2 * ci, co)
    return xs, k2


def _phase_split_freq(x, kernel):
    """Same identity on the freq axis.  Because freq is adjacent to the
    channel axis, both rearrangements are CONTIGUOUS reshapes — no
    transpose/relayout."""
    B, T, F, C = x.shape
    kt, kf, ci, co = kernel.shape
    kf2 = (kf + 1) // 2
    if F % 2:
        x = jnp.pad(x, ((0, 0), (0, 0), (0, 1), (0, 0)))
        F += 1
    xs = x.reshape(B, T, F // 2, 2 * C)
    wp = jnp.pad(kernel, ((0, 0), (0, 2 * kf2 - kf), (0, 0), (0, 0)))
    k2 = wp.reshape(kt, kf2, 2 * ci, co)
    return xs, k2


def time_s2d_valid_conv2d(x, kernel, strides, split_freq: bool = False):
    """VALID conv with time stride 2 via the phase-split stride-1 form;
    optionally also phase-splits a stride-2 freq axis."""
    st, sf = strides
    assert st == 2, "phase-split form requires time stride 2"
    T, F = x.shape[1], x.shape[2]
    kt, kf = kernel.shape[0], kernel.shape[1]
    t_out = (T - kt) // 2 + 1
    x, kernel = _phase_split_time(x, kernel)
    if split_freq:
        assert sf == 2
        f_out = (F - kf) // 2 + 1
        x, kernel = _phase_split_freq(x, kernel)
        y = valid_conv2d(x, kernel, (1, 1))
        return y[:, :t_out, :f_out]
    y = valid_conv2d(x, kernel, (1, sf))
    # the phase conv can emit one extra step (even kt); slice to the exact
    # strided-conv output length
    return y[:, :t_out]


def _pdx_enabled() -> bool:
    # opt-in only (SRT_PDX_CONV=1 or "force"): a validated alternative for
    # shapes where the dilated backward dominates
    return os.environ.get("SRT_PDX_CONV", "0") != "0"


def _dx_kernel(kernel, strides):
    """Rearrange a conv kernel into the stride-1 correlation kernel whose
    outputs are the PHASES of d/d(input).

    For a stride-2 axis, dx[2u+p] = sum_e dy[u-e] * w[2e+p]: each phase p is
    a stride-1 correlation of dy with the taps d === p (mod 2), reversed.
    All phases stack on the OUTPUT channel axis (with dy's channels as the
    conv input channels), so the whole dx is ONE stride-1 conv with
    ci*(phases) output channels followed by a depth-to-space interleave —
    no input dilation anywhere.  A stride-1 axis keeps the standard
    transposed-conv form (full correlation with reversed taps)."""
    kt, kf, ci, co = kernel.shape
    st, sf = strides
    if st == 2:
        Lt = -(-kt // 2)
        k = jnp.pad(kernel, ((0, 2 * Lt - kt), (0, 0), (0, 0), (0, 0)))
        k = k.reshape(Lt, 2, kf, ci, co)[::-1]  # [Lt, Pt, kf, ci, co]
    else:
        k = kernel[::-1][:, None]  # [kt, 1, kf, ci, co]
    Lt, Pt = k.shape[0], k.shape[1]
    if sf == 2:
        Lf = -(-kf // 2)
        k = jnp.pad(k, ((0, 0), (0, 0), (0, 2 * Lf - kf), (0, 0), (0, 0)))
        k = k.reshape(Lt, Pt, Lf, 2, ci, co)[:, :, ::-1]  # [Lt,Pt,Lf,Pf,ci,co]
    else:
        k = k[:, :, ::-1][:, :, :, None]  # [Lt, Pt, kf, 1, ci, co]
    Lf, Pf = k.shape[2], k.shape[3]
    # dy channels (co) become the conv input; phases x ci the output
    k = k.transpose(0, 2, 5, 1, 3, 4).reshape(Lt, Lf, co, Pt * Pf * ci)
    return k, (Lt, Pt), (Lf, Pf)


def _dx_axis_pads(size_in, taps, stride, L, out):
    if stride == 2:
        U = -(-size_in // 2)
        return U, L - 1, U - out
    return size_in, taps - 1, taps - 1


def conv2d_dx_phase(dy, kernel, strides, x_shape):
    """d/d(input) of ``valid_conv2d(x, kernel, strides)`` for strides in
    {1,2}, computed WITHOUT input dilation."""
    B, T, F = x_shape[0], x_shape[1], x_shape[2]
    kt, kf, ci, co = kernel.shape
    k2, (Lt, Pt), (Lf, Pf) = _dx_kernel(kernel, strides)
    To, Fo = dy.shape[1], dy.shape[2]
    Ut, pt_f, pt_b = _dx_axis_pads(T, kt, strides[0], Lt, To)
    Uf, pf_f, pf_b = _dx_axis_pads(F, kf, strides[1], Lf, Fo)
    dyp = jnp.pad(dy, ((0, 0), (pt_f, pt_b), (pf_f, pf_b), (0, 0)))
    z = valid_conv2d(dyp, k2, (1, 1))  # [B, Ut, Uf, Pt*Pf*ci]
    z = z.reshape(B, Ut, Uf, Pt, Pf, ci)
    z = z.transpose(0, 1, 3, 2, 4, 5).reshape(B, Ut * Pt, Uf * Pf, ci)
    return z[:, :T, :F]


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def valid_conv2d_pdx(x, kernel, strides):
    """valid_conv2d with a phase-decomposed d/d(input): forward and dW keep
    XLA's native paths (both fast for small kernels); only the pathological
    dilated dx is replaced (for small strided kernels such as the LAS conv
    stem, where a whole-conv phase-split pays a relayout of x)."""
    return valid_conv2d(x, kernel, strides)


def _pdx_fwd(x, kernel, strides):
    return valid_conv2d(x, kernel, strides), (x, kernel)


def _pdx_bwd(strides, res, dy):
    x, kernel = res
    _, wvjp = jax.vjp(lambda w: valid_conv2d(x, w, strides), kernel)
    (dw,) = wvjp(dy)
    # dx is dead code (and removed by XLA) when x carries no gradient,
    # e.g. the first conv of a stem whose input is the data batch
    dx = conv2d_dx_phase(dy, kernel, strides, x.shape)
    return dx, dw


valid_conv2d_pdx.defvjp(_pdx_fwd, _pdx_bwd)


class Conv2DValid(nn.Module):
    """Drop-in for ``nn.Conv(features, kernel_size, strides, "VALID")``.

    Same parameter names/shapes/initializers as nn.Conv so existing
    checkpoints and the TF converter (compat/tf_checkpoint.py) see no
    difference; the only change is the compute path dispatch.
    """

    features: int
    kernel_size: Tuple[int, int]
    strides: Tuple[int, int]
    padding: str = "VALID"
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        assert self.padding == "VALID"
        kt, kf = self.kernel_size
        kernel = self.param(
            "kernel",
            nn.initializers.lecun_normal(),
            (kt, kf, x.shape[-1], self.features),
            jnp.float32,
        )
        bias = self.param("bias", nn.initializers.zeros, (self.features,), jnp.float32)
        x = x.astype(self.dtype)
        kernel = kernel.astype(self.dtype)
        if _s2d_enabled(self.strides[0], kt):
            split_freq = self.strides[1] == 2 and kf >= 8
            y = time_s2d_valid_conv2d(x, kernel, tuple(self.strides), split_freq=split_freq)
        elif 2 in tuple(self.strides) and _pdx_enabled():
            # small strided kernels: forward/dW stay on XLA's native conv,
            # only the dilated d/d(input) is phase-decomposed
            y = valid_conv2d_pdx(x, kernel, tuple(self.strides))
        else:
            y = valid_conv2d(x, kernel, tuple(self.strides))
        return y + bias.astype(self.dtype)
