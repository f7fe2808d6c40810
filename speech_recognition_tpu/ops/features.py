"""On-device audio feature frontend (STFT → spectrogram / log-mel / MFCC).

XLA-native reimplementation of the reference's tf.signal feature chain
(reference: speech_recognition/data.py:122-241).  All functions are pure,
jit-compatible, static-shaped, and validated numerically against tf.signal in
tests/test_features.py.  The heavy ops (mel filterbank projection, DCT-II)
are expressed as matmuls so XLA runs them on the matrix units; framing is a gather;
the FFT uses XLA's native rfft.

Conventions matched to tf.signal:
- ``stft``: pad_end=False framing (num_frames = (T - frame_length)//step + 1),
  periodic Hann window, frames zero-padded (or truncated) to fft_length.
- ``linear_to_mel_weight_matrix``: HTK mel scale (1127 * ln(1 + f/700)),
  linear band edges in mel space, DC bin zeroed (tf.signal's bands_to_zero=1).
- ``mfcc``: orthogonally re-scaled DCT-II of the log-mel spectrogram
  (tf.signal.mfccs_from_log_mel_spectrograms).
"""

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def hertz_to_mel(frequencies_hertz):
    return _MEL_HIGH_FREQUENCY_Q * np.log1p(np.asarray(frequencies_hertz, np.float64) / _MEL_BREAK_FREQUENCY_HERTZ)


def hann_window(window_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, matching tf.signal.hann_window(periodic=True)."""
    n = np.arange(window_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_length)).astype(dtype)


@functools.lru_cache(maxsize=32)
def linear_to_mel_weight_matrix(
    num_mel_bins: int = 20,
    num_spectrogram_bins: int = 129,
    sample_rate: float = 8000.0,
    lower_edge_hertz: float = 125.0,
    upper_edge_hertz: float = 3800.0,
) -> np.ndarray:
    """Mel filterbank identical to tf.signal.linear_to_mel_weight_matrix.

    Computed in float64 on host (cached) and handed to the device as an
    [num_spectrogram_bins, num_mel_bins] float32 constant.
    """
    def _hz_to_mel32(f):
        # float32 log(1 + x) (not log1p) for bit-parity with tf.signal
        return np.float32(_MEL_HIGH_FREQUENCY_Q) * np.log(
            np.float32(1.0) + np.asarray(f, np.float32) / np.float32(_MEL_BREAK_FREQUENCY_HERTZ)
        )

    def _linspace32(start, stop, num):
        # tf.linspace: start + i * (stop - start)/(num - 1), all in float32
        start = np.float32(start)
        delta = (np.float32(stop) - start) / np.float32(num - 1)
        return start + np.arange(num, dtype=np.float32) * delta

    bands_to_zero = 1
    nyquist_hertz = sample_rate / 2.0
    linear_frequencies = _linspace32(0.0, nyquist_hertz, num_spectrogram_bins)[bands_to_zero:]
    spectrogram_bins_mel = _hz_to_mel32(linear_frequencies)[:, None]

    # num_mel_bins + 2 edges, framed into overlapping triples (lower, center, upper)
    band_edges_mel = _linspace32(
        _hz_to_mel32(lower_edge_hertz), _hz_to_mel32(upper_edge_hertz), num_mel_bins + 2
    )
    lower_edge_mel = band_edges_mel[None, :-2]
    center_mel = band_edges_mel[None, 1:-1]
    upper_edge_mel = band_edges_mel[None, 2:]

    lower_slopes = (spectrogram_bins_mel - lower_edge_mel) / (center_mel - lower_edge_mel)
    upper_slopes = (upper_edge_mel - spectrogram_bins_mel) / (upper_edge_mel - center_mel)
    mel_weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))
    mel_weights = np.pad(mel_weights, [[bands_to_zero, 0], [0, 0]])
    return mel_weights.astype(np.float32)


def frame_signal(audio, frame_length: int, frame_step: int, xp=jnp):
    """Frame a 1-D signal into [num_frames, frame_length] (pad_end=False)."""
    num_samples = audio.shape[-1]
    num_frames = max((num_samples - frame_length) // frame_step + 1, 0)
    if num_frames <= 0:
        return xp.zeros(audio.shape[:-1] + (0, frame_length), audio.dtype)
    starts = np.arange(num_frames) * frame_step
    idx = starts[:, None] + np.arange(frame_length)[None, :]
    return audio[..., idx]


def stft(audio, frame_length: int, frame_step: int, fft_length: Optional[int] = None, xp=jnp):
    """Short-time Fourier transform matching tf.signal.stft semantics.

    ``xp`` selects the array backend: jnp for the on-device path, np for the
    host per-example pipeline (avoids per-length XLA recompilation).

    :param audio: [..., NumSamples] float signal
    :return: [..., NumFrames, fft_length // 2 + 1] complex64
    """
    if fft_length is None:
        fft_length = int(2 ** np.ceil(np.log2(frame_length)))
    frames = frame_signal(audio, frame_length, frame_step, xp=xp)
    window = xp.asarray(hann_window(frame_length))
    frames = frames * window
    # rfft zero-pads (or truncates) the last axis to fft_length, as tf does.
    out = xp.fft.rfft(frames, n=fft_length, axis=-1)
    if xp is np:
        out = out.astype(np.complex64)
    return out


@functools.lru_cache(maxsize=32)
def _windowed_rdft_basis(frame_length: int, fft_length: int) -> np.ndarray:
    """Hann window fused into a real-DFT basis: [L, 2*(fft//2+1)] float32
    with L = min(frame_length, fft_length); columns = [Re | -Im].

    tf.signal.stft windows the full frame, then rfft(n=fft_length) truncates
    or zero-pads — so only the first L (windowed) samples contribute, with
    window weights window[:L].  Computed in float64 on host."""
    L = min(frame_length, fft_length)
    n = np.arange(L, dtype=np.float64)[:, None]
    k = np.arange(fft_length // 2 + 1, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * n * k / fft_length
    w = hann_window(frame_length, np.float64)[:L, None]
    return np.concatenate([np.cos(angle) * w, -np.sin(angle) * w], axis=1).astype(np.float32)


def power_stft(audio, frame_length: int, frame_step: int, fft_length: Optional[int] = None, xp=jnp):
    """|STFT|² (power spectrum).

    On device the window + rDFT collapse into ONE [L, 2K] matmul
    (precision=HIGHEST: f32-exact, max |Δ| 4e-7 of peak power vs rfft) —
    XLA's non-power-of-two FFT (e.g. the shipped fft_length=320) costs 9 ms
    at bench shapes where the matmul costs 2.3 (PERF.md round-7).  The host
    (numpy) path keeps np.fft.rfft.  SRT_MATMUL_STFT=0 reverts to rfft.

    :param audio: [..., NumSamples] float signal
    :return: [..., NumFrames, fft_length // 2 + 1] float32 power
    """
    import os

    if fft_length is None:
        fft_length = int(2 ** np.ceil(np.log2(frame_length)))
    if xp is np or os.environ.get("SRT_MATMUL_STFT", "1") == "0":
        mag = xp.abs(stft(audio, frame_length, frame_step, fft_length, xp=xp)).astype(xp.float32)
        return mag * mag
    hi = jax.lax.Precision.HIGHEST
    L = min(frame_length, fft_length)
    basis = _windowed_rdft_basis(frame_length, fft_length)
    num_samples = audio.shape[-1]
    num_frames = (num_samples - frame_length) // frame_step + 1
    m, rem = divmod(frame_length, frame_step)
    if rem == 0 and num_frames > 0:
        # framing never materializes: frame t = m consecutive step-blocks, so
        # proj = sum_i blocks[t+i] @ basis[i*step:(i+1)*step] — m matmuls over
        # CONTIGUOUS views (saves writing + re-reading the 2x-overlapped
        # framed tensor: 168 MB at bench shapes)
        basis_full = np.zeros((frame_length, basis.shape[1]), np.float32)
        basis_full[:L] = basis
        nblocks = num_samples // frame_step
        blocks = audio[..., : nblocks * frame_step].astype(jnp.float32)
        blocks = blocks.reshape(audio.shape[:-1] + (nblocks, frame_step))
        proj = None
        for i in range(m):
            piece = jnp.asarray(basis_full[i * frame_step : (i + 1) * frame_step])
            term = jnp.matmul(blocks[..., i : i + num_frames, :], piece, precision=hi)
            proj = term if proj is None else proj + term
    else:
        frames = frame_signal(audio, frame_length, frame_step, xp=xp)
        proj = jnp.matmul(
            frames[..., :L].astype(jnp.float32), jnp.asarray(basis), precision=hi
        )
    num_bins = fft_length // 2 + 1
    re, im = proj[..., :num_bins], proj[..., num_bins:]
    return re * re + im * im


def _with_channel(feature: jnp.ndarray) -> jnp.ndarray:
    return feature[..., None]


def make_spectrogram(frame_length: int, frame_step: int, fft_length: Optional[int] = None, xp=jnp):
    """Magnitude spectrogram feature fn (reference data.py:122-142).

    Returns fn(audio [NumSamples]) -> [NumFrame, fft_length//2+1, 1].
    """

    def _fn(audio, text=None):
        spectrogram = xp.sqrt(power_stft(audio, frame_length, frame_step, fft_length, xp=xp))
        spectrogram = _with_channel(spectrogram)
        return spectrogram if text is None else (spectrogram, text)

    return _fn


def make_log_mel_spectrogram(
    sample_rate: int,
    frame_length: int,
    frame_step: int,
    fft_length: int,
    num_mel_bins: int = 80,
    lower_edge_hertz: float = 80.0,
    upper_edge_hertz: float = 7600.0,
    epsilon: float = 1e-12,
    xp=jnp,
):
    """Log-mel spectrogram feature fn (reference data.py:145-189).

    Chain: |STFT|² → mel filterbank matmul → log(x + eps).
    Returns fn(audio [NumSamples]) -> [NumFrame, num_mel_bins, 1].
    """
    mel_filterbank = linear_to_mel_weight_matrix(
        num_mel_bins, fft_length // 2 + 1, sample_rate, lower_edge_hertz, upper_edge_hertz
    )

    def _fn(audio, text=None):
        power = power_stft(audio, frame_length, frame_step, fft_length, xp=xp)
        if xp is np:
            mel = power @ mel_filterbank
        else:
            # pin full f32 matmul precision (DEFAULT may drop to TF32/bf16
            # passes and silently break the tf.signal parity the CPU-backend
            # tests certify)
            mel = jnp.matmul(power, jnp.asarray(mel_filterbank), precision=jax.lax.Precision.HIGHEST)
        log_mel = _with_channel(xp.log(mel + epsilon))
        return log_mel if text is None else (log_mel, text)

    return _fn


@functools.lru_cache(maxsize=32)
def _dct2_matrix(num_inputs: int) -> np.ndarray:
    """Unnormalized DCT-II as a matmul matrix [num_inputs, num_inputs].

    X[k] = 2 * sum_n x[n] * cos(pi * k * (2n + 1) / (2N)), matching
    tf.signal.dct(type=2, norm=None).
    """
    n = np.arange(num_inputs, dtype=np.float64)[:, None]
    k = np.arange(num_inputs, dtype=np.float64)[None, :]
    return (2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * num_inputs))).astype(np.float32)


def make_mfcc(
    sample_rate: int,
    frame_length: int,
    frame_step: int,
    fft_length: int,
    num_mel_bins: int = 80,
    num_mfcc: int = 40,
    lower_edge_hertz: float = 80.0,
    upper_edge_hertz: float = 7600.0,
    epsilon: float = 1e-12,
    xp=jnp,
):
    """MFCC feature fn (reference data.py:192-241).

    tf.signal.mfccs_from_log_mel_spectrograms == DCT-II(log_mel) * rsqrt(2N);
    here the DCT is a [N, num_mfcc] matmul.
    Returns fn(audio [NumSamples]) -> [NumFrame, num_mfcc, 1].
    """
    log_mel_fn = make_log_mel_spectrogram(
        sample_rate,
        frame_length,
        frame_step,
        fft_length,
        num_mel_bins,
        lower_edge_hertz,
        upper_edge_hertz,
        epsilon,
        xp=xp,
    )
    dct_matrix = _dct2_matrix(num_mel_bins)[:, :num_mfcc] / np.sqrt(num_mel_bins * 2.0)

    def _fn(audio, text=None):
        log_mel = log_mel_fn(audio)[..., 0]
        if xp is np:
            mfcc = _with_channel(log_mel @ dct_matrix)
        else:
            mfcc = _with_channel(
                jnp.matmul(log_mel, jnp.asarray(dct_matrix), precision=jax.lax.Precision.HIGHEST)
            )
        return mfcc if text is None else (mfcc, text)

    return _fn


def delta_accelerate(audio, text=None, xp=None):
    """Append delta and delta-delta channels (reference data.py:310-328).

    :param audio: [TimeStep, FrequencyDim, 1]
    :return: [TimeStep, FrequencyDim, 3]
    """
    if xp is None:
        xp = np if isinstance(audio, np.ndarray) else jnp
    zero_head = xp.zeros_like(audio[:1])
    delta = audio - xp.concatenate([zero_head, audio[:-1]], axis=0)
    accel = delta - xp.concatenate([zero_head, delta[:-1]], axis=0)
    out = xp.concatenate([audio, delta, accel], axis=2)
    return out if text is None else (out, text)
