"""Numerical parity of the JAX feature frontend against tf.signal.

This is the fidelity gate from SURVEY.md §7 step 2: the reference computes
features with tf.signal (reference data.py:122-241), so TF (CPU) serves as
the oracle here.
"""

import numpy as np
import pytest

from speech_recognition_tpu.ops import features

tf = pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(42)
    # ~1 s of 16 kHz noise + tones, realistic dynamic range
    t = np.arange(16000) / 16000.0
    sig = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(16000)
    return sig.astype(np.float32)


@pytest.mark.parametrize(
    "frame_length,frame_step,fft_length",
    [(1024, 1024, 1024), (128, 64, 256), (128, 80, None), (512, 512, 256), (320, 160, 320)],
)
def test_stft_matches_tf(audio, frame_length, frame_step, fft_length):
    ours = np.asarray(features.stft(audio, frame_length, frame_step, fft_length))
    theirs = tf.signal.stft(audio, frame_length, frame_step, fft_length).numpy()
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "num_mel_bins,num_spectrogram_bins,sample_rate,lower,upper",
    [
        (80, 161, 16000, 80.0, 7600.0),
        (40, 161, 22050, 80.0, 7600.0),
        (123, 129, 16000, 12.0, 88.0),
        (40, 257, 22050, 20.0, 11025.0),
        (128, 513, 16000, 125.0, 7600.0),
    ],
)
def test_mel_matrix_matches_tf(num_mel_bins, num_spectrogram_bins, sample_rate, lower, upper):
    """Measured bit-level parity with tf.signal.linear_to_mel_weight_matrix.

    The construction (ops/features.py:40-82) replicates TF's float32 op
    order, so >=99% of entries are bitwise identical.  Full bitwise equality
    is unattainable from numpy: TF's Eigen float32 log differs from numpy's
    by 1 ulp on some inputs, and the triangle-slope division amplifies that
    at band edges — measured residual <= 2.5e-5 absolute across all shipped
    configs (exact numbers in PARITY.md).
    """
    ours = features.linear_to_mel_weight_matrix(
        num_mel_bins, num_spectrogram_bins, sample_rate, lower, upper
    )
    theirs = tf.signal.linear_to_mel_weight_matrix(
        num_mel_bins, num_spectrogram_bins, sample_rate, lower, upper
    ).numpy()
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    bitwise_equal = (ours == theirs) | (np.isnan(ours) & np.isnan(theirs))
    assert bitwise_equal.mean() >= 0.99, f"only {bitwise_equal.mean():.4%} bitwise equal"
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=3e-5)


@pytest.mark.parametrize(
    "frame_length,frame_step,fft_length",
    [(320, 160, 320), (1024, 512, 1024), (128, 64, 256), (512, 512, 256), (320, 160, None)],
)
def test_power_stft_matmul_matches_rfft(audio, frame_length, frame_step, fft_length, monkeypatch):
    """The device path's fused windowed-rDFT matmul == |rfft|², across
    power-of-two, non-power-of-two, zero-padded (fft>frame) and truncated
    (fft<frame) transforms.  On the real chip precision=HIGHEST keeps the
    matmul f32-exact (max |Δ| 4e-7 of peak power — PERF.md round-7)."""
    got = np.asarray(features.power_stft(audio, frame_length, frame_step, fft_length))
    monkeypatch.setenv("SRT_MATMUL_STFT", "0")
    ref = np.asarray(features.power_stft(audio, frame_length, frame_step, fft_length))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * max(ref.max(), 1.0))


def test_spectrogram_shape_and_value(audio):
    fn = features.make_spectrogram(320, 160, 320)
    out = np.asarray(fn(audio))
    ref = tf.abs(tf.signal.stft(audio, 320, 160, 320)).numpy()[:, :, None]
    assert out.shape == ((len(audio) - 320) // 160 + 1, 161, 1)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "sample_rate,frame_length,frame_step,fft_length,num_mel_bins,lower,upper",
    [(16000, 320, 160, 320, 80, 80.0, 7600.0), (22050, 1024, 1024, 1024, 80, 10.0, 10000.0)],
)
def test_log_mel_matches_tf(audio, sample_rate, frame_length, frame_step, fft_length, num_mel_bins, lower, upper):
    fn = features.make_log_mel_spectrogram(
        sample_rate, frame_length, frame_step, fft_length, num_mel_bins, lower, upper
    )
    ours = np.asarray(fn(audio))

    spec = tf.abs(tf.signal.stft(audio, frame_length, frame_step, fft_length))
    mel_fb = tf.signal.linear_to_mel_weight_matrix(
        num_mel_bins, fft_length // 2 + 1, sample_rate, lower, upper
    )
    theirs = tf.math.log(tf.matmul(tf.square(spec), mel_fb) + 1e-12).numpy()[:, :, None]
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-3, atol=2e-4)


def test_mfcc_matches_tf(audio):
    fn = features.make_mfcc(16000, 320, 160, 320, 80, 40, 80.0, 7600.0)
    ours = np.asarray(fn(audio))

    spec = tf.abs(tf.signal.stft(audio, 320, 160, 320))
    mel_fb = tf.signal.linear_to_mel_weight_matrix(80, 161, 16000, 80.0, 7600.0)
    log_mel = tf.math.log(tf.matmul(tf.square(spec), mel_fb) + 1e-12)
    theirs = tf.signal.mfccs_from_log_mel_spectrograms(log_mel).numpy()[:, :40, None]
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-3, atol=2e-3)


def test_delta_accelerate(audio):
    fn = features.make_log_mel_spectrogram(16000, 320, 160, 320, 80, 80.0, 7600.0)
    feat = fn(audio)
    out = np.asarray(features.delta_accelerate(feat))
    assert out.shape == (feat.shape[0], 80, 3)
    np.testing.assert_allclose(out[..., 0], np.asarray(feat)[..., 0], rtol=1e-6)
    base = np.asarray(feat)[..., 0]
    delta = base - np.concatenate([np.zeros_like(base[:1]), base[:-1]], axis=0)
    np.testing.assert_allclose(out[..., 1], delta, rtol=1e-5, atol=1e-6)


def test_feature_fn_with_text_passthrough(audio):
    fn = features.make_spectrogram(320, 160, 320)
    tokens = np.array([1, 2, 3], np.int32)
    feat, text = fn(audio, tokens)
    assert text is tokens and feat.shape[1] == 161
