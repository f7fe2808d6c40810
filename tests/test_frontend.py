"""Fused on-device batch frontend must match the host per-example pipeline.

Coverage spans every shipped feature type (the frontend is the DEFAULT path
for GPU tsv runs, configs/train_config.py): log-mel (libri), MFCC (kspon),
and raw spectrogram, plus SpecAugment-enabled masking semantics."""

import dataclasses

import numpy as np
import pytest

from speech_recognition_tpu.configs import DataConfig
from speech_recognition_tpu.ops.features import delta_accelerate
from speech_recognition_tpu.ops.frontend import make_batch_frontend, pad_audio_batch

from .const import DEFAULT_KSPON_CONFIG, DEFAULT_LIBRI_CONFIG


@pytest.fixture(scope="module")
def config():
    cfg = DataConfig.from_yaml(DEFAULT_LIBRI_CONFIG)
    return cfg


def _config_variants():
    libri = DataConfig.from_yaml(DEFAULT_LIBRI_CONFIG)
    kspon = DataConfig.from_yaml(DEFAULT_KSPON_CONFIG)  # mfcc + delta
    spec = dataclasses.replace(libri, audio_feature_type="spectrogram")
    return [
        pytest.param(libri, id="log-mel"),
        pytest.param(kspon, id="mfcc"),
        pytest.param(spec, id="spectrogram"),
    ]


@pytest.mark.parametrize("cfg", _config_variants())
def test_batch_frontend_matches_host_path(cfg):
    rng = np.random.default_rng(0)
    audios = [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (8000, 5000, 6500)]
    max_samples = 8000

    batch, lengths = pad_audio_batch(audios, max_samples)
    frontend = make_batch_frontend(cfg)
    feats, frame_lengths = frontend(batch, lengths)
    feats = np.asarray(feats)

    host_fn = cfg.make_audio_feature_fn("numpy")
    for i, audio in enumerate(audios):
        host = host_fn(audio)
        if cfg.use_delta_accelerate:
            host = delta_accelerate(host)
        n = host.shape[0]
        assert int(frame_lengths[i]) == n
        np.testing.assert_allclose(feats[i, :n], host, rtol=2e-3, atol=2e-3)
        # padding region must be exactly zero (models detect pads by zeros)
        assert (feats[i, n:] == 0.0).all()


def test_batch_frontend_spec_augment_masks():
    """SpecAugment-enabled frontend: shape preserved, pads stay exactly
    zero (time masks zero interior frames, which is why true frame lengths
    are returned), and the augmentation actually changes the features."""
    import jax

    cfg = DataConfig.from_yaml(DEFAULT_KSPON_CONFIG)
    sa = dataclasses.replace(cfg.spec_augment, enable=True, W=None, T=10, m_T=2, F=8, m_F=1)
    cfg = dataclasses.replace(cfg, spec_augment=sa)

    rng = np.random.default_rng(1)
    audios = [rng.standard_normal(n).astype(np.float32) * 0.3 for n in (8000, 6500)]
    batch, lengths = pad_audio_batch(audios, 8000)
    frontend = make_batch_frontend(cfg, spec_augment=True)
    plain, frame_lengths = frontend(batch, lengths)
    masked, frame_lengths2 = frontend(batch, lengths, key=jax.random.PRNGKey(3))
    plain, masked = np.asarray(plain), np.asarray(masked)

    assert masked.shape == plain.shape
    np.testing.assert_array_equal(np.asarray(frame_lengths), np.asarray(frame_lengths2))
    assert (masked != plain).any()
    for i in range(len(audios)):
        n = int(frame_lengths[i])
        assert (masked[i, n:] == 0.0).all()


def test_batch_frontend_shapes(config):
    frontend = make_batch_frontend(config)
    batch = np.zeros((2, 16000), np.float32)
    lengths = np.array([16000, 8000], np.int32)
    feats, frame_lengths = frontend(batch, lengths)
    feats = np.asarray(feats)
    expected_T = (16000 - config.frame_length) // config.frame_step + 1
    assert feats.shape == (2, expected_T, config.frequency_dim, config.feature_dim)
    assert int(frame_lengths[0]) == expected_T
    assert int(frame_lengths[1]) == (8000 - config.frame_length) // config.frame_step + 1
