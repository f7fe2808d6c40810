"""Config-layer tests mirroring the reference's tests/configs suite."""

import dataclasses

import pytest
import yaml

from speech_recognition_tpu.configs import (
    ConfigValidationError,
    DataConfig,
    DeepSpeechConfig,
    LASConfig,
    TrainConfig,
    get_model_config,
)

from ..const import DEFAULT_DS_CONFIG, DEFAULT_LAS_CONFIG, DEFAULT_LIBRI_CONFIG


def test_data_config_roundtrip():
    cfg = DataConfig.from_yaml(DEFAULT_LIBRI_CONFIG)
    with open(DEFAULT_LIBRI_CONFIG) as f:
        raw = yaml.safe_load(f)
    assert cfg.asdict() == raw
    assert cfg.feature_dim == 3
    assert cfg.frequency_dim == 80


def test_data_config_feature_dims():
    with open(DEFAULT_LIBRI_CONFIG) as f:
        raw = yaml.safe_load(f)
    raw["audio_feature_type"] = "spectrogram"
    raw["use_delta_accelerate"] = False
    cfg = DataConfig(**raw)
    assert cfg.feature_dim == 1
    assert cfg.frequency_dim == raw["fft_length"] // 2 + 1
    raw["audio_feature_type"] = "mfcc"
    assert DataConfig(**raw).frequency_dim == raw["num_mfcc"]


def test_data_config_validation_errors():
    with open(DEFAULT_LIBRI_CONFIG) as f:
        raw = yaml.safe_load(f)
    bad = dict(raw, file_format="ogg")
    with pytest.raises(ConfigValidationError):
        DataConfig(**bad)
    bad = dict(raw, audio_feature_type="plp")
    with pytest.raises(ConfigValidationError):
        DataConfig(**bad)
    bad = dict(raw, num_mel_bins=None)
    with pytest.raises(ConfigValidationError):
        DataConfig(**bad)
    with pytest.raises(FileNotFoundError):
        DataConfig.from_yaml("nonexistent_config.yml")


def test_model_config_dispatch():
    las = get_model_config(DEFAULT_LAS_CONFIG)
    assert isinstance(las, LASConfig)
    assert las.model_name.lower() == "las"
    ds = get_model_config(DEFAULT_DS_CONFIG)
    assert isinstance(ds, DeepSpeechConfig)
    assert ds.num_conv_layers == len(ds.channels) == 3


def test_model_config_validation():
    with open(DEFAULT_DS_CONFIG) as f:
        raw = yaml.safe_load(f)
    raw["channels"] = [32]
    with pytest.raises(ConfigValidationError):
        DeepSpeechConfig(**raw)
    with open(DEFAULT_LAS_CONFIG) as f:
        raw = yaml.safe_load(f)
    raw["rnn_type"] = "transformer"
    with pytest.raises(ConfigValidationError):
        LASConfig(**raw)


def _train_kwargs(**overrides):
    kwargs = dict(
        data_config=DEFAULT_LIBRI_CONFIG,
        model_config=DEFAULT_LAS_CONFIG,
        train_dataset_paths="x.tsv",
        dev_dataset_paths="y.tsv",
        train_dataset_size=1000,
        epochs=10,
        learning_rate=1e-4,
        batch_size=32,
        dev_batch_size=16,
    )
    kwargs.update(overrides)
    return kwargs


def test_train_config_derived():
    cfg = TrainConfig(**_train_kwargs())
    assert cfg.total_steps == (1000 // 32 + 1) * 10
    assert cfg.offset_steps == 0
    cfg2 = TrainConfig(**_train_kwargs(steps_per_epoch=100, skip_epochs=3))
    assert cfg2.total_steps == 1000
    assert cfg2.offset_steps == 300
    assert cfg.audio_pad_length == cfg.data_config.max_audio_length
    assert cfg.token_pad_length == cfg.data_config.max_token_length


def test_train_config_missing_required():
    with pytest.raises(ConfigValidationError):
        TrainConfig(data_config=DEFAULT_LIBRI_CONFIG, model_config=DEFAULT_LAS_CONFIG)


def test_train_config_bad_policy():
    with pytest.raises(ConfigValidationError):
        TrainConfig(**_train_kwargs(max_over_policy="drop"))
    with pytest.raises(ConfigValidationError):
        TrainConfig(**_train_kwargs(device="QPU"))


def test_decode_cli_frontend_auto():
    """Decode CLIs resolve the same tri-state as TrainConfig: None = auto
    (GPU tsv only); explicit flag wins; never for tfrecord."""
    from speech_recognition_tpu.run.common import use_raw_frontend

    assert use_raw_frontend(None, "GPU", False) is True
    assert use_raw_frontend(None, "CPU", False) is False
    assert use_raw_frontend(None, "GPU", True) is False
    assert use_raw_frontend(False, "GPU", False) is False
    assert use_raw_frontend(True, "CPU", False) is True
    assert use_raw_frontend(True, "GPU", True) is False


def test_train_config_on_device_frontend_auto():
    """None = auto: ON only for GPU tsv runs; explicit values always win
    (accelerator default, configs/train_config.py)."""
    assert TrainConfig(**_train_kwargs()).on_device_frontend is False  # CPU
    assert (
        TrainConfig(**_train_kwargs(device="GPU", max_over_policy="slice")).on_device_frontend
        is True
    )
    assert (
        TrainConfig(
            **_train_kwargs(device="GPU", max_over_policy="slice", use_tfrecord=True)
        ).on_device_frontend
        is False
    )
    assert (
        TrainConfig(
            **_train_kwargs(device="GPU", max_over_policy="slice", on_device_frontend=False)
        ).on_device_frontend
        is False
    )
    assert TrainConfig(**_train_kwargs(on_device_frontend=True)).on_device_frontend is True


def test_train_config_frontend_auto_off_under_time_warp(tmp_path):
    """Auto keeps the frontend OFF when SpecAugment time warp is enabled
    (the warp gather stays on the host); explicit True still forces it."""
    import yaml

    base = _train_kwargs(device="GPU", max_over_policy="slice")
    with open(base["data_config"]) as f:
        data = yaml.safe_load(f)
    data["spec_augment"]["enable"] = True
    data["spec_augment"]["W"] = 40
    warp_cfg = tmp_path / "warp_data_config.yml"
    warp_cfg.write_text(yaml.safe_dump(data))
    base["data_config"] = str(warp_cfg)
    assert TrainConfig(**base).on_device_frontend is False
    assert TrainConfig(**{**base, "on_device_frontend": True}).on_device_frontend is True
    # masks-only SpecAugment keeps the auto-on default
    data["spec_augment"]["W"] = None
    masks_cfg = tmp_path / "masks_data_config.yml"
    masks_cfg.write_text(yaml.safe_dump(data))
    assert TrainConfig(**{**base, "data_config": str(masks_cfg)}).on_device_frontend is True
