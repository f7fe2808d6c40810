"""Data processing configuration.

YAML schema is identical to the reference's DataConfig
(reference: speech_recognition/configs/data_config.py:10-106) so the shipped
``resources/configs/*.yml`` dataset configs load unchanged.  Implemented with
stdlib dataclasses + explicit validation (instead of pydantic) to keep the
config layer dependency-free and to sidestep pydantic v2 reserved names.
"""

from dataclasses import dataclass, field, fields
from typing import Optional

from ..utils.yaml import load_yaml


_FILE_FORMATS = ("pcm", "wav", "flac", "mp3")
_FEATURE_TYPES = ("spectrogram", "log-mel-spectrogram", "mfcc")


class ConfigValidationError(ValueError):
    """Raised when a config file contains invalid values."""


def _check_literal(name, value, allowed):
    if value not in allowed:
        raise ConfigValidationError(f"{name}={value!r} is invalid. expected one of {allowed}")


def _check_type(obj, *names):
    for f in fields(obj):
        if f.name not in names:
            continue
        value = getattr(obj, f.name)
        if value is None:
            continue
        expect = {"int": int, "float": (int, float), "str": str, "bool": bool}
        for key, types in expect.items():
            if key in str(f.type) and not isinstance(value, types):
                raise ConfigValidationError(f"{f.name}={value!r} must be of type {key}")


@dataclass
class SpecAugmentConfig:
    """Parameters for SpecAugment (paper naming; reference data_config.py:10-20)."""

    enable: bool
    W: Optional[int] = None
    F: Optional[int] = None
    m_F: Optional[int] = None
    T: Optional[int] = None
    p: Optional[float] = None
    m_T: Optional[int] = None

    def __post_init__(self):
        _check_type(self, "enable", "W", "F", "m_F", "T", "p", "m_T")


@dataclass
class DataConfig:
    """Config for audio data processing and data-dependent parameters.

    Mirrors reference speech_recognition/configs/data_config.py:26-106.
    """

    # File Format
    file_format: str
    # Audio Feature Type
    audio_feature_type: str
    # Audio Sample rate
    sample_rate: int
    # Frame Length for STFT
    frame_length: int
    # Frame Step for STFT
    frame_step: int
    # FFT Length for STFT
    fft_length: int
    # Max audio feature sequence length
    max_audio_length: int
    # Max token sequence length
    max_token_length: int
    # Use delta and delta-accelerate channels
    use_delta_accelerate: bool
    # SpecAugment parameters
    spec_augment: SpecAugmentConfig
    # Number of mel bins for mel-spectrogram
    num_mel_bins: Optional[int] = None
    # Number of mfcc features
    num_mfcc: Optional[int] = None
    # Lowest frequency for mel-spectrogram
    lower_edge_hertz: Optional[float] = None
    # Highest frequency for mel-spectrogram
    upper_edge_hertz: Optional[float] = None

    def __post_init__(self):
        if isinstance(self.spec_augment, dict):
            self.spec_augment = SpecAugmentConfig(**self.spec_augment)
        _check_literal("file_format", self.file_format, _FILE_FORMATS)
        _check_literal("audio_feature_type", self.audio_feature_type, _FEATURE_TYPES)
        _check_type(
            self,
            "sample_rate",
            "frame_length",
            "frame_step",
            "fft_length",
            "max_audio_length",
            "max_token_length",
            "use_delta_accelerate",
            "num_mel_bins",
            "num_mfcc",
            "lower_edge_hertz",
            "upper_edge_hertz",
        )
        if self.audio_feature_type in ("log-mel-spectrogram", "mfcc"):
            if not all([self.num_mel_bins, self.lower_edge_hertz, self.upper_edge_hertz]):
                raise ConfigValidationError(
                    '"num_mel_bins", "lower_edge_hertz", "upper_edge_hertz" is required'
                )
        if self.audio_feature_type == "mfcc" and not self.num_mfcc:
            raise ConfigValidationError('"num_mfcc" is required')

    @property
    def feature_dim(self) -> int:
        return 3 if self.use_delta_accelerate else 1

    @property
    def frequency_dim(self) -> int:
        if self.audio_feature_type == "spectrogram":
            return self.fft_length // 2 + 1
        if self.audio_feature_type == "log-mel-spectrogram":
            return self.num_mel_bins
        return self.num_mfcc

    def make_audio_feature_fn(self, backend: str = "jax"):
        """``fn(audio_1d) -> [NumFrame, FrequencyDim, 1]`` feature fn.

        backend="jax": jit-compatible, for the fused on-device frontend.
        backend="numpy": host per-example path (no XLA recompilation per length).
        """
        from ..ops import features

        import jax.numpy as jnp
        import numpy as np

        xp = jnp if backend == "jax" else np
        if self.audio_feature_type == "spectrogram":
            return features.make_spectrogram(self.frame_length, self.frame_step, self.fft_length, xp=xp)
        if self.audio_feature_type == "log-mel-spectrogram":
            return features.make_log_mel_spectrogram(
                self.sample_rate,
                self.frame_length,
                self.frame_step,
                self.fft_length,
                self.num_mel_bins,
                self.lower_edge_hertz,
                self.upper_edge_hertz,
                xp=xp,
            )
        return features.make_mfcc(
            self.sample_rate,
            self.frame_length,
            self.frame_step,
            self.fft_length,
            self.num_mel_bins,
            self.num_mfcc,
            self.lower_edge_hertz,
            self.upper_edge_hertz,
            xp=xp,
        )

    @property
    def audio_feature_fn(self):
        return self.make_audio_feature_fn("jax")

    @property
    def audio_feature_fn_numpy(self):
        return self.make_audio_feature_fn("numpy")

    def asdict(self) -> dict:
        from dataclasses import asdict

        return asdict(self)

    @classmethod
    def from_yaml(cls, file_path: str) -> "DataConfig":
        from ..utils.io import open_file

        with open_file(file_path) as f:
            return cls(**load_yaml(f))
