"""Abstract contract for ASR model families.

Counterpart of the reference's ModelProto (reference:
speech_recognition/models/model_proto.py:7-54).  Models are pure-functional
modules (``speech_recognition_tpu.nn``); the contract adds the host-side
plumbing the framework needs: loss/metric factories, padded-batch shapes,
example construction, and checkpoint naming.
"""

from abc import abstractmethod
from typing import Callable, List, Optional, Tuple

import jax.numpy as jnp

from .. import nn


class ModelProto(nn.Module):
    """Prototype structure of ASR models."""

    @abstractmethod
    def __call__(self, inputs, training: bool = False):
        """Forward pass producing logits."""

    def get_loss_fn(self) -> Callable:
        """Return fn(y_true, logits) -> scalar loss."""
        raise NotImplementedError

    def get_metrics(self) -> List[Tuple[str, Callable]]:
        """Return [(name, fn(y_true, logits) -> (sum, count))] streaming metrics."""
        return []

    @staticmethod
    def get_batching_shape(
        audio_pad_length: Optional[int],
        token_pad_length: Optional[int],
        frequency_dim: int,
        feature_dim: int,
    ):
        """Shapes for padded batching: (model_input_shapes, y_true_shape)."""
        raise NotImplementedError

    @staticmethod
    def make_example(audio, tokens):
        """Build (MODEL_INPUT, Y_TRUE) from one (audio, tokens) pair (host-side)."""
        raise NotImplementedError

    @property
    def model_checkpoint_name(self) -> str:
        """Checkpoint directory name template (epoch/val metrics substituted)."""
        raise NotImplementedError
