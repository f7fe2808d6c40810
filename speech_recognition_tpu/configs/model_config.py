"""Polymorphic model configuration registry.

YAML schema is identical to the reference's ModelConfig family
(reference: speech_recognition/configs/model_config.py:10-125): the
``model_name`` key dispatches to LASConfig / DeepSpeechConfig, and
``create_model()`` instantiates the corresponding model definition.
"""

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import List

from .data_config import ConfigValidationError, _check_literal, _check_type
from ..utils.yaml import load_yaml

_RNN_TYPES = ("rnn", "lstm", "gru")


class ModelConfig(ABC):
    @abstractmethod
    def create_model(self):
        """Instantiate the model definition for this config."""

    @property
    @abstractmethod
    def model_name(self) -> str:
        ...


def get_model_config(model_config_path: str):
    """Load a model config yaml and return the matching ModelConfig instance.

    Dispatch mirrors reference model_config.py:20-36: ``ds2``/``deepspeech2``
    -> DeepSpeechConfig, ``las`` -> LASConfig.
    """
    from ..utils.io import open_file

    with open_file(model_config_path) as f:
        model_config_dict = load_yaml(f)

    model_name = model_config_dict["model_name"].lower()
    if model_name in ("ds2", "deepspeech2"):
        return DeepSpeechConfig(**model_config_dict)
    if model_name == "las":
        return LASConfig(**model_config_dict)
    if model_name == "conformer":
        return ConformerConfig(**model_config_dict)
    if model_name in ("transducer", "rnnt", "rnn-t"):
        return TransducerConfig(**model_config_dict)
    raise ConfigValidationError(f"Model Name: {model_name} is invalid!")


@dataclass
class LASConfig(ModelConfig):
    """Config for the LAS model (reference model_config.py:39-76)."""

    # RNN Type: one of ['rnn', 'lstm', 'gru']
    rnn_type: str
    # Vocab Size
    vocab_size: int
    # Encoder Hidden Dimension
    encoder_hidden_dim: int
    # Decoder Hidden Dimension
    decoder_hidden_dim: int
    # Encoder Layers
    num_encoder_layers: int
    # Decoder Layers
    num_decoder_layers: int
    # Dropout Rate
    dropout: float
    # Teacher forcing rate
    teacher_forcing_rate: float
    # Pad Token ID
    pad_id: int

    model_name: str = "LAS"

    def __post_init__(self):
        _check_literal("rnn_type", self.rnn_type, _RNN_TYPES)
        _check_type(
            self,
            "vocab_size",
            "encoder_hidden_dim",
            "decoder_hidden_dim",
            "num_encoder_layers",
            "num_decoder_layers",
            "dropout",
            "teacher_forcing_rate",
            "pad_id",
        )

    def create_model(self):
        from ..models import LAS

        return LAS(
            rnn_type=self.rnn_type,
            vocab_size=self.vocab_size,
            encoder_hidden_dim=self.encoder_hidden_dim,
            decoder_hidden_dim=self.decoder_hidden_dim,
            num_encoder_layers=self.num_encoder_layers,
            num_decoder_layers=self.num_decoder_layers,
            dropout=self.dropout,
            teacher_forcing_rate=self.teacher_forcing_rate,
            pad_id=self.pad_id,
        )


@dataclass
class ConformerConfig(ModelConfig):
    """Config for the Conformer-CTC model (beyond reference parity — the
    reference registry stops at LAS/DS2, model_config.py:20-36).  Shares the
    DS2 CTC contract: ``blank_index``/``pad_index`` drive the loss and the
    on-device CTC decoders."""

    # size of vocabulary
    vocab_size: int
    # encoder width (model dim of every block; a multiple of 128 tiles matmuls evenly)
    encoder_dim: int
    # number of conformer blocks
    num_layers: int
    # attention heads (head dim = encoder_dim / heads must be even for RoPE)
    num_attention_heads: int
    # depthwise conv kernel width inside each block
    conv_kernel_size: int
    # feed-forward expansion factor
    ffn_expansion: int
    # dropout rate
    dropout: float
    # channels of the stride-2 conv subsampling stem (one entry per 2x layer)
    subsample_channels: List[int]
    # the index of the CTC blank token
    blank_index: int
    # the index of the pad token
    pad_index: int
    # rematerialize block activations in the backward pass (memory for FLOPs)
    remat: bool = False
    # fold the identical blocks into one lax.scan (compile time / program
    # size ~num_layers-x smaller; param tree gains a leading layer axis)
    scan_layers: bool = False

    model_name: str = "Conformer"

    def __post_init__(self):
        _check_type(
            self,
            "vocab_size",
            "encoder_dim",
            "num_layers",
            "num_attention_heads",
            "conv_kernel_size",
            "ffn_expansion",
            "dropout",
            "blank_index",
            "pad_index",
            "remat",
            "scan_layers",
        )
        if self.encoder_dim % self.num_attention_heads:
            raise ConfigValidationError("'encoder_dim' must divide by 'num_attention_heads'")
        if (self.encoder_dim // self.num_attention_heads) % 2:
            raise ConfigValidationError("attention head dim must be even (RoPE pairs)")
        if not self.subsample_channels:
            raise ConfigValidationError("'subsample_channels' must be non-empty")

    def create_model(self):
        from ..models import Conformer

        return Conformer(
            vocab_size=self.vocab_size,
            encoder_dim=self.encoder_dim,
            num_layers=self.num_layers,
            num_attention_heads=self.num_attention_heads,
            conv_kernel_size=self.conv_kernel_size,
            ffn_expansion=self.ffn_expansion,
            dropout=self.dropout,
            subsample_channels=tuple(self.subsample_channels),
            blank_index=self.blank_index,
            pad_index=self.pad_index,
            remat=self.remat,
            scan_layers=self.scan_layers,
        )


@dataclass
class TransducerConfig(ModelConfig):
    """Config for the RNN-Transducer model (beyond reference parity).

    Conformer encoder + LSTM prediction network + additive joint; the
    training objective is the streamed RNN-T lattice loss
    (ops/transducer.py).  ``blank_index`` is the transducer blank;
    ``pad_index`` pads token batches (the two may coincide at 0)."""

    # size of vocabulary
    vocab_size: int
    # encoder width (model dim of every conformer block)
    encoder_dim: int
    # number of conformer blocks in the encoder
    num_encoder_layers: int
    # attention heads (head dim = encoder_dim / heads must be even for RoPE)
    num_attention_heads: int
    # depthwise conv kernel width inside each block
    conv_kernel_size: int
    # feed-forward expansion factor
    ffn_expansion: int
    # channels of the stride-2 conv subsampling stem
    subsample_channels: List[int]
    # prediction-net LSTM width (and embedding dim)
    pred_dim: int
    # prediction-net LSTM layers
    num_pred_layers: int
    # joint-network width (additive combine -> tanh -> vocab)
    joint_dim: int
    # dropout rate
    dropout: float
    # the index of the transducer blank token
    blank_index: int
    # the index of the pad token
    pad_index: int
    # rematerialize encoder block activations in the backward pass
    remat: bool = False
    # pruned (banded) lattice: evaluate the joint only on a band of this
    # many label slots per encoder frame (k2-style pruned RNN-T;
    # ops/transducer_pruned.py).  0 = exact dense lattice.  8 cuts the
    # joint FLOPs 8x at libri shapes with the terminal/start nodes always
    # in band; rows whose labels outnumber what the band can carry are
    # pruned to +inf and excluded from the batch loss.
    pruned_range: int = 0

    model_name: str = "Transducer"

    def __post_init__(self):
        _check_type(
            self,
            "vocab_size",
            "encoder_dim",
            "num_encoder_layers",
            "num_attention_heads",
            "conv_kernel_size",
            "ffn_expansion",
            "pred_dim",
            "num_pred_layers",
            "joint_dim",
            "dropout",
            "blank_index",
            "pad_index",
            "remat",
            "pruned_range",
        )
        if self.pruned_range < 0:
            raise ConfigValidationError("'pruned_range' must be >= 0 (0 = dense)")
        if self.encoder_dim % self.num_attention_heads:
            raise ConfigValidationError("'encoder_dim' must divide by 'num_attention_heads'")
        if (self.encoder_dim // self.num_attention_heads) % 2:
            raise ConfigValidationError("attention head dim must be even (RoPE pairs)")
        if not self.subsample_channels:
            raise ConfigValidationError("'subsample_channels' must be non-empty")

    def create_model(self):
        from ..models import Transducer

        return Transducer(
            vocab_size=self.vocab_size,
            encoder_dim=self.encoder_dim,
            num_encoder_layers=self.num_encoder_layers,
            num_attention_heads=self.num_attention_heads,
            conv_kernel_size=self.conv_kernel_size,
            ffn_expansion=self.ffn_expansion,
            subsample_channels=tuple(self.subsample_channels),
            pred_dim=self.pred_dim,
            num_pred_layers=self.num_pred_layers,
            joint_dim=self.joint_dim,
            dropout=self.dropout,
            blank_index=self.blank_index,
            pad_index=self.pad_index,
            remat=self.remat,
            pruned_range=self.pruned_range,
        )


@dataclass
class DeepSpeechConfig(ModelConfig):
    """Config for the DeepSpeech2 model (reference model_config.py:79-125)."""

    # number of convolution layers
    num_conv_layers: int
    # number of channels for each layer
    channels: List[int]
    # filter size for each layer
    kernel_sizes: List[List[int]]
    # stride for each layer
    strides: List[List[int]]
    # type of rnn, one of ['rnn', 'lstm', 'gru']
    rnn_type: str
    # number of recurrent layers
    num_reccurent_layers: int
    # hidden dimension size of rnn
    hidden_dim: int
    # dropout rate
    dropout: float
    # recurrent dropout rate
    recurrent_dropout: float
    # size of vocabulary
    vocab_size: int
    # the index of the CTC blank token
    blank_index: int
    # the index of the pad token
    pad_index: int
    # beyond parity: number of Switch-routed MoE experts per recurrent layer
    # (0 = the reference's dense trunk; reference deepspeech2.py:81-119)
    moe_experts: int = 0
    # expert FFN hidden width (0 = 4x the trunk width)
    moe_hidden_dim: int = 0
    # experts per token (top-k routing)
    moe_k: int = 1
    # per-expert buffer headroom over the even-load token share
    moe_capacity_factor: float = 1.25
    # weight of the load-balancing auxiliary loss
    moe_aux_weight: float = 0.01

    model_name: str = "DeepSpeech2"

    def __post_init__(self):
        _check_literal("rnn_type", self.rnn_type, _RNN_TYPES)
        _check_type(
            self,
            "num_conv_layers",
            "num_reccurent_layers",
            "hidden_dim",
            "dropout",
            "recurrent_dropout",
            "vocab_size",
            "blank_index",
            "pad_index",
            "moe_experts",
            "moe_hidden_dim",
            "moe_k",
            "moe_capacity_factor",
            "moe_aux_weight",
        )
        if self.moe_experts and self.moe_k not in (1, 2):
            raise ConfigValidationError("'moe_k' must be 1 or 2")
        if not (
            self.num_conv_layers == len(self.channels) == len(self.kernel_sizes) == len(self.strides)
        ):
            raise ConfigValidationError("Convolution parameter number is invalid!")

    def create_model(self):
        from ..models import DeepSpeech2

        return DeepSpeech2(
            num_conv_layers=self.num_conv_layers,
            channels=tuple(self.channels),
            kernel_sizes=tuple(tuple(k) for k in self.kernel_sizes),
            strides=tuple(tuple(s) for s in self.strides),
            rnn_type=self.rnn_type,
            num_reccurent_layers=self.num_reccurent_layers,
            hidden_dim=self.hidden_dim,
            dropout=self.dropout,
            recurrent_dropout=self.recurrent_dropout,
            vocab_size=self.vocab_size,
            blank_index=self.blank_index,
            pad_index=self.pad_index,
            moe_experts=self.moe_experts,
            moe_hidden_dim=self.moe_hidden_dim,
            moe_k=self.moe_k,
            moe_capacity_factor=self.moe_capacity_factor,
            moe_aux_weight=self.moe_aux_weight,
        )
