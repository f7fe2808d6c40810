"""Training configuration.

YAML schema is identical to the reference's TrainConfig
(reference: speech_recognition/configs/train_config.py:14-95): ``data_config``
and ``model_config`` keys are paths to the nested configs, which are loaded
during construction.  Derived properties (``audio_pad_length`` /
``token_pad_length`` / ``total_steps`` / ``offset_steps``) mirror the
reference exactly — except that static padding is the default on every
device here, because static shapes are the XLA-native discipline (the
reference only forces them on its accelerator, train_config.py:81-87).
"""

from dataclasses import dataclass, field
from math import ceil
from typing import Optional

from ..backend import DEVICES, on_accelerator
from ..utils.yaml import load_yaml
from .data_config import ConfigValidationError, DataConfig, _check_literal, _check_type
from .model_config import get_model_config

_MISSING = object()


@dataclass
class TrainConfig:
    # nested config paths (YAML keys `data_config` / `model_config`)
    data_config: str = None
    model_config: str = None

    # sentencepiece model path
    sp_model_path: Optional[str] = None
    # a tsv/tfrecord dataset file or glob pattern
    train_dataset_paths: str = None
    # a tsv/tfrecord dataset file or glob pattern
    dev_dataset_paths: str = None
    # the number of training dataset examples
    train_dataset_size: int = None
    # output directory for logs and checkpoints
    output_path: str = "output"

    # pretrained model checkpoint
    pretrained_model_path: Optional[str] = None

    # training parameters
    epochs: int = None
    steps_per_epoch: Optional[int] = None
    learning_rate: float = None
    min_learning_rate: float = 1.0e-5
    warmup_rate: float = 0.00
    warmup_steps: Optional[int] = None
    batch_size: int = None
    dev_batch_size: int = None

    # shuffle buffer size
    shuffle_buffer_size: int = 10000
    # policy for sequences longer than the max: "filter" | "slice"
    max_over_policy: Optional[str] = None

    # use tfrecord dataset
    use_tfrecord: bool = False
    # tensorboard update frequency
    tensorboard_update_freq: int = 1
    # use mixed precision (bfloat16 compute)
    mixed_precision: bool = False
    # random seed
    seed: Optional[int] = None
    # skip first N epochs and start at epoch N + 1
    skip_epochs: int = 0
    # device to use
    device: str = "CPU"
    # capture a jax.profiler trace of N training steps into <output>/profile
    profile_steps: Optional[int] = None
    # fuse the audio feature frontend (STFT/mel/SpecAugment/delta) into the
    # on-device training step; the host pipeline only decodes + tokenizes.
    # None = auto: ON for accelerator tsv runs (batched on-device feature
    # extraction instead of per-example host numpy — the host is usually
    # the bottleneck at accelerator rates), OFF elsewhere (CPU runs and
    # TFRecord datasets, whose features are precomputed)
    on_device_frontend: Optional[bool] = None
    # comma-separated audio-length bucket boundaries for bucketed batching
    # (e.g. "512,1024,2048"); cuts pad waste vs the single max-length shape
    bucket_boundaries: Optional[str] = None
    # resume from the newest checkpoint in <output>/models automatically
    auto_resume: bool = False
    # tensor-parallel degree: vocab-dimension parameters (embedding + vocab
    # projections) shard over the mesh's 'model' axis; remaining devices form
    # the data axis.  1 = pure data parallelism (the reference's only mode)
    model_parallel: int = 1
    # accumulate gradients over N train steps before each optimizer update
    # (optax.MultiSteps): effective batch = N * batch_size without N x the
    # activation memory.  The LR schedule advances per optimizer UPDATE
    grad_accum_steps: int = 1
    # ZeRO-3-style fully-sharded data parallelism: shard every large
    # parameter and its optimizer state over the 'data' mesh axis (weights
    # all-gather at use sites, gradients reduce-scatter — XLA derives the
    # schedule from the input shardings).  Composes with model_parallel
    fsdp: bool = False
    # multi-controller bootstrap (one jax process per host — the analog of
    # the reference's distribution-strategy cluster resolver, reference
    # utils.py:130-156): when coordinator_address is set, the CLI calls
    # jax.distributed.initialize(coordinator_address, num_processes,
    # process_id) before the backend initializes, so jax.devices() spans
    # every host and the dataset stride-shards per process.  Unset (the
    # default) = single-process
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    def __post_init__(self):
        required = [
            "data_config",
            "model_config",
            "train_dataset_paths",
            "dev_dataset_paths",
            "train_dataset_size",
            "epochs",
            "learning_rate",
            "batch_size",
            "dev_batch_size",
        ]
        for name in required:
            if getattr(self, name) is None:
                raise ConfigValidationError(f"should pass '{name}' parameter")
        if not isinstance(self.data_config, str) or not isinstance(self.model_config, str):
            raise ConfigValidationError("'data_config'/'model_config' must be config file paths")
        if self.max_over_policy is not None:
            _check_literal("max_over_policy", self.max_over_policy, ("filter", "slice"))
        _check_literal("device", self.device, DEVICES)
        _check_type(
            self,
            "train_dataset_size",
            "epochs",
            "learning_rate",
            "min_learning_rate",
            "warmup_rate",
            "batch_size",
            "dev_batch_size",
            "shuffle_buffer_size",
            "tensorboard_update_freq",
            "skip_epochs",
            "model_parallel",
            "grad_accum_steps",
        )
        if self.model_parallel < 1:
            raise ConfigValidationError("'model_parallel' must be >= 1")
        if self.grad_accum_steps < 1:
            raise ConfigValidationError("'grad_accum_steps' must be >= 1")

        self.data_config_path = self.data_config
        self.model_config_path = self.model_config
        self.data_config = DataConfig.from_yaml(self.data_config_path)
        self.model_config = get_model_config(self.model_config_path)

        if self.on_device_frontend is None:
            # accelerator auto: raw PCM to the device, features fuse into
            # the jitted step; explicit True/False (CLI or YAML) always wins.
            # Exception: SpecAugment TIME WARP enabled — its bilinear warp
            # gather was far slower on device than masks-only on the machine
            # this was first tuned for, so warping stays in the host thread
            # pool where it overlaps device steps (GPU A/B queued).
            sa = self.data_config.spec_augment
            warp_on = bool(sa.enable and sa.W)
            self.on_device_frontend = (
                on_accelerator(self.device) and not self.use_tfrecord and not warp_on
            )

    @classmethod
    def from_yaml(cls, file_path: str) -> "TrainConfig":
        from ..utils.io import open_file

        with open_file(file_path) as f:
            return cls(**load_yaml(f))

    @property
    def audio_pad_length(self) -> Optional[int]:
        """Static audio pad length; always static (XLA static-shape discipline)."""
        return self.data_config.max_audio_length

    @property
    def token_pad_length(self) -> Optional[int]:
        return self.data_config.max_token_length

    @property
    def total_steps(self) -> int:
        return (self.steps_per_epoch or ceil(self.train_dataset_size / self.batch_size)) * self.epochs

    @property
    def offset_steps(self) -> int:
        return (
            self.steps_per_epoch or ceil(self.train_dataset_size / self.batch_size)
        ) * self.skip_epochs
