"""End-to-end CLI smoke tests on tiny fixtures (mirrors reference tests/run).

These drive the real ``main(parser.parse_args([...]))`` entry points on CPU
with a 2-example dataset and mini model configs.
"""

import os

import numpy as np
import pytest

from ..const import (
    KSPON_DATASET_PATH,
    KSPON_MINI_DATA_CONFIG,
    SP_MODEL_KSPON,
    SP_MODEL_LIBRI,
    TEST_DATA_DIR,
    TEST_DS_CONFIG,
    TEST_CONFORMER_CONFIG,
    TEST_TRANSDUCER_CONFIG,
    TEST_TRANSDUCER_PRUNED_CONFIG,
    TEST_DS_MOE_CONFIG,
    TEST_LAS_CONFIG,
    TEST_LAS_KSPON_CONFIG,
    WAV_DATASET_PATH,
)

# slow tier: excluded from the default run (pyproject addopts); run with
# `-m interferable` or `-m ""` — CLI end-to-end suites (full train/evaluate/inference runs)
pytestmark = pytest.mark.interferable

MINI_DATA_CONFIG = os.path.join(TEST_DATA_DIR, "mini_data_config.yml")


def _train_args(tmp_path, model_config, extra=()):
    return [
        "--data-config", MINI_DATA_CONFIG,
        "--model-config", model_config,
        "--sp-model-path", SP_MODEL_LIBRI,
        "--train-dataset-paths", WAV_DATASET_PATH,
        "--dev-dataset-paths", WAV_DATASET_PATH,
        "--train-dataset-size", "2",
        "--output-path", str(tmp_path / "output"),
        "--epochs", "2",
        "--steps-per-epoch", "1",
        "--learning-rate", "1e-3",
        "--batch-size", "2",
        "--dev-batch-size", "2",
        "--shuffle-buffer-size", "1",
        "--max-over-policy", "slice",
        "--device", "CPU",
        "--seed", "42",
        *extra,
    ]


@pytest.mark.parametrize("model_config", [TEST_LAS_CONFIG, TEST_DS_CONFIG])
def test_train_cli(tmp_path, model_config):
    from speech_recognition_tpu.run.train import main, parser

    from speech_recognition_tpu.configs import TrainConfig

    config = vars(parser.parse_args(_train_args(tmp_path, model_config)))
    main(TrainConfig(**config))

    out = tmp_path / "output"
    assert (out / "train_configs.txt").exists()
    # reproducibility dump includes the effective SRT_* fast-path flags
    from speech_recognition_tpu.utils.srt_flags import SRT_FLAG_DEFAULTS

    dump = (out / "train_configs.txt").read_text()
    for flag in SRT_FLAG_DEFAULTS:
        assert flag in dump, f"{flag} missing from train_configs.txt"
    assert (out / "data-config.yml").exists()
    models_dir = out / "models"
    checkpoints = list(models_dir.iterdir())
    assert len(checkpoints) == 2  # one per epoch


def test_train_cli_mixed_precision_tfrecord(tmp_path):
    # build a tfrecord from the tsv first, then train from it
    from speech_recognition_tpu.run.make_tfrecord import main as mtf_main, parser as mtf_parser
    from speech_recognition_tpu.run.train import main, parser
    from speech_recognition_tpu.configs import TrainConfig

    mtf_main(mtf_parser.parse_args([
        "--data-config", MINI_DATA_CONFIG,
        "--dataset-paths", WAV_DATASET_PATH,
        "--output-dir", str(tmp_path),
        "--sp-model-path", SP_MODEL_LIBRI,
    ]))
    tfrecord = str(tmp_path / "wav_dataset.tfrecord")
    assert os.path.exists(tfrecord)

    args = _train_args(tmp_path, TEST_DS_CONFIG, extra=["--use-tfrecord", "--mixed-precision"])
    # swap dataset paths to the tfrecord
    idx = args.index("--train-dataset-paths")
    args[idx + 1] = tfrecord
    idx = args.index("--dev-dataset-paths")
    args[idx + 1] = tfrecord
    config = vars(parser.parse_args(args))
    main(TrainConfig(**config))
    assert len(list((tmp_path / "output" / "models").iterdir())) == 2


def _make_checkpoint(tmp_path, model_config_path):
    """Save a randomly initialized weights checkpoint for decode-only CLIs."""
    import jax

    from speech_recognition_tpu.configs import DataConfig, get_model_config
    from speech_recognition_tpu.run.common import build_variables, create_model
    from speech_recognition_tpu.train import save_weights
    import jax.numpy as jnp

    data_config = DataConfig.from_yaml(MINI_DATA_CONFIG)
    model_config = get_model_config(model_config_path)
    model = create_model(model_config, jnp.float32)
    variables = build_variables(model, model_config, data_config, jax.random.PRNGKey(0))
    path = str(tmp_path / "ckpt")
    save_weights(path, dict(variables))
    return path


@pytest.mark.parametrize("model_config,beam", [(TEST_LAS_CONFIG, 0), (TEST_LAS_CONFIG, 2), (TEST_DS_CONFIG, 0), (TEST_DS_CONFIG, 2)])
def test_evaluate_cli(tmp_path, model_config, beam):
    from speech_recognition_tpu.run.evaluate import main, parser

    ckpt = _make_checkpoint(tmp_path, model_config)
    out_tsv = str(tmp_path / "eval.tsv")
    args = parser.parse_args([
        "--data-config", MINI_DATA_CONFIG,
        "--model-config", model_config,
        "--dataset-paths", WAV_DATASET_PATH,
        "--model-path", ckpt,
        "--sp-model-path", SP_MODEL_LIBRI,
        "--output-path", out_tsv,
        "--batch-size", "2",
        "--beam-size", str(beam),
        "--device", "CPU",
    ])
    main(args)
    with open(out_tsv) as f:
        lines = f.read().strip().split("\n")
    assert lines[0].startswith("Prediction\tTarget")
    assert len(lines) == 3  # header + 2 examples


@pytest.mark.parametrize("model_config", [TEST_LAS_CONFIG, TEST_DS_CONFIG])
def test_inference_cli(tmp_path, model_config):
    from speech_recognition_tpu.run.inference import main, parser

    ckpt = _make_checkpoint(tmp_path, model_config)
    out_tsv = str(tmp_path / "inference.tsv")
    args = parser.parse_args([
        "--data-config", MINI_DATA_CONFIG,
        "--model-config", model_config,
        "--audio-files", os.path.join(TEST_DATA_DIR, "audio_files", "*.wav"),
        "--model-path", ckpt,
        "--sp-model-path", SP_MODEL_LIBRI,
        "--output-path", out_tsv,
        "--batch-size", "2",
        "--device", "CPU",
    ])
    main(args)
    with open(out_tsv) as f:
        lines = f.read().strip().split("\n")
    assert lines[0] == "AudioPath\tDecodedSentence"
    assert len(lines) >= 2


@pytest.mark.parametrize(
    "model_config,beam", [(TEST_LAS_CONFIG, 0), (TEST_LAS_CONFIG, 2), (TEST_DS_CONFIG, 0)]
)
def test_evaluate_cli_on_device_frontend(tmp_path, model_config, beam):
    """Raw-PCM decode path: host only decodes+tokenizes, the fused frontend
    (ops/frontend.py) featurizes on device ahead of the searcher (the GPU
    tsv default; forced on here to drive it on CPU)."""
    from speech_recognition_tpu.run.evaluate import main, parser

    ckpt = _make_checkpoint(tmp_path, model_config)
    out_tsv = str(tmp_path / "eval_raw.tsv")
    args = parser.parse_args([
        "--data-config", MINI_DATA_CONFIG,
        "--model-config", model_config,
        "--dataset-paths", WAV_DATASET_PATH,
        "--model-path", ckpt,
        "--sp-model-path", SP_MODEL_LIBRI,
        "--output-path", out_tsv,
        "--batch-size", "2",
        "--beam-size", str(beam),
        "--device", "CPU",
        "--on-device-frontend",
    ])
    main(args)
    with open(out_tsv) as f:
        lines = f.read().strip().split("\n")
    assert lines[0].startswith("Prediction\tTarget")
    assert len(lines) == 3


def test_inference_cli_on_device_frontend(tmp_path):
    from speech_recognition_tpu.run.inference import main, parser

    ckpt = _make_checkpoint(tmp_path, TEST_LAS_CONFIG)
    out_tsv = str(tmp_path / "inference_raw.tsv")
    args = parser.parse_args([
        "--data-config", MINI_DATA_CONFIG,
        "--model-config", TEST_LAS_CONFIG,
        "--audio-files", os.path.join(TEST_DATA_DIR, "audio_files", "*.wav"),
        "--model-path", ckpt,
        "--sp-model-path", SP_MODEL_LIBRI,
        "--output-path", out_tsv,
        "--batch-size", "2",
        "--device", "CPU",
        "--on-device-frontend",
    ])
    main(args)
    with open(out_tsv) as f:
        lines = f.read().strip().split("\n")
    assert lines[0] == "AudioPath\tDecodedSentence"
    assert len(lines) >= 2


def test_make_tfrecord_roundtrip(tmp_path):
    from speech_recognition_tpu.run.make_tfrecord import main, parser
    from speech_recognition_tpu.data import get_tfrecord_dataset

    main(parser.parse_args([
        "--data-config", MINI_DATA_CONFIG,
        "--dataset-paths", WAV_DATASET_PATH,
        "--output-dir", str(tmp_path),
        "--sp-model-path", SP_MODEL_LIBRI,
    ]))
    pairs = list(get_tfrecord_dataset(str(tmp_path / "wav_dataset.tfrecord")))
    assert len(pairs) == 2
    feat, tokens = pairs[0]
    assert feat.ndim == 3 and feat.shape[1] == 40 and feat.dtype == np.float32
    assert tokens.dtype == np.int32 and tokens[0] == 2  # BOS


@pytest.mark.parametrize("model_config", [TEST_LAS_CONFIG, TEST_DS_CONFIG])
def test_train_cli_on_device_frontend(tmp_path, model_config):
    from speech_recognition_tpu.run.train import main, parser
    from speech_recognition_tpu.configs import TrainConfig

    args = _train_args(tmp_path, model_config, extra=["--on-device-frontend"])
    config = vars(parser.parse_args(args))
    main(TrainConfig(**config))
    assert len(list((tmp_path / "output" / "models").iterdir())) == 2


def test_train_cli_model_parallel(tmp_path):
    """--model-parallel 2 on the virtual 8-device mesh: vocab-dimension
    params shard over 'model', batch over the remaining 'data' devices —
    the TP path as a user-facing CLI feature, not just a dryrun special."""
    from speech_recognition_tpu.run.train import main, parser
    from speech_recognition_tpu.configs import TrainConfig

    args = _train_args(tmp_path, TEST_LAS_CONFIG, extra=["--model-parallel", "2"])
    config = vars(parser.parse_args(args))
    main(TrainConfig(**config))
    assert len(list((tmp_path / "output" / "models").iterdir())) == 2


def test_train_and_evaluate_cli_ds2_moe(tmp_path):
    """DS2-MoE (beyond parity, models/moe.py): the moe_experts config trains
    through the CLI (aux loss folded into the objective) and the resulting
    checkpoint evaluates through the decode CLI."""
    from speech_recognition_tpu.configs import TrainConfig
    from speech_recognition_tpu.run.evaluate import main as eval_main, parser as eval_parser
    from speech_recognition_tpu.run.train import main as train_main, parser as train_parser

    args = _train_args(tmp_path, TEST_DS_MOE_CONFIG)
    train_main(TrainConfig(**vars(train_parser.parse_args(args))))
    ckpts = sorted((tmp_path / "output" / "models").iterdir())
    assert len(ckpts) == 2

    out_tsv = str(tmp_path / "eval_moe.tsv")
    eval_main(eval_parser.parse_args([
        "--data-config", MINI_DATA_CONFIG,
        "--model-config", TEST_DS_MOE_CONFIG,
        "--dataset-paths", WAV_DATASET_PATH,
        "--model-path", str(ckpts[-1]),
        "--sp-model-path", SP_MODEL_LIBRI,
        "--output-path", out_tsv,
        "--batch-size", "2",
        "--device", "CPU",
    ]))
    with open(out_tsv) as f:
        lines = f.read().strip().split("\n")
    assert lines[0].startswith("Prediction\tTarget")
    assert len(lines) == 3


def test_train_and_evaluate_cli_conformer(tmp_path):
    """Conformer-CTC (beyond parity, models/conformer.py) end-to-end: train
    through the CLI, then greedy- and beam-decode the checkpoint through the
    evaluate CLI (DeepSpeechSearcher serves the whole CTC family)."""
    from speech_recognition_tpu.configs import TrainConfig
    from speech_recognition_tpu.run.evaluate import main as eval_main, parser as eval_parser
    from speech_recognition_tpu.run.train import main as train_main, parser as train_parser

    args = _train_args(tmp_path, TEST_CONFORMER_CONFIG)
    train_main(TrainConfig(**vars(train_parser.parse_args(args))))
    ckpts = sorted((tmp_path / "output" / "models").iterdir())
    assert len(ckpts) == 2

    for name, extra in [("greedy", []), ("beam", ["--beam-size", "2"])]:
        out_tsv = str(tmp_path / f"eval_conformer_{name}.tsv")
        eval_main(eval_parser.parse_args([
            "--data-config", MINI_DATA_CONFIG,
            "--model-config", TEST_CONFORMER_CONFIG,
            "--dataset-paths", WAV_DATASET_PATH,
            "--model-path", str(ckpts[-1]),
            "--sp-model-path", SP_MODEL_LIBRI,
            "--output-path", out_tsv,
            "--batch-size", "2",
            "--device", "CPU",
            *extra,
        ]))
        with open(out_tsv) as f:
            lines = f.read().strip().split("\n")
        assert lines[0].startswith("Prediction\tTarget")
        assert len(lines) == 3


def test_train_and_evaluate_cli_transducer(tmp_path):
    """RNN-Transducer (beyond parity, models/transducer.py) end-to-end:
    train through the CLI (streamed lattice loss), then greedy-decode the
    checkpoint through the evaluate CLI (TransducerSearcher)."""
    from speech_recognition_tpu.configs import TrainConfig
    from speech_recognition_tpu.run.evaluate import main as eval_main, parser as eval_parser
    from speech_recognition_tpu.run.train import main as train_main, parser as train_parser

    args = _train_args(tmp_path, TEST_TRANSDUCER_CONFIG)
    train_main(TrainConfig(**vars(train_parser.parse_args(args))))
    ckpts = sorted((tmp_path / "output" / "models").iterdir())
    assert len(ckpts) == 2

    for name, beam in (("eval_transducer.tsv", []), ("eval_transducer_beam.tsv", ["--beam-size", "2"])):
        out_tsv = str(tmp_path / name)
        eval_main(eval_parser.parse_args([
            "--data-config", MINI_DATA_CONFIG,
            "--model-config", TEST_TRANSDUCER_CONFIG,
            "--dataset-paths", WAV_DATASET_PATH,
            "--model-path", str(ckpts[-1]),
            "--sp-model-path", SP_MODEL_LIBRI,
            "--output-path", out_tsv,
            "--batch-size", "2",
            "--device", "CPU",
        ] + beam))
        with open(out_tsv) as f:
            lines = f.read().strip().split("\n")
        assert lines[0].startswith("Prediction\tTarget")
        assert len(lines) == 3


def test_train_cli_transducer_pruned(tmp_path):
    """Pruned (banded) lattice knob end-to-end: train with pruned_range set,
    then decode the checkpoint with the DENSE config — same model family,
    identical checkpoint layout (the knob only changes the training
    objective's evaluation set)."""
    from speech_recognition_tpu.configs import TrainConfig
    from speech_recognition_tpu.run.evaluate import main as eval_main, parser as eval_parser
    from speech_recognition_tpu.run.train import main as train_main, parser as train_parser

    args = _train_args(tmp_path, TEST_TRANSDUCER_PRUNED_CONFIG)
    train_main(TrainConfig(**vars(train_parser.parse_args(args))))
    ckpts = sorted((tmp_path / "output" / "models").iterdir())
    assert len(ckpts) == 2

    out_tsv = str(tmp_path / "eval_pruned_ckpt.tsv")
    eval_main(eval_parser.parse_args([
        "--data-config", MINI_DATA_CONFIG,
        "--model-config", TEST_TRANSDUCER_CONFIG,  # dense config, same ckpt
        "--dataset-paths", WAV_DATASET_PATH,
        "--model-path", str(ckpts[-1]),
        "--sp-model-path", SP_MODEL_LIBRI,
        "--output-path", out_tsv,
        "--batch-size", "2",
        "--device", "CPU",
    ]))
    with open(out_tsv) as f:
        lines = f.read().strip().split("\n")
    assert lines[0].startswith("Prediction\tTarget")
    assert len(lines) == 3


def test_train_cli_fsdp(tmp_path):
    """--fsdp on the virtual 8-device mesh: large params + optimizer state
    shard over 'data' (ZeRO-3) — CLI-reachable, not just a dryrun special.
    The mini model's leaves sit below fsdp_min_size (sharding tiny leaves
    would be a pessimization), so this pins the wiring end-to-end: flag ->
    TrainConfig -> shard_params(fsdp=True) -> finished training run."""
    from speech_recognition_tpu.run.train import main, parser
    from speech_recognition_tpu.configs import TrainConfig

    args = _train_args(tmp_path, TEST_LAS_CONFIG, extra=["--fsdp"])
    config = vars(parser.parse_args(args))
    main(TrainConfig(**config))
    assert len(list((tmp_path / "output" / "models").iterdir())) == 2


def test_train_cli_grad_accum(tmp_path):
    """--grad-accum-steps 2: optax.MultiSteps averages grads over 2 steps
    per optimizer update (effective batch 2x without 2x activation memory)."""
    from speech_recognition_tpu.run.train import main, parser
    from speech_recognition_tpu.configs import TrainConfig

    args = _train_args(tmp_path, TEST_LAS_CONFIG, extra=["--grad-accum-steps", "2"])
    # 2 accumulation steps per update, 2 steps per epoch -> 1 update/epoch
    args[args.index("--steps-per-epoch") + 1] = "2"
    config = vars(parser.parse_args(args))
    main(TrainConfig(**config))
    assert len(list((tmp_path / "output" / "models").iterdir())) == 2


def test_train_cli_bucketed(tmp_path):
    from speech_recognition_tpu.run.train import main, parser
    from speech_recognition_tpu.configs import TrainConfig

    args = _train_args(tmp_path, TEST_DS_CONFIG, extra=["--bucket-boundaries", "80,150"])
    config = vars(parser.parse_args(args))
    main(TrainConfig(**config))
    assert len(list((tmp_path / "output" / "models").iterdir())) == 2


def test_train_cli_learns(tmp_path):
    """Trainability regression: 24 optimization steps on the 2-example
    fixture must reduce val_loss substantially (guards optimizer wiring,
    custom VJPs, masks — not just 'runs without crashing')."""
    import csv
    import re

    from speech_recognition_tpu.run.train import main, parser
    from speech_recognition_tpu.configs import TrainConfig

    args = _train_args(
        tmp_path,
        TEST_LAS_CONFIG,
        extra=[
            "--epochs", "6",
            "--steps-per-epoch", "4",
            "--learning-rate", "5e-3",
            "--batch-size", "2",
        ],
    )
    main(TrainConfig(**vars(parser.parse_args(args))))
    losses = []
    for name in os.listdir(tmp_path / "output" / "models"):
        m = re.match(r"model-(\d+)epoch-([\d.]+)loss", name)
        assert m, name
        losses.append((int(m.group(1)), float(m.group(2))))
    losses = [l for _, l in sorted(losses)]
    assert len(losses) == 6
    assert losses[-1] < losses[0] - 0.8, f"val_loss did not improve: {losses}"


def test_train_cli_auto_resume(tmp_path):
    from speech_recognition_tpu.run.train import main, parser
    from speech_recognition_tpu.configs import TrainConfig

    args = _train_args(tmp_path, TEST_DS_CONFIG)
    main(TrainConfig(**vars(parser.parse_args(args))))
    first_ckpts = set(os.listdir(tmp_path / "output" / "models"))
    assert len(first_ckpts) == 2

    # resume: picks up the newest checkpoint and skips completed epochs
    args = _train_args(tmp_path, TEST_DS_CONFIG, extra=["--auto-resume", "--epochs", "3"])
    main(TrainConfig(**vars(parser.parse_args(args))))
    after = set(os.listdir(tmp_path / "output" / "models"))
    assert len(after - first_ckpts) == 1  # exactly one new epoch trained


def test_train_and_evaluate_cli_kspon(tmp_path):
    """Korean end-to-end (driver config #4 shape): pcm container + MFCC
    features + SpecAugment enabled + the shipped 8K KsponSpeech
    sentencepiece model, train 2 steps then evaluate greedy from the
    written checkpoint (reference resources/configs/kspon_config.yml)."""
    from speech_recognition_tpu.configs import TrainConfig
    from speech_recognition_tpu.run.evaluate import main as eval_main, parser as eval_parser
    from speech_recognition_tpu.run.train import main as train_main, parser as train_parser

    args = train_parser.parse_args([
        "--data-config", KSPON_MINI_DATA_CONFIG,
        "--model-config", TEST_LAS_KSPON_CONFIG,
        "--sp-model-path", SP_MODEL_KSPON,
        "--train-dataset-paths", KSPON_DATASET_PATH,
        "--dev-dataset-paths", KSPON_DATASET_PATH,
        "--train-dataset-size", "2",
        "--output-path", str(tmp_path / "output"),
        "--epochs", "1",
        "--steps-per-epoch", "2",
        "--learning-rate", "1e-3",
        "--batch-size", "2",
        "--dev-batch-size", "2",
        "--shuffle-buffer-size", "1",
        "--max-over-policy", "slice",
        "--device", "CPU",
        "--seed", "42",
    ])
    train_main(TrainConfig(**vars(args)))
    ckpts = list((tmp_path / "output" / "models").iterdir())
    assert len(ckpts) == 1

    out_tsv = str(tmp_path / "eval.tsv")
    eval_main(eval_parser.parse_args([
        "--data-config", KSPON_MINI_DATA_CONFIG,
        "--model-config", TEST_LAS_KSPON_CONFIG,
        "--dataset-paths", KSPON_DATASET_PATH,
        "--model-path", str(ckpts[0]),
        "--sp-model-path", SP_MODEL_KSPON,
        "--output-path", out_tsv,
        "--batch-size", "2",
        "--beam-size", "0",
        "--device", "CPU",
    ]))
    with open(out_tsv, encoding="utf-8") as f:
        lines = f.read().strip().split("\n")
    assert lines[0].startswith("Prediction\tTarget")
    assert len(lines) == 3  # header + 2 Korean examples
    # targets round-tripped through the kspon tokenizer stay Korean text
    assert "안녕하세요" in lines[1] + lines[2]
