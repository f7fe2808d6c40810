"""Device policy (speech_recognition_tpu/backend.py) and the rules keyed on it."""

import os
import subprocess
import sys

import jax
import pytest

from speech_recognition_tpu import backend
from speech_recognition_tpu.configs import DataConfig
from speech_recognition_tpu.run.common import decode_pad_lengths
from tests.const import DEFAULT_LIBRI_CONFIG, REPO_ROOT, TEST_LAS_CONFIG, WAV_DATASET_PATH, SP_MODEL_LIBRI


def _python(code, **env):
    full = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    full.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT, **env)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=full, capture_output=True, text=True,
                          timeout=300)


def test_gpu_request_without_a_card_raises():
    proc = _python("from speech_recognition_tpu.backend import select_device; select_device('GPU')")
    assert proc.returncode != 0
    assert "JAX finds no GPU" in proc.stderr


def test_cpu_request_pins_the_cpu():
    backend.select_device("CPU")
    assert jax.devices()[0].platform == "cpu"
    assert not backend.on_accelerator()


def test_unknown_device_is_rejected():
    with pytest.raises(ValueError):
        backend.select_device("XPU")


def test_on_accelerator_names_the_gpu():
    assert backend.on_accelerator("GPU") and backend.on_accelerator("gpu")
    assert not backend.on_accelerator("CPU")
    assert backend.DEVICES == ("CPU", "GPU")


def test_compile_cache_dir_comes_from_the_environment():
    proc = _python(
        "import jax; from speech_recognition_tpu.backend import setup_compile_cache;"
        "print(setup_compile_cache()); print(jax.config.jax_compilation_cache_dir)",
        JAX_COMPILATION_CACHE_DIR="/some/shared/cache",
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["/some/shared/cache", "/some/shared/cache"]


def test_compile_cache_dir_defaults_to_a_fixed_path_in_the_checkout():
    proc = _python(
        "import jax; from speech_recognition_tpu.backend import setup_compile_cache;"
        "print(setup_compile_cache()); print(jax.config.jax_compilation_cache_dir)"
    )
    assert proc.returncode == 0, proc.stderr
    expected = os.path.join(REPO_ROOT, ".jax_cache")
    assert proc.stdout.split() == [expected, expected]
    assert backend.DEFAULT_CACHE_DIR == expected


def test_decode_cli_static_padding_on_the_gpu_only():
    cfg = DataConfig.from_yaml(DEFAULT_LIBRI_CONFIG)
    assert decode_pad_lengths(cfg, "GPU") == (cfg.max_audio_length, cfg.max_token_length)
    assert decode_pad_lengths(cfg, "CPU") == (None, None)


@pytest.mark.parametrize("cli", ["evaluate", "inference"])
def test_decode_cli_with_gpu_and_no_card_exits_nonzero(cli, tmp_path):
    args = [
        "--data-config", DEFAULT_LIBRI_CONFIG, "--model-config", TEST_LAS_CONFIG, "--sp-model-path", SP_MODEL_LIBRI,
        "--model-path", str(tmp_path / "missing"), "--device", "GPU",
    ]
    args += ["--dataset-paths", WAV_DATASET_PATH] if cli == "evaluate" else ["--audio-files", WAV_DATASET_PATH]
    proc = subprocess.run([sys.executable, "-m", f"speech_recognition_tpu.run.{cli}", *args], cwd=REPO_ROOT,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "JAX finds no GPU" in proc.stderr
