"""Tests that need an NVIDIA GPU (marker ``gpu``; they skip elsewhere).

Run on a machine with a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu.py

chip_smoke.py runs them.  Each compares the GPU with the plain reference,
the same program on the CPU backend of the same process, in float32 at
precision "highest".
"""

import jax
import numpy as np
import optax
import pytest

from speech_recognition_tpu.models import LAS
from speech_recognition_tpu.search import LASSearcher
from speech_recognition_tpu.train import TrainState, make_train_step

pytestmark = pytest.mark.gpu


def _mini_las():
    model = LAS("lstm", 64, 32, 32, 2, 2, 0.1, 1.0)
    key = jax.random.PRNGKey(0)
    audio = np.array(jax.random.normal(key, (4, 40, 20, 3)))
    audio[1, 30:] = 0.0
    tokens = np.array(jax.random.randint(key, (4, 9), 1, 64), np.int32)
    tokens[2, 6:] = 0
    variables = model.init({"params": key}, (audio, tokens[:, :-1]))
    # host copies: every run places its own device buffers (the train step
    # donates the state it is given)
    return model, jax.tree_util.tree_map(np.array, variables), audio, tokens


def _on(device, fn):
    with jax.default_device(device), jax.default_matmul_precision("highest"):
        return jax.tree_util.tree_map(np.asarray, fn())


def test_select_device_finds_the_gpu(gpu_device):
    from speech_recognition_tpu.backend import on_accelerator, select_device

    select_device("GPU")
    assert jax.devices()[0].platform == "gpu"
    assert on_accelerator()


def test_las_train_steps_match_cpu(gpu_device):
    model, variables, audio, tokens = _mini_las()

    def run():
        state = TrainState.create(variables, optax.adam(1e-3))
        step = make_train_step(model, model.get_loss_fn(), model.get_metrics(), needs_teacher_forcing_rng=True)
        losses = []
        for i in range(2):
            state, metrics = step(state, (audio, tokens[:, :-1]), tokens[:, 1:], jax.random.PRNGKey(i))
            losses.append(metrics["loss"])
        return losses

    gpu, cpu = _on(gpu_device, run), _on(jax.devices("cpu")[0], run)
    assert np.isfinite(gpu).all()
    np.testing.assert_allclose(gpu, cpu, rtol=1e-4)


def test_decoder_custom_vjp_matches_autodiff(gpu_device, monkeypatch):
    model, variables, audio, tokens = _mini_las()

    def grads():
        def loss(p):
            logits = model.apply({**variables, "params": p}, (audio, tokens[:, :-1]))
            return model.get_loss_fn()(tokens[:, 1:], logits)

        return jax.jit(jax.grad(loss))(variables["params"])

    custom = _on(gpu_device, grads)
    monkeypatch.setenv("SRT_DECODER_CUSTOM_VJP", "0")
    plain = _on(gpu_device, grads)
    # relative to the largest gradient entry: the key projection bias has a
    # gradient that is zero up to rounding
    scale = max(np.abs(b).max() for b in jax.tree_util.tree_leaves(plain))
    for a, b in zip(jax.tree_util.tree_leaves(custom), jax.tree_util.tree_leaves(plain)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale)


def test_greedy_and_beam_decode_match_cpu(gpu_device):
    model, variables, audio, _ = _mini_las()

    def decode():
        searcher = LASSearcher(model, variables, 8, bos_id=1, eos_id=2)
        return searcher.greedy_search(audio)[0], searcher.beam_search(audio, 3)[0]

    gpu, cpu = _on(gpu_device, decode), _on(jax.devices("cpu")[0], decode)
    np.testing.assert_array_equal(gpu[0], cpu[0])
    np.testing.assert_array_equal(gpu[1], cpu[1])
