"""Benchmark: LAS-small training throughput and decode real-time factors on
one NVIDIA GPU.

    python bench.py

Prints one JSON line: training utterances/s at the LAS-small published
widths (resources/configs/las_small.yml: 3x256 BiLSTM listener, 2x256 LSTM
speller, V=16000) in bf16 mixed precision on a LibriSpeech-shaped synthetic
batch (B=128, 1024 frames x 80 mel x 3, 127 decoder positions), the step
time, model FLOPs per step from XLA's cost analysis and the MFU they imply
against the card's published peak, and the greedy and beam-8 real-time
factors.  Every device time is taken with ``block_until_ready``.  The card's
name and power limit are recorded beside the numbers.

Without a GPU, on a device kind missing from ``PEAKS``, or when any phase
fails, it exits non-zero.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
LAS_SMALL = os.path.join(REPO, "resources", "configs", "las_small.yml")

# device_kind -> published dense peaks (NVIDIA H100 SXM data sheet, at the
# full 700 W power limit; a card set lower cannot hold its top clock)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}

BATCH, FRAMES, TOKENS = 128, 1024, 128
STEPS, DECODE_CALLS = 8, 3


def peak(device) -> dict:
    if device.device_kind not in PEAKS:
        raise KeyError(f"no published peak for device kind {device.device_kind!r}: add it to bench.PEAKS")
    return PEAKS[device.device_kind]


def flops_per_step(compiled) -> float:
    """XLA's cost analysis of one step.  It counts a scan body once, so the
    recurrent matmuls are under-counted and the MFU is a lower bound."""
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"])


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def timed_calls(fn, n):
    """Seconds of each of ``n`` calls, each waited for with block_until_ready."""
    import jax

    times = []
    for i in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i))
        times.append(time.perf_counter() - t0)
    return times


def main():
    from speech_recognition_tpu.backend import select_device, setup_compile_cache

    setup_compile_cache()
    select_device("GPU")

    import jax
    import jax.numpy as jnp
    import optax

    from speech_recognition_tpu.configs import get_model_config
    from speech_recognition_tpu.search import LASSearcher
    from speech_recognition_tpu.train import TrainState, linear_warmup_decay, make_train_step

    device = jax.devices()[0]
    peaks = peak(device)
    model = get_model_config(LAS_SMALL).create_model().clone(dtype=jnp.bfloat16)

    rng = jax.random.PRNGKey(0)
    audio = jax.random.normal(rng, (BATCH, FRAMES, 80, 3), jnp.float32)
    tokens = jax.random.randint(rng, (BATCH, TOKENS), 1, 16000)
    variables = model.init({"params": rng}, (audio, tokens[:, :-1]))
    state = TrainState.create(dict(variables), optax.adam(linear_warmup_decay(10000, 2e-4, 1e-5)))
    train_step = make_train_step(model, model.get_loss_fn(), model.get_metrics(), needs_teacher_forcing_rng=True)
    # the host pipeline ships bf16 features under mixed precision
    model_input, y_true = (audio.astype(jnp.bfloat16), tokens[:, :-1]), tokens[:, 1:]

    t0 = time.perf_counter()
    compiled = train_step.lower(state, model_input, y_true, rng).compile()
    compile_s = time.perf_counter() - t0
    flops = flops_per_step(compiled)

    holder = {"state": state}

    def one_step(i):
        holder["state"], metrics = compiled(holder["state"], model_input, y_true, jax.random.fold_in(rng, i))
        return holder["state"].params, metrics["loss"]

    timed_calls(one_step, 1)  # warm-up
    step_times = timed_calls(one_step, STEPS)
    step_s = statistics.median(step_times)

    searcher = LASSearcher(model, holder["state"].variables, max_token_length=TOKENS, bos_id=1, eos_id=2)
    audio_seconds = BATCH * ((FRAMES - 1) * 160 + 320) / 16000.0
    decode_in = audio.astype(jnp.bfloat16)

    def rtf(fn):
        timed_calls(fn, 1)  # compile + warm-up
        return statistics.median(timed_calls(fn, DECODE_CALLS)) / audio_seconds

    rtf_greedy = rtf(lambda i: searcher.greedy_search(decode_in)[0])
    rtf_beam8 = rtf(lambda i: searcher.beam_search(decode_in, 8)[0])

    print(json.dumps({
        "metric": "train_utterances_per_sec",
        "value": BATCH / step_s,
        "unit": "utt/s",
        "device": {"platform": device.platform, "kind": device.device_kind, "count": len(jax.devices())},
        "card": card(),
        "batch": BATCH,
        "step_ms": step_s * 1e3,
        "step_ms_all": [t * 1e3 for t in step_times],
        "compile_s": compile_s,
        "flops_per_step": flops,
        "mfu_lower_bound_vs_published_bf16_peak": flops / step_s / peaks["bf16_flops"],
        "rtf_greedy": rtf_greedy,
        "rtf_beam8": rtf_beam8,
        "peak_bytes_in_use": device.memory_stats()["peak_bytes_in_use"],
    }))


if __name__ == "__main__":
    sys.exit(main())
