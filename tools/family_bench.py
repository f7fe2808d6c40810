"""Per-family train-step bench on one NVIDIA GPU: LAS / DS2 / Conformer /
Transducer at the bench shapes (B=128, T=1024 audio frames, 16K vocab), each
family at its shipped small config (resources/configs/{las_small,deepspeech,
conformer_small,transducer_small}.yml sizes), in bf16.

Per family: compile time, median step time over timed steps (each waited
for with ``block_until_ready``), utt/s, and XLA's cost-analysis FLOPs with
the MFU they imply against the card's published peak (bench.PEAKS; a lower
bound: cost analysis counts a scan body once).  Results print as JSON.

Run: python tools/family_bench.py
     FAMILIES=conformer,transducer python tools/family_bench.py  (subset)
     python tools/family_bench.py --shapes   (off-bench shape matrix;
         CELLS=base,B32 filters)
Fails without a GPU, on an unknown device kind, or when any family fails.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import optax

from bench import card, flops_per_step, peak, timed_calls
from speech_recognition_tpu.train import TrainState, linear_warmup_decay, make_train_step

B, T, V = 128, 1024, 16000
dtype = jnp.bfloat16
REPS = int(os.environ.get("FAMILY_REPS", 8))


def _rng():
    return jax.random.PRNGKey(0)


def _ctc_tokens(b=None):
    rng = _rng()
    b = b or B
    return jnp.concatenate(
        [jax.random.randint(rng, (b, 40), 1, V), jnp.zeros((b, 24), jnp.int32)], axis=1
    )


def build_las(b=None, t=None, v=None):
    rng = _rng()
    from speech_recognition_tpu.models import LAS

    b, t, v = b or B, t or T, v or V
    model = LAS(
        rnn_type="lstm", vocab_size=v, encoder_hidden_dim=256, decoder_hidden_dim=256,
        num_encoder_layers=3, num_decoder_layers=2, dropout=0.15,
        teacher_forcing_rate=0.99, dtype=dtype,
    )
    audio = jax.random.normal(rng, (b, t, 80, 3), jnp.float32)
    tokens = jax.random.randint(rng, (b, 128), 1, v)
    variables = model.init({"params": rng}, (audio, tokens[:, :-1]))
    audio = audio.astype(dtype)
    step = make_train_step(
        model, model.get_loss_fn(), model.get_metrics(), needs_teacher_forcing_rng=True
    )
    return model, variables, step, (audio, tokens[:, :-1]), tokens[:, 1:]


def build_deepspeech2(b=None, t=None, v=None):
    rng = _rng()
    from speech_recognition_tpu.models import DeepSpeech2

    b, t, v = b or B, t or T, v or V
    model = DeepSpeech2(
        3, (32, 32, 96), ((41, 11), (21, 11), (21, 11)), ((2, 2), (2, 1), (2, 1)),
        "gru", 7, 128, 0.1, 0.0, v, 14, dtype=dtype,
    )
    audio = jax.random.normal(rng, (b, t, 80, 1), jnp.float32)
    tokens = _ctc_tokens(b)
    variables = model.init({"params": rng}, audio)
    step = make_train_step(model, model.get_loss_fn(), model.get_metrics())
    return model, variables, step, audio, tokens


def build_conformer(b=None, t=None, v=None):
    rng = _rng()
    from speech_recognition_tpu.models import Conformer

    b, t, v = b or B, t or T, v or V
    model = Conformer(
        vocab_size=v, encoder_dim=256, num_layers=16, num_attention_heads=4,
        conv_kernel_size=32, ffn_expansion=4, dropout=0.1,
        subsample_channels=(128, 128), blank_index=14, dtype=dtype,
    )
    audio = jax.random.normal(rng, (b, t, 80, 1), dtype)
    tokens = _ctc_tokens(b)
    variables = model.init({"params": rng}, audio)
    step = make_train_step(model, model.get_loss_fn(), model.get_metrics())
    return model, variables, step, audio, tokens


def build_transducer(pruned_range=0, b=None, t=None, v=None):
    rng = _rng()
    from speech_recognition_tpu.models import Transducer

    b, t, v = b or B, t or T, v or V
    model = Transducer(
        vocab_size=v, encoder_dim=256, num_encoder_layers=16, num_attention_heads=4,
        conv_kernel_size=32, ffn_expansion=4, subsample_channels=(128, 128),
        pred_dim=320, num_pred_layers=1, joint_dim=320, dropout=0.1, dtype=dtype,
        pruned_range=pruned_range,
    )
    audio = jax.random.normal(rng, (b, t, 80, 3), dtype)
    # libri-shaped labels: ~40 real sentencepiece tokens + pad to 64
    tokens = _ctc_tokens(b)
    model_input, y_true = (audio, tokens[:, :-1]), tokens[:, 1:]
    variables = model.init({"params": rng}, model_input)
    step = make_train_step(model, model.get_loss_fn(), model.get_metrics())
    return model, variables, step, model_input, y_true


BUILDERS = {
    "las": build_las,
    "deepspeech2": build_deepspeech2,
    "conformer": build_conformer,
    "transducer": build_transducer,
    # pruned (banded) lattice, s_range=4 — the SHIPPED transducer training
    # objective (resources/configs/transducer_small.yml pruned_range: 4)
    "transducer_pruned": lambda **kw: build_transducer(pruned_range=4, **kw),
    # wider-band sweep row (transducer_small_pruned.yml): on demand via
    # FAMILIES=transducer_pruned8, not part of the default sweep
    "transducer_pruned8": lambda **kw: build_transducer(pruned_range=8, **kw),
}

# the default sweep: every shipped family objective (the wider-band pruned8
# sweep row is measured on demand via FAMILIES=transducer_pruned8)
DEFAULT_FAMILIES = [n for n in BUILDERS if n != "transducer_pruned8"]


def measure(name, builder, reps=None):
    model, variables, step, model_input, y_true = builder()
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(variables["params"]))
    rng = _rng()
    state = TrainState.create(dict(variables), optax.adam(linear_warmup_decay(10000, 2e-4, 1e-5)))
    t0 = time.perf_counter()
    compiled = step.lower(state, model_input, y_true, rng).compile()
    compile_s = time.perf_counter() - t0
    flops = flops_per_step(compiled)
    batch = jax.tree_util.tree_leaves(model_input)[0].shape[0]
    print(f"[{name}] {n_params/1e6:.1f} M params, compile {compile_s:.1f} s", flush=True)
    holder = {"state": state}

    def one_step(i):
        holder["state"], metrics = compiled(holder["state"], model_input, y_true, jax.random.fold_in(rng, i))
        return holder["state"].params, metrics["loss"]

    timed_calls(one_step, 1)  # warm-up
    times = timed_calls(one_step, reps or REPS)
    step_s = statistics.median(times)
    out = {
        "step_ms": step_s * 1e3,
        "step_ms_all": [t * 1e3 for t in times],
        "utt_per_s": batch / step_s,
        "params_m": n_params / 1e6,
        "flops_per_step": flops,
        "mfu_lower_bound": flops / step_s / peak(jax.devices()[0])["bf16_flops"],
        "compile_s": compile_s,
    }
    print(f"[{name}] median {out['step_ms']:.2f} ms/step, MFU >= {out['mfu_lower_bound']:.4f}", flush=True)
    return out


def _header():
    from speech_recognition_tpu.backend import select_device, setup_compile_cache

    setup_compile_cache()
    select_device("GPU")
    device = jax.devices()[0]
    peak(device)
    return {"device": device.device_kind, "card": card()}


def main():
    which = os.environ.get("FAMILIES", ",".join(DEFAULT_FAMILIES)).split(",")
    results = dict(_header(), batch=B, audio_frames=T, families={})
    for name in which:
        results["families"][name] = measure(name, BUILDERS[name])
    print(json.dumps(results))


# --------------------------------------------------- off-bench shape matrix

# one-dimension-at-a-time variants around the bench point: plausible user
# shapes (small batch, short/long audio, kspon 8K vocab).
CELLS = {
    "base": dict(b=128, t=1024, v=16000),
    "B32": dict(b=32, t=1024, v=16000),
    "T512": dict(b=128, t=512, v=16000),
    "T2048": dict(b=128, t=2048, v=16000),
    "V8k": dict(b=128, t=1024, v=8000),
}


def main_shapes():
    which = os.environ.get("FAMILIES", ",".join(DEFAULT_FAMILIES)).split(",")
    cells = os.environ.get("CELLS", ",".join(CELLS)).split(",")
    results = dict(_header(), cells={})
    for name in which:
        for cell in cells:
            kw = CELLS[cell]
            print(f"=== {name}/{cell}: {kw}", flush=True)
            r = measure(name, lambda: BUILDERS[name](**kw), reps=3)
            r["shape"] = kw
            results["cells"][f"{name}/{cell}"] = r
    print(json.dumps(results))


if __name__ == "__main__":
    if "--shapes" in sys.argv:
        main_shapes()
    else:
        main()
