"""Profile LAS-small on one GPU: three train steps and one greedy decode
under ``jax.profiler``, reduced to the top device operations and the
device's busy share in each window.

    python tools/trace_las.py [--out DIR] [--top N]

Shapes are the smoke run's (chip_smoke.py): B=64, 2048 frames x 80 mel x 3,
127 decoder positions, V=16000, bf16.  Everything is compiled and run once
before the trace, so the windows hold no compilation.  The trace stays in
``--out`` (``plugins/profile/<time>/*.xplane.pb``); the reduction prints one
JSON line per window.
"""

import argparse
import glob
import json
import os
import sys
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(xplane_path, windows, top=20):
    """Per named host window: device busy share and the top device ops.

    ``windows`` maps a host annotation name (``jax.profiler.TraceAnnotation``)
    to the list of its [start, end) intervals found in the trace.  Device
    time is read from the device planes' per-op line (``XLA Ops``) when the
    trace has one, else from the kernel stream lines."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    op_events, kernel_events = [], []
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            events = [(e.name, int(e.start_ns), int(e.end_ns)) for e in line.events]
            if line.name == "XLA Ops":
                op_events += events
            elif line.name.startswith("Stream"):
                kernel_events += events
    ops = op_events or kernel_events
    out = {}
    for name, spans in windows.items():
        per_op = defaultdict(int)
        busy, length, kernels = 0, 0, 0
        for s, e in spans:
            inside = [(n, a, b) for n, a, b in ops if a >= s and b <= e]
            for n, a, b in inside:
                per_op[n] += b - a
            running = [(max(a, s), min(b, e)) for _, a, b in kernel_events if b > s and a < e]
            kernels += len(running)
            busy += _union_ns(running)
            length += e - s
        ranked = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
        out[name] = {
            "window_ms": length / 1e6,
            "device_busy_share": busy / length if length else None,
            "device_events": kernels,
            "mean_event_us": busy / kernels / 1e3 if kernels else None,
            "top_ops_ms": [(n, t / 1e6) for n, t in ranked],
            "op_source": "XLA Ops" if op_events else "kernel streams",
        }
    return out


def host_windows(xplane_path, names):
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    spans = {n: [] for n in names}
    for plane in data.planes:
        if not plane.name.startswith("/host"):
            continue
        for line in plane.lines:
            for e in line.events:
                if e.name in spans:
                    spans[e.name].append((int(e.start_ns), int(e.end_ns)))
    return spans


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, ".smoke_work", "trace"))
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()

    from speech_recognition_tpu.backend import select_device, setup_compile_cache

    setup_compile_cache()
    select_device("GPU")
    import jax
    import jax.numpy as jnp
    import optax

    from speech_recognition_tpu.configs import get_model_config
    from speech_recognition_tpu.search import LASSearcher
    from speech_recognition_tpu.train import TrainState, make_train_step

    B, T, N = 64, 2048, 128
    model = get_model_config(os.path.join(REPO, "resources", "configs", "las_small.yml")).create_model()
    model = model.clone(dtype=jnp.bfloat16)
    rng = jax.random.PRNGKey(0)
    audio = jax.random.normal(rng, (B, T, 80, 3), jnp.float32)
    tokens = jax.random.randint(rng, (B, N), 1, 16000)
    variables = model.init({"params": rng}, (audio, tokens[:, :-1]))
    state = TrainState.create(dict(variables), optax.adam(1e-4))
    step = make_train_step(model, model.get_loss_fn(), model.get_metrics(), needs_teacher_forcing_rng=True)
    model_input, y_true = (audio.astype(jnp.bfloat16), tokens[:, :-1]), tokens[:, 1:]

    state, metrics = step(state, model_input, y_true, rng)
    jax.block_until_ready(metrics)
    searcher = LASSearcher(model, state.variables, N, bos_id=2, eos_id=3)
    jax.block_until_ready(searcher.greedy_search(model_input[0]))

    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        for i in range(3):
            with jax.profiler.StepTraceAnnotation("train_step", step_num=i):
                state, metrics = step(state, model_input, y_true, jax.random.fold_in(rng, i))
                jax.block_until_ready(metrics)
        with jax.profiler.TraceAnnotation("greedy_decode"):
            jax.block_until_ready(searcher.greedy_search(model_input[0]))

    path = sorted(glob.glob(os.path.join(args.out, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    from jax.profiler import ProfileData

    inventory = {
        plane.name: {line.name: sum(1 for _ in line.events) for line in plane.lines}
        for plane in ProfileData.from_file(path).planes if plane.name.startswith("/device:")
    }
    print("TRACE_PLANES " + json.dumps(inventory))
    windows = host_windows(path, ["train_step", "greedy_decode"])
    for name, result in reduce_trace(path, windows, args.top).items():
        print("TRACE_WINDOW " + json.dumps({"window": name, **result}))


if __name__ == "__main__":
    main()
