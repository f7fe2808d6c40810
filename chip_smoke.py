"""Smoke test of the LAS-small path on one NVIDIA GPU.

    python chip_smoke.py                 # one card: train, decode, parity
    python chip_smoke.py --four-cards    # only: 4-card data parallel vs 1 card

Phases (one card):
  1. environment: the card's name and power limit (nvidia-smi), the JAX
     version and devices, which optional packages import;
  2. train through the train CLI's entry point: LAS-small at its published
     widths (resources/configs/las_small.yml, V=16000) on a seeded synthetic
     LibriSpeech-shaped dataset, B=64, bf16, 6 steps; per-step loss, median
     step time after warm-up, utt/s, peak device bytes, compilations inside
     the timed steps;
  3. decode through the evaluate CLI (greedy and beam 8) and the inference
     CLI on the checkpoint phase 2 wrote; real-time factors;
  4. the tests marked ``gpu``, then parity of the GPU against the plain
     reference — the same program on the CPU backend of the same process.

Every phase that touches the card runs in its own child process, one at a
time (a JAX process reserves most of the card's memory); this process
stays off JAX.  Any failure exits non-zero without the result line.  The
last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import wave

REPO = os.path.dirname(os.path.abspath(__file__))
LAS_SMALL = os.path.join(REPO, "resources", "configs", "las_small.yml")
LIBRI_CONFIG = os.path.join(REPO, "resources", "configs", "libri_config.yml")
SP_MODEL = os.path.join(REPO, "resources", "sp-models", "sp_model_unigram_16K_libri.model")

TRAIN_BATCH = 64
TRAIN_STEPS = 6
TRAIN_UTTERANCES = 64
EVAL_UTTERANCES = 32
SAMPLE_RATE = 16000

_WORDS = (
    "the of and to a in that is was he for it with as his on be at by i this had not are but from or have "
    "an they which one you were her all she there would their we him been has when who will more no if out "
    "so said what up its about into than them can only other new some could time these two may then do first "
    "any my now such like our over man me even most made after also did many before must through back years "
    "where much your way well down should because each just those people how too little state good very make "
    "world still own see men work long get here between both life being under never day same another know "
    "while last might us great old year off come since against go came right used take three"
).split()


class SmokeFailure(RuntimeError):
    pass


# ------------------------------------------------------------------- helpers
def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card data-parallel phase and its 1-card comparison")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "smoke"),
                    help="directory for the logs and decode outputs")
    ap.add_argument("--work", default=os.path.join(REPO, ".smoke_work"),
                    help="directory for the synthetic data and checkpoints")
    ap.add_argument("--phase", choices=["train", "parity", "four_cards"], help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.phases = ["four_cards"] if args.four_cards else ["env", "train", "decode", "gpu_tests", "parity"]
    return args


def result_line(device: dict) -> str:
    """The last line of the run: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"], "count": int(device["count"]),
    }})


def write_synthetic_dataset(directory: str, name: str, count: int, seed: int,
                            min_seconds: float = 8.0, max_seconds: float = 12.0) -> str:
    """Write ``count`` seeded 16 kHz mono wav files of ``min_seconds`` to
    ``max_seconds`` with English transcripts; returns the tsv path
    (``FilePath<TAB>Text``, paths relative to the tsv, as LibriSpeech tsvs)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    audio_dir = os.path.join(directory, name)
    os.makedirs(audio_dir, exist_ok=True)
    rows = []
    for i in range(count):
        n = int(rng.uniform(min_seconds, max_seconds) * SAMPLE_RATE)
        t = np.arange(n) / SAMPLE_RATE
        # voiced segments: a harmonic stack on a drifting pitch, under a
        # syllable-rate envelope, plus noise (spectrally speech-like)
        f0 = 110.0 + 60.0 * rng.rand() + 20.0 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t)
        phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
        voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
        envelope = np.clip(np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t + rng.rand() * 6.0), 0.0, None)
        signal = 0.3 * voiced * envelope + 0.02 * rng.randn(n)
        pcm = np.clip(signal / max(np.abs(signal).max(), 1e-6) * 0.8, -1.0, 1.0)
        path = os.path.join(audio_dir, f"{i:04d}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SAMPLE_RATE)
            w.writeframes((pcm * 32767).astype("<i2").tobytes())
        words = rng.choice(_WORDS, size=rng.randint(12, 30))
        rows.append((os.path.join(name, f"{i:04d}.wav"), " ".join(words).upper()))
    tsv = os.path.join(directory, f"{name}.tsv")
    with open(tsv, "w") as f:
        f.write("FilePath\tText\n")
        for path, text in rows:
            f.write(f"{path}\t{text}\n")
    return tsv


def _card_line() -> str:
    if shutil.which("nvidia-smi") is None:
        raise SmokeFailure("nvidia-smi not found: no NVIDIA GPU on this machine")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def _child(cmd, log_path, timeout, env=None):
    """Run one child to completion, teeing its output into ``log_path``."""
    start = time.perf_counter()
    full_env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    full_env.update(env or {})
    with open(log_path, "w") as log:
        proc = subprocess.run(cmd, cwd=REPO, env=full_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, timeout=timeout)
        log.write(proc.stdout)
    if proc.returncode != 0:
        tail = "\n".join(proc.stdout.splitlines()[-30:])
        raise SmokeFailure(f"{' '.join(cmd[:4])} ... exited {proc.returncode} (log {log_path}):\n{tail}")
    return proc.stdout, time.perf_counter() - start


def _tagged(output: str, tag: str) -> dict:
    for line in output.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    raise SmokeFailure(f"no {tag} line in the child's output")


# -------------------------------------------------------------- parent phases
def phase_env(args):
    import importlib.util
    from importlib import metadata

    print(f"[env] card: {_card_line()}")
    print(f"[env] jax {metadata.version('jax')}, python {sys.version.split()[0]}")
    for mod in ("flax", "orbax.checkpoint", "yaml"):
        top = mod.split(".")[0]
        found = importlib.util.find_spec(top) is not None and (top == mod or importlib.util.find_spec(mod) is not None)
        print(f"[env] {mod}: {'importable' if found else 'not installed'} (the program does not need it)")
    from speech_recognition_tpu.data import native  # host-only: no JAX backend

    built = native._load() is not None
    print(f"[env] native data library (native/asr_native.cpp, g++): "
          f"{'built and loaded' if built else 'unavailable, pure-Python decoders in use'}")
    code = ("import jax, json; d = jax.devices(); print('DEVICE ' + json.dumps("
            "{'platform': d[0].platform, 'kind': d[0].device_kind, 'count': len(d)}))")
    out, _ = _child([sys.executable, "-c", code], os.path.join(args.out, "env.log"), 300)
    device = _tagged(out, "DEVICE")
    print(f"[env] JAX devices: platform={device['platform']} kind={device['kind']} count={device['count']}")
    if device["platform"] != "gpu":
        raise SmokeFailure(f"JAX's default platform is {device['platform']}, not gpu")
    return device


def phase_train(args):
    data = os.path.join(args.work, "data")
    if os.path.isdir(data):
        shutil.rmtree(data)
    write_synthetic_dataset(data, "train", TRAIN_UTTERANCES, seed=1)
    write_synthetic_dataset(data, "dev", EVAL_UTTERANCES, seed=2)
    train_out = os.path.join(args.work, "train")
    if os.path.isdir(train_out):
        shutil.rmtree(train_out)
    out, seconds = _child(
        [sys.executable, os.path.abspath(__file__), "--phase", "train", "--out", args.out, "--work", args.work],
        os.path.join(args.out, "train.log"), 900,
    )
    summary = _tagged(out, "TRAIN_SUMMARY")
    for i, (loss, step_s, compiles) in enumerate(zip(summary["losses"], summary["step_seconds"],
                                                     summary["compiles"]), 1):
        print(f"[train] step {i}: loss {loss:.6f}  {step_s * 1e3:.1f} ms  compilations {compiles}")
    print(f"[train] median step after warm-up: {summary['median_step_ms']:.2f} ms, "
          f"{summary['utt_per_s']:.1f} utt/s, {summary['audio_s_per_s']:.1f} s of audio per s (B={TRAIN_BATCH}, bf16)")
    print(f"[train] peak_bytes_in_use: {summary['peak_bytes_in_use']}")
    print(f"[train] compilations inside the timed steps: {summary['timed_compiles']}")
    print(f"[train] first step (compile included): {summary['step_seconds'][0]:.1f} s; child wall {seconds:.1f} s")


def phase_decode(args, checkpoint):
    common = ["--data-config", LIBRI_CONFIG, "--model-config", LAS_SMALL, "--sp-model-path", SP_MODEL,
              "--model-path", checkpoint, "--device", "GPU", "--mixed-precision"]
    dev_tsv = os.path.join(args.work, "data", "dev.tsv")
    for label, extra in (("greedy", []), ("beam8", ["--beam-size", "8"])):
        pred_tsv = os.path.join(args.out, f"eval_{label}.tsv")
        out, seconds = _child(
            [sys.executable, "-m", "speech_recognition_tpu.run.evaluate", *common, "--dataset-paths", dev_tsv,
             "--batch-size", "8", "--output-path", pred_tsv, *extra],
            os.path.join(args.out, f"eval_{label}.log"), 900,
        )
        rtf = re.search(r"Decoded ([\d.]+) s of audio in (\d+) batches, ([\d.]+) s: RTF ([\d.]+)"
                        r"(?:; after the first batch: RTF ([\d.]+))?", out)
        wer = re.search(r"Average WER: ([\d.]+)%", out)
        if not rtf or not wer:
            raise SmokeFailure(f"evaluate ({label}) printed no RTF/WER line")
        with open(pred_tsv) as f:
            rows = f.read().splitlines()[1:]
        if len(rows) != EVAL_UTTERANCES or any(len(r.split("\t")) != 4 for r in rows):
            raise SmokeFailure(f"evaluate ({label}) wrote {len(rows)} malformed rows, expected {EVAL_UTTERANCES}")
        print(f"[decode] evaluate {label}: {len(rows)} utterances, {rtf.group(1)} s of audio in {rtf.group(2)} "
              f"batches, {rtf.group(3)} s (RTF {rtf.group(4)} with compilation; after the first batch RTF "
              f"{rtf.group(5)}); "
              f"WER {wer.group(1)}% (random weights); child wall {seconds:.1f} s")
    dev_dir = os.path.join(args.work, "data", "dev")
    files = sorted(os.path.join(dev_dir, f) for f in os.listdir(dev_dir))[:4]
    inf_dir = os.path.join(args.work, "inference")
    os.makedirs(inf_dir, exist_ok=True)
    for f in files:
        shutil.copy(f, inf_dir)
    inf_tsv = os.path.join(args.out, "inference.tsv")
    out, seconds = _child(
        [sys.executable, "-m", "speech_recognition_tpu.run.inference", *common,
         "--audio-files", os.path.join(inf_dir, "*.wav"), "--batch-size", "4", "--output-path", inf_tsv],
        os.path.join(args.out, "inference.log"), 900,
    )
    with open(inf_tsv) as f:
        rows = f.read().splitlines()[1:]
    if len(rows) != len(files) or any(len(r.split("\t")) != 2 for r in rows):
        raise SmokeFailure(f"inference wrote {len(rows)} malformed rows for {len(files)} files")
    rtf = re.search(r"RTF ([\d.]+)", out)
    print(f"[decode] inference greedy: {len(rows)} files, RTF {rtf.group(1) if rtf else 'n/a'} "
          f"(compilation included); child wall {seconds:.1f} s")


def phase_gpu_tests(args):
    out, seconds = _child(
        [sys.executable, "-m", "pytest", "-o", "addopts=", "-q", "-m", "gpu", "-p", "no:cacheprovider",
         "tests/test_gpu.py"],
        os.path.join(args.out, "gpu_tests.log"), 900, env={"JAX_PLATFORMS": "cuda,cpu"},
    )
    summary = out.strip().splitlines()[-1]
    if "passed" not in summary or "skipped" in summary or "failed" in summary:
        raise SmokeFailure(f"gpu tests did not all pass: {summary}")
    print(f"[gpu-tests] {summary} ({seconds:.1f} s)")


def phase_parity(args, checkpoint):
    out, seconds = _child(
        [sys.executable, os.path.abspath(__file__), "--phase", "parity", "--out", args.out, "--work", args.work],
        os.path.join(args.out, "parity.log"), 900, env={"SMOKE_CHECKPOINT": checkpoint},
    )
    for line in out.splitlines():
        if line.startswith("[parity]"):
            print(line)
    print(f"[parity] child wall {seconds:.1f} s")


# --------------------------------------------------------------- child phases
def _jax_setup():
    from speech_recognition_tpu.backend import select_device, setup_compile_cache

    setup_compile_cache()
    select_device("GPU")


def child_train(args):
    """The train CLI's entry point with every step timed to completion."""
    _jax_setup()
    import jax
    import numpy as np

    import speech_recognition_tpu.train as train_pkg
    from speech_recognition_tpu.configs import TrainConfig
    from speech_recognition_tpu.run import train as train_cli

    compiles = [0]

    def _listener(event, duration, **kwargs):
        if event in ("/jax/core/compile/backend_compile_duration", "/jax/core/compile/jaxpr_trace_duration"):
            compiles[0] += 1

    jax.monitoring.register_event_duration_secs_listener(_listener)
    records = []
    make_train_step = train_pkg.make_train_step

    def timed_make_train_step(*a, **k):
        step = make_train_step(*a, **k)

        def timed(state, model_input, y_true, rng):
            before = compiles[0]
            t0 = time.perf_counter()
            state, metrics = step(state, model_input, y_true, rng)
            jax.block_until_ready((state.params, metrics))
            records.append((time.perf_counter() - t0, float(metrics["loss"]), compiles[0] - before))
            return state, metrics

        return timed

    train_pkg.make_train_step = timed_make_train_step
    data = os.path.join(args.work, "data")
    argv = [
        "--data-config", LIBRI_CONFIG, "--model-config", LAS_SMALL, "--sp-model-path", SP_MODEL,
        "--train-dataset-paths", os.path.join(data, "train.tsv"),
        "--dev-dataset-paths", os.path.join(data, "dev.tsv"),
        "--train-dataset-size", str(TRAIN_UTTERANCES), "--output-path", os.path.join(args.work, "train"),
        "--epochs", "1", "--steps-per-epoch", str(TRAIN_STEPS), "--learning-rate", "1e-4",
        "--batch-size", str(TRAIN_BATCH), "--dev-batch-size", str(EVAL_UTTERANCES),
        "--shuffle-buffer-size", "1", "--max-over-policy", "slice", "--device", "GPU",
        "--mixed-precision", "--seed", "42",
    ]
    train_cli.main(TrainConfig(**vars(train_cli.parser.parse_args(argv))))
    if len(records) != TRAIN_STEPS:
        raise SmokeFailure(f"{len(records)} train steps ran, expected {TRAIN_STEPS}")
    losses = [r[1] for r in records]
    if not all(np.isfinite(losses)):
        raise SmokeFailure(f"non-finite train loss: {losses}")
    timed = records[1:]
    median = statistics.median(r[0] for r in timed)
    timed_compiles = sum(r[2] for r in timed)
    if timed_compiles:
        raise SmokeFailure(f"{timed_compiles} compilations inside the timed steps")
    with open(os.path.join(data, "train.tsv")) as f:
        next(f)
        n_rows = sum(1 for _ in f)
    mean_seconds = _mean_audio_seconds(os.path.join(data, "train"), n_rows)
    summary = {
        "losses": losses,
        "step_seconds": [r[0] for r in records],
        "compiles": [r[2] for r in records],
        "median_step_ms": median * 1e3,
        "utt_per_s": TRAIN_BATCH / median,
        "audio_s_per_s": TRAIN_BATCH * mean_seconds / median,
        "peak_bytes_in_use": jax.devices()[0].memory_stats()["peak_bytes_in_use"],
        "timed_compiles": timed_compiles,
    }
    print("TRAIN_SUMMARY " + json.dumps(summary))


def _mean_audio_seconds(audio_dir, count):
    total = 0.0
    for name in sorted(os.listdir(audio_dir))[:count]:
        with wave.open(os.path.join(audio_dir, name)) as w:
            total += w.getnframes() / w.getframerate()
    return total / count


def _las_small_model(dtype):
    import jax.numpy as jnp

    from speech_recognition_tpu.configs import get_model_config

    model = get_model_config(LAS_SMALL).create_model()
    return model if dtype == jnp.float32 else model.clone(dtype=dtype)


def _parity_batch(batch=8, frames=512, tokens=64, seed=0):
    """Log-mel-like features [B, frames, 80, 3] with per-row lengths, and
    token ids in the 16K vocabulary with trailing padding."""
    import numpy as np

    rng = np.random.RandomState(seed)
    feats = rng.randn(batch, frames, 80, 3).astype(np.float32)
    lengths = rng.randint(frames // 2, frames + 1, size=batch)
    lengths[0] = frames
    for b, n in enumerate(lengths):
        feats[b, n:] = 0.0
    toks = rng.randint(3, 16000, size=(batch, tokens + 1)).astype(np.int32)
    tok_lens = rng.randint(tokens // 2, tokens + 1, size=batch)
    for b, n in enumerate(tok_lens):
        toks[b, n:] = 0
    return feats, lengths.astype(np.int32), toks


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def child_parity(args):
    """GPU against the plain reference: the same program on the CPU backend
    of this process, float32 at precision 'highest'."""
    _jax_setup()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from speech_recognition_tpu.data import SentencePieceTokenizer
    from speech_recognition_tpu.search import LASSearcher
    from speech_recognition_tpu.train import restore_weights

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    model = _las_small_model(jnp.float32)
    feats, lengths, toks = _parity_batch()
    dec_in, y_true = toks[:, :-1], toks[:, 1:]
    variables = restore_weights(os.environ["SMOKE_CHECKPOINT"])
    with open(SP_MODEL, "rb") as f:
        bos, eos = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True).tokenize("")
    loss_fn = model.get_loss_fn()

    def run(device, precision, model=model):
        """(logits, loss, grad global norm, grads) of one forward/backward,
        compiled for ``device`` at matmul ``precision``."""

        def loss_and_grad(params, batch_stats):
            def loss(p):
                logits = model.apply({"params": p, "batch_stats": batch_stats}, ((feats, lengths), dec_in))
                return loss_fn(y_true, logits), logits

            (value, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
            norm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32))) for g in jax.tree_util.tree_leaves(grads)))
            return logits.astype(jnp.float32), value, norm, grads

        with jax.default_device(device), jax.default_matmul_precision(precision):
            on_dev = jax.device_put(variables, device)
            logits, loss, norm, grads = jax.jit(loss_and_grad)(on_dev["params"], on_dev["batch_stats"])
            return np.asarray(logits), float(loss), float(norm), jax.tree_util.tree_map(np.asarray, grads)

    ref_logits, ref_loss, ref_norm, ref_grads = run(cpu, "highest")
    print(f"[parity] CPU reference (f32, highest): loss {ref_loss:.6f}, grad norm {ref_norm:.6f}")

    def check(name, ok, detail):
        print(f"[parity] {name}: {detail} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"parity check failed: {name}")

    g_logits, g_loss, g_norm, g_grads = run(gpu, "highest")
    dlog = np.abs(g_logits - ref_logits)
    check("GPU f32 highest vs CPU logits (rtol 1e-4, atol 1e-4)",
          np.allclose(g_logits, ref_logits, rtol=1e-4, atol=1e-4), f"max |d| {dlog.max():.3e}")
    check("GPU f32 highest vs CPU loss (rtol 1e-4)", _rel(g_loss, ref_loss) <= 1e-4,
          f"{g_loss:.6f} vs {ref_loss:.6f}, rel {_rel(g_loss, ref_loss):.2e}")
    check("GPU f32 highest vs CPU grad global norm (rtol 1e-4)", _rel(g_norm, ref_norm) <= 1e-4,
          f"{g_norm:.6f} vs {ref_norm:.6f}, rel {_rel(g_norm, ref_norm):.2e}")

    d_logits, d_loss, _, _ = run(gpu, "default")
    check("GPU f32 default precision (TF32 allowed) vs CPU loss (rtol 1e-2)", _rel(d_loss, ref_loss) <= 1e-2,
          f"rel {_rel(d_loss, ref_loss):.2e}, max |d logits| {np.abs(d_logits - ref_logits).max():.3e}")

    b_logits, b_loss, _, _ = run(gpu, "default", model=_las_small_model(jnp.bfloat16))
    check("GPU bf16 mixed precision vs CPU loss (rel 2e-2)", _rel(b_loss, ref_loss) <= 2e-2,
          f"{b_loss:.6f} vs {ref_loss:.6f}, rel {_rel(b_loss, ref_loss):.2e}")

    os.environ["SRT_DECODER_CUSTOM_VJP"] = "0"
    try:
        _, a_loss, a_norm, a_grads = run(gpu, "highest")
    finally:
        os.environ["SRT_DECODER_CUSTOM_VJP"] = "1"
    # relative to the largest gradient entry: some leaves (the key projection
    # bias) have a gradient that is zero up to rounding
    scale = max(float(np.max(np.abs(a))) for a in jax.tree_util.tree_leaves(a_grads))
    worst = max(
        float(np.max(np.abs(a - c)))
        for a, c in zip(jax.tree_util.tree_leaves(a_grads), jax.tree_util.tree_leaves(g_grads))
    ) / scale
    check("decoder custom VJP vs plain autodiff on the GPU (f32 highest, rtol 1e-4)",
          worst <= 1e-4 and _rel(g_norm, a_norm) <= 1e-4,
          f"max |d| / max |g| over all leaves {worst:.2e}, norms {g_norm:.6f} vs {a_norm:.6f}")

    def greedy(device):
        with jax.default_device(device), jax.default_matmul_precision("highest"):
            searcher = LASSearcher(model, jax.device_put(variables, device), 64, bos, eos, 0)
            tokens, _ = searcher.greedy_search(feats)  # pad frames are zero: lengths are recovered
            return np.asarray(tokens)

    cpu_tokens, gpu_tokens = greedy(cpu), greedy(gpu)
    # top-2 gap of each CPU step (log-prob gap == logit gap), from the
    # teacher-forced logits of the CPU path
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        tf_logits = jax.jit(lambda v, t: model.apply(v, (feats, t)))(
            jax.device_put(variables, cpu), jnp.asarray(cpu_tokens[:, :-1]))
    top2 = np.sort(np.asarray(tf_logits, np.float32), axis=-1)[..., -2:]
    gaps = top2[..., 1] - top2[..., 0]
    compared = agreed = 0
    for b in range(cpu_tokens.shape[0]):
        for t in range(1, cpu_tokens.shape[1]):
            compared += 1
            if cpu_tokens[b, t] == gpu_tokens[b, t]:
                agreed += 1
                if cpu_tokens[b, t] in (0, eos):
                    break
                continue
            if gaps[b, t - 1] > 1e-3:
                check("greedy tokens GPU vs CPU", False,
                      f"row {b} step {t}: {gpu_tokens[b, t]} vs {cpu_tokens[b, t]} with top-2 gap {gaps[b, t - 1]:.2e}")
            break  # a near-tie changed the history: later steps are not comparable
    check("greedy tokens GPU vs CPU identical wherever the top-2 gap > 1e-3", True,
          f"agreement {agreed}/{compared} = {agreed / max(compared, 1):.4f}")


def child_four_cards(args):
    """Data-parallel LAS-small train steps over 4 cards (the train CLI's
    mesh, sharding and step functions) against the same steps on 1 card."""
    _jax_setup()
    import jax
    import optax

    from speech_recognition_tpu.parallel import get_device_mesh, shard_batch, shard_params
    from speech_recognition_tpu.run.common import build_variables
    from speech_recognition_tpu.configs import DataConfig, get_model_config
    from speech_recognition_tpu.train import TrainState, make_train_step

    devices = jax.devices()
    if len(devices) < 4:
        raise SmokeFailure(f"--four-cards needs 4 GPUs, JAX finds {len(devices)}")
    print(f"[4-card] devices: {[d.device_kind for d in devices[:4]]}")
    model = get_model_config(LAS_SMALL).create_model()
    data_config = DataConfig.from_yaml(LIBRI_CONFIG)
    feats, lengths, toks = _parity_batch(batch=64, frames=512, tokens=64, seed=3)
    model_input, y_true = ((feats, lengths), toks[:, :-1]), toks[:, 1:]

    def run(n):
        with jax.default_matmul_precision("highest"):
            variables = build_variables(model, None, data_config, jax.random.PRNGKey(0))
            state = TrainState.create(variables, optax.adam(1e-3, eps=1e-7))
            mesh = get_device_mesh(data_parallel=n, model_parallel=1, devices=devices[:n])
            state = state.replace(params=shard_params(state.params, mesh),
                                  batch_stats=shard_params(state.batch_stats, mesh),
                                  opt_state=shard_params(state.opt_state, mesh))
            inp, y = shard_batch(model_input, mesh), shard_batch(y_true, mesh)
            step = make_train_step(model, model.get_loss_fn(), model.get_metrics(), needs_teacher_forcing_rng=True)
            losses, norms = [], []
            for i in range(2):
                state, metrics = step(state, inp, y, jax.random.PRNGKey(100 + i))
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
            return losses, norms[0]

    four, norm4 = run(4)
    one, norm1 = run(1)
    for i in range(2):
        ok = _rel(four[i], one[i]) <= 1e-5
        print(f"[4-card] step {i + 1} loss: 4 cards {four[i]:.7f}, 1 card {one[i]:.7f}, rel {_rel(four[i], one[i]):.2e} "
              f"-> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure("4-card loss differs from 1 card")
    ok = _rel(norm4, norm1) <= 1e-5
    print(f"[4-card] grad global norm: 4 cards {norm4:.7f}, 1 card {norm1:.7f}, rel {_rel(norm4, norm1):.2e} "
          f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure("4-card gradient norm differs from 1 card")
    d = devices[0]
    print("DEVICE " + json.dumps({"platform": d.platform, "kind": d.device_kind, "count": 4}))


# ---------------------------------------------------------------------- main
def main(argv=None):
    args = parse_args(argv)
    for path in (LAS_SMALL, LIBRI_CONFIG, SP_MODEL, os.path.join(REPO, "speech_recognition_tpu")):
        if not os.path.exists(path):
            print(f"chip_smoke: {path} is missing; run from a checkout of the repository", file=sys.stderr)
            return 2
    sys.path.insert(0, REPO)
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.work, exist_ok=True)
    if args.phase:
        {"train": child_train, "parity": child_parity, "four_cards": child_four_cards}[args.phase](args)
        return 0
    start = time.perf_counter()
    try:
        if args.phases == ["four_cards"]:
            print(f"[env] cards: {_card_line()}")
            out, _ = _child([sys.executable, os.path.abspath(__file__), "--phase", "four_cards",
                             "--out", args.out, "--work", args.work],
                            os.path.join(args.out, "four_cards.log"), 1100)
            for line in out.splitlines():
                if line.startswith("[4-card]"):
                    print(line)
            device = _tagged(out, "DEVICE")
        else:
            device = phase_env(args)
            phase_train(args)
            models = os.path.join(args.work, "train", "models")
            checkpoint = os.path.join(models, sorted(os.listdir(models))[-1])
            phase_decode(args, checkpoint)
            phase_gpu_tests(args)
            phase_parity(args, checkpoint)
    except (SmokeFailure, subprocess.TimeoutExpired) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[done] all phases passed in {time.perf_counter() - start:.1f} s")
    print(result_line(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
