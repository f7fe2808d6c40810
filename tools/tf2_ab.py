"""Same-hardware CPU A/B: reference TF2/Keras LAS train step vs ours.

The >=5x-vs-TF2 gate (BASELINE.md) asks for both frameworks on one
accelerator; both DO run the same model math on a host CPU — the
reference models import and build (tests/test_model_parity.py relies on it).
This harness times, at identical shapes and dims:

  * reference: keras model.train_on_batch (compiled Adam + masked CE,
    reference run/train.py:156-217) — the fit-loop inner step
  * ours: make_train_step (jitted forward+backward+Adam)

CPU timings are a proxy, not the accelerator gate: they compare framework overhead +
graph quality at small scale, on whatever cores this box has.  Record the
result in PERF.md with that caveat.

Usage: python tools/tf2_ab.py [--batch 8] [--frames 256] [--tokens 24]
       [--steps 10] [--dims 64]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REFERENCE_DIR = "/root/reference"


def time_steps(fn, steps, warmup=2):
    for _ in range(warmup):
        fn()
    t0 = time.time()
    for _ in range(steps):
        fn()
    return (time.time() - t0) / steps


def bench_reference(args, audio, dec_in, dec_out):
    import types

    import tensorflow as tf

    tf.config.set_visible_devices([], "GPU")
    sys.path.insert(0, REFERENCE_DIR)
    from speech_recognition.measure import SparseCategoricalAccuracy, SparseCategoricalCrossentropy
    from speech_recognition.models import LAS as RefLAS

    model = RefLAS(
        rnn_type="lstm", vocab_size=args.vocab, encoder_hidden_dim=args.dims,
        decoder_hidden_dim=args.dims, num_encoder_layers=args.enc_layers,
        num_decoder_layers=args.dec_layers, dropout=args.dropout,
        teacher_forcing_rate=1.0,
    )
    # Keras 2's Layer.__call__ ran `call` through autograph, which turned the
    # reference's tensor-condition branch (las.py:369 `if use_teacher_forcing
    # or i == 0`) into tf.cond; Keras 3 dropped that conversion, so apply it
    # explicitly to trace the same compiled graph the reference trained with.
    model.call = types.MethodType(tf.autograph.to_graph(RefLAS.call), model)
    model((audio, dec_in), training=True)
    model.compile(
        optimizer=tf.keras.optimizers.Adam(1e-3),
        loss=SparseCategoricalCrossentropy(),
        metrics=[SparseCategoricalAccuracy()],
    )

    def step():
        return model.train_on_batch((audio, dec_in), dec_out)

    return time_steps(step, args.steps)


def bench_reference_ds2(args, audio, tokens):
    import tensorflow as tf

    tf.config.set_visible_devices([], "GPU")
    sys.path.insert(0, REFERENCE_DIR)
    from speech_recognition.measure import CTCLoss
    from speech_recognition.models import DeepSpeech2 as RefDS2

    model = RefDS2(
        1, [32], [[41, 11]], [[2, 2]], "gru", args.enc_layers, args.dims,
        args.dropout, 0.0, args.vocab, args.vocab - 1,
    )
    model(audio, training=True)
    # Keras-3's compiled-loss pipeline casts y_true to float before the loss
    # (breaking tf.nn.ctc_loss's int label requirement), so run the same
    # computation as an explicit tf.function step — graph-compiled Adam +
    # CTCLoss, equivalent to the reference's Keras-2 fit step
    opt = tf.keras.optimizers.Adam(1e-3)
    loss_fn = CTCLoss(args.vocab - 1)
    audio_t = tf.constant(audio)
    tokens_t = tf.constant(tokens)

    @tf.function
    def step_fn():
        with tf.GradientTape() as tape:
            logits = model(audio_t, training=True)
            # .call directly: keras Loss.__call__ would cast the int labels
            # to float; mean == the SUM_OVER_BATCH_SIZE reduction compile
            # applies to the per-example losses
            loss = tf.reduce_mean(loss_fn.call(tokens_t, logits))
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        return loss

    def step():
        return step_fn().numpy()

    return time_steps(step, args.steps)


def bench_ours_ds2(args, audio, tokens):
    import jax
    import optax

    from speech_recognition_tpu.models import DeepSpeech2
    from speech_recognition_tpu.train import TrainState, make_train_step

    model = DeepSpeech2(
        1, (32,), ((41, 11),), ((2, 2),), "gru", args.enc_layers, args.dims,
        args.dropout, 0.0, args.vocab, args.vocab - 1,
    )
    rng = jax.random.PRNGKey(0)
    variables = model.init({"params": rng}, audio)
    state = TrainState.create(dict(variables), optax.adam(1e-3))
    train_step = make_train_step(model, model.get_loss_fn(), model.get_metrics())
    holder = {"state": state}

    def step():
        holder["state"], metrics = train_step(holder["state"], audio, tokens, rng)
        jax.block_until_ready(metrics["loss"])
        return metrics

    return time_steps(step, args.steps)


def bench_ours(args, audio, dec_in, dec_out):
    import jax

    from speech_recognition_tpu.models import LAS
    from speech_recognition_tpu.train import TrainState, linear_warmup_decay, make_train_step
    import optax

    model = LAS(
        rnn_type="lstm", vocab_size=args.vocab, encoder_hidden_dim=args.dims,
        decoder_hidden_dim=args.dims, num_encoder_layers=args.enc_layers,
        num_decoder_layers=args.dec_layers, dropout=args.dropout,
        teacher_forcing_rate=1.0,
    )
    rng = jax.random.PRNGKey(0)
    variables = model.init({"params": rng}, (audio, dec_in))
    state = TrainState.create(dict(variables), optax.adam(1e-3))
    train_step = make_train_step(
        model, model.get_loss_fn(), model.get_metrics(), needs_teacher_forcing_rng=True
    )
    holder = {"state": state}

    def step():
        holder["state"], metrics = train_step(holder["state"], (audio, dec_in), dec_out, rng)
        jax.block_until_ready(metrics["loss"])
        return metrics

    return time_steps(step, args.steps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--dims", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--enc-layers", type=int, default=3)
    ap.add_argument("--dec-layers", type=int, default=2)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--model", choices=["las", "ds2"], default="las")
    ap.add_argument("--only", choices=["ref", "ours"], help="run one side (isolates process state)")
    args = ap.parse_args()

    # force both frameworks onto the host CPU: identical hardware.  jax may
    # already be imported with another backend, so the env var alone is not
    # enough — re-point the already-initialized backend
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
    import jax

    if jax.default_backend() != "cpu":
        import jax.extend.backend as _jeb

        jax.config.update("jax_platforms", "cpu")
        _jeb.clear_backends()
    assert jax.default_backend() == "cpu", jax.default_backend()

    rng = np.random.default_rng(0)
    audio = rng.standard_normal((args.batch, args.frames, 80, 3)).astype(np.float32)
    tokens = rng.integers(1, args.vocab - 1, (args.batch, args.tokens + 1)).astype(np.int32)
    dec_in, dec_out = tokens[:, :-1], tokens[:, 1:]

    utt = lambda dt: args.batch / dt
    results = {}
    if args.only in (None, "ours"):
        if args.model == "las":
            dt = bench_ours(args, audio, dec_in, dec_out)
        else:
            dt = bench_ours_ds2(args, audio, tokens[:, :-1])
        results["ours"] = dt
        print(f"{args.model} ours (jit step):        {dt * 1e3:8.1f} ms/step = {utt(dt):7.1f} utt/s")
    if args.only in (None, "ref"):
        if args.model == "las":
            dt = bench_reference(args, audio, dec_in, dec_out)
        else:
            dt = bench_reference_ds2(args, audio, tokens[:, :-1])
        results["ref"] = dt
        print(f"{args.model} reference (TF2/Keras):  {dt * 1e3:8.1f} ms/step = {utt(dt):7.1f} utt/s")
    if len(results) == 2:
        print(f"{args.model} speedup ours vs TF2 (CPU proxy): {results['ref'] / results['ours']:.2f}x")


if __name__ == "__main__":
    main()
