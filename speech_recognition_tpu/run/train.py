"""Training entry point.

CLI surface parity with reference speech_recognition/run/train.py (same flags,
same ``--from-file`` YAML merge where CLI overrides file keys).  The
orchestration is XLA-native: static-shape padded batches, one jitted SPMD
train step over a ('data','model') mesh, one checkpoint per epoch.
"""

import argparse
import os
import sys
import time

from ..configs import TrainConfig
from ..utils import get_logger, makedirs, open_file, path_join, set_random_seed

# fmt: off
parser = argparse.ArgumentParser(argument_default=argparse.SUPPRESS)
parser.add_argument("--from-file", type=str, help="load configs from file")

parser.add_argument("--data-config", type=str, help="data processing config file")
parser.add_argument("--model-config", type=str, help="model config file")
parser.add_argument("--sp-model-path", type=str, help="sentencepiece model path")
parser.add_argument("--train-dataset-paths", help="a tsv/tfrecord dataset file or multiple files ex) *.tsv")
parser.add_argument("--dev-dataset-paths", help="a tsv/tfrecord dataset file or multiple files ex) *.tsv")
parser.add_argument("--train-dataset-size", type=int, help="the number of training dataset examples")
parser.add_argument("--output-path", help="output directory to save log and model checkpoints")

parser.add_argument("--pretrained-model-path", type=str, help="pretrained model checkpoint")
parser.add_argument("--epochs", type=int)
parser.add_argument("--steps-per-epoch", type=int)
parser.add_argument("--learning-rate", type=float)
parser.add_argument("--min-learning-rate", type=float)
parser.add_argument("--warmup-rate", type=float)
parser.add_argument("--warmup-steps", type=int)
parser.add_argument("--batch-size", type=int)
parser.add_argument("--dev-batch-size", type=int)
parser.add_argument("--shuffle-buffer-size", type=int, help="shuffle buffer size")
parser.add_argument("--max-over-policy", type=str, choices=["filter", "slice"], help="policy for sequence whose length is over max")

parser.add_argument("--use-tfrecord", action="store_true", help="use tfrecord dataset")
parser.add_argument("--tensorboard-update-freq", type=int)
parser.add_argument("--mixed-precision", action="store_true", help="use mixed precision (bfloat16)")
parser.add_argument("--seed", type=int, help="Set random seed")
parser.add_argument("--skip-epochs", type=int, help="skip first N epochs and start N + 1 epoch")
parser.add_argument("--device", type=str, choices=["CPU", "GPU"], help="device to use (GPU or CPU)")
parser.add_argument("--profile-steps", type=int, help="capture a jax.profiler trace of N training steps into <output>/profile")
parser.add_argument("--on-device-frontend", action=argparse.BooleanOptionalAction, help="fuse the audio feature frontend into the on-device training step (default: on for GPU tsv runs; --no-on-device-frontend reverts to host features)")
parser.add_argument("--bucket-boundaries", type=str, help="comma-separated audio-length bucket boundaries for bucketed batching, e.g. 512,1024,2048")
parser.add_argument("--auto-resume", action="store_true", help="resume from the newest checkpoint in <output>/models (sets pretrained path + skip-epochs)")
parser.add_argument("--model-parallel", type=int, help="tensor-parallel degree: shard vocab-dimension parameters over the mesh's 'model' axis (default 1 = pure data parallelism)")
parser.add_argument("--grad-accum-steps", type=int, help="accumulate gradients over N train steps before each optimizer update (effective batch = N * batch-size; the LR schedule counts optimizer updates)")
parser.add_argument("--fsdp", action="store_true", help="fully-sharded data parallelism: shard large parameters and optimizer state over the 'data' mesh axis (ZeRO-3)")
parser.add_argument("--coordinator-address", type=str, help="multi-process bootstrap: host:port of process 0's jax coordination service (requires --num-processes and --process-id)")
parser.add_argument("--num-processes", type=int, help="multi-process bootstrap: total number of jax processes in the job")
parser.add_argument("--process-id", type=int, help="multi-process bootstrap: this process's index in [0, num-processes)")
# fmt: on


def build_dataset_factory(cfg: TrainConfig, tokenizer, train: bool, shard=None):
    """Return a zero-arg callable producing the (features, tokens) stream.

    ``shard=(process_index, process_count)`` strides the dataset rows for
    multi-host runs (each host decodes only the rows its devices consume;
    see data/dataset.py).
    """
    from ..backend import on_accelerator
    from ..data import filter_example, get_dataset, get_tfrecord_dataset, slice_example
    from ..ops.features import delta_accelerate
    from ..ops.spec_augment import make_spec_augment

    import numpy as np

    data_config = cfg.data_config
    paths = cfg.train_dataset_paths if train else cfg.dev_dataset_paths
    raw_mode = cfg.on_device_frontend and not cfg.use_tfrecord
    feature_fn = None if raw_mode else data_config.make_audio_feature_fn("numpy")

    spec_augment_fn = None
    if train and data_config.spec_augment.enable:
        sa = data_config.spec_augment
        spec_augment_fn = make_spec_augment(
            v=data_config.frequency_dim, W=sa.W, F=sa.F, m_F=sa.m_F, T=sa.T, p=sa.p, m_T=sa.m_T
        )

    seed_holder = {"epoch": 0}

    def factory(skip: int = 0):
        import jax

        if cfg.use_tfrecord:
            stream = get_tfrecord_dataset(paths, skip=skip, shard=shard)
        else:
            # feature extraction runs inside the decode thread pool (numpy
            # FFT releases the GIL) instead of serializing in this generator
            raw = get_dataset(
                paths,
                data_config.file_format,
                data_config.sample_rate,
                tokenizer,
                shuffle=train and cfg.shuffle_buffer_size > 1,
                skip=skip,
                map_fn=None if raw_mode else (lambda a, t: (feature_fn(a), t)),
                shard=shard,
            )
            if raw_mode:
                # raw PCM to the device; features/SpecAugment/delta fuse into
                # the jitted step.  Length policies act on frame counts.
                fl, fs = data_config.frame_length, data_config.frame_step
                max_samples = (data_config.max_audio_length - 1) * fs + fl

                def _policy(stream):
                    for audio, tokens in stream:
                        frames = max((len(audio) - fl) // fs + 1, 0)
                        if cfg.max_over_policy == "filter":
                            if frames > data_config.max_audio_length or len(tokens) > data_config.max_token_length:
                                continue
                        elif cfg.max_over_policy == "slice":
                            audio = audio[:max_samples]
                            tokens = tokens[: data_config.max_token_length]
                        elif on_accelerator(cfg.device):
                            raise RuntimeError(f"You should set max-over-sequence-policy with {cfg.device}!")
                        yield audio, tokens

                seed_holder["epoch"] += 1
                return _policy(raw)
            stream = raw  # (features, tokens): map_fn already applied in-pool

        if spec_augment_fn is not None:
            key = jax.random.PRNGKey((cfg.seed or 0) * 1000 + seed_holder["epoch"])

            def _augment(stream):
                nonlocal key
                for audio, tokens in stream:
                    key, sub = jax.random.split(key)
                    yield np.asarray(spec_augment_fn(sub, audio)), tokens

            stream = _augment(stream)

        if data_config.use_delta_accelerate:
            stream = ((delta_accelerate(a), t) for a, t in stream)

        if cfg.max_over_policy == "filter":
            stream = filter_example(data_config.max_audio_length, data_config.max_token_length)(stream)
        elif cfg.max_over_policy == "slice":
            stream = slice_example(data_config.max_audio_length, data_config.max_token_length)(stream)
        elif on_accelerator(cfg.device):
            raise RuntimeError(f"You should set max-over-sequence-policy with {cfg.device}!")

        seed_holder["epoch"] += 1
        return stream

    return factory


def main(cfg: TrainConfig):
    """CLI entry.  Scopes the dw-conv backward-route hint (set at mesh
    creation below) to this run: in-process callers (the test suite, the
    auto-resume loop) must not inherit a mesh-specific gradient-path choice."""
    prev = os.environ.get("SRT_SPMD_SAFE_DWCONV")
    try:
        return _main_impl(cfg)
    finally:
        if prev is None:
            os.environ.pop("SRT_SPMD_SAFE_DWCONV", None)
        else:
            os.environ["SRT_SPMD_SAFE_DWCONV"] = prev


def _main_impl(cfg: TrainConfig):
    logger = get_logger("train")

    if cfg.seed:
        set_random_seed(cfg.seed)
        logger.info(f"[+] Set random seed to {cfg.seed}")

    # Copy config files into the output dir for reproducibility
    makedirs(cfg.output_path)
    with open_file(path_join(cfg.output_path, "train_configs.txt"), "w") as fout:
        for k, v in vars(cfg).items():
            if type(v) in (int, float, str):
                fout.write(f"{k:25}: {v}\n")
                logger.info(f"{k:25}: {v}")
        # the SRT_* env flags decide which compiled programs actually run —
        # they are config, so they belong in the reproducibility dump too
        from ..utils.srt_flags import effective_flags

        for k, v in effective_flags().items():
            fout.write(f"{k:25}: {v}\n")
    from ..utils import copy as copy_file

    copy_file(cfg.data_config_path, path_join(cfg.output_path, "data-config.yml"))
    copy_file(cfg.model_config_path, path_join(cfg.output_path, "model-config.yml"))

    from ..backend import on_accelerator, select_device
    from .common import build_variables, compute_dtype, count_params, create_model

    if cfg.coordinator_address:
        # Multi-controller bootstrap (analog of the reference strategy,
        # reference utils.py:130-156): connect to the coordination service
        # BEFORE the first backend touch so jax.devices() is the global
        # view.  On the CPU backend cross-process collectives ride gloo;
        # the platform must be pinned pre-init or an accelerator plugin
        # would claim the backend first.
        if cfg.num_processes is None or cfg.process_id is None:
            raise ValueError("--coordinator-address requires --num-processes and --process-id")
        import jax as _jax_boot

        if cfg.device.upper() == "CPU":
            os.environ.setdefault("JAX_CPU_COLLECTIVES_IMPLEMENTATION", "gloo")
            _jax_boot.config.update("jax_platforms", "cpu")
        _jax_boot.distributed.initialize(
            cfg.coordinator_address, cfg.num_processes, cfg.process_id
        )
        logger.info(
            f"[+] Distributed: process {cfg.process_id}/{cfg.num_processes}"
            f" via {cfg.coordinator_address}"
        )

    select_device(cfg.device)

    import jax
    import numpy as np
    import optax

    from ..data import SentencePieceTokenizer, padded_batch, shuffle_stream
    from ..models import LAS, Transducer
    from ..parallel import get_device_mesh, shard_batch, shard_params
    from ..train import (
        TrainState,
        linear_warmup_decay,
        make_eval_step,
        make_train_step,
        restore_weights,
        save_weights,
    )

    dtype = compute_dtype(cfg.mixed_precision, cfg.device)
    if cfg.mixed_precision:
        logger.info("[+] Use Mixed Precision (bfloat16)")

    # ---------------------------------------------------------------- dataset
    tokenizer = None
    if not cfg.use_tfrecord:
        logger.info(f"[+] Load Tokenizer from {cfg.sp_model_path}")
        with open_file(cfg.sp_model_path, "rb") as f:
            tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)

    # multi-host: each process decodes a disjoint row stride and feeds only
    # its addressable devices' share of the global batch
    from ..parallel import process_shard

    host_shard = process_shard()
    if host_shard is not None:
        idx, cnt = host_shard
        if cfg.batch_size % cnt or cfg.dev_batch_size % cnt:
            raise ValueError(
                f"batch sizes ({cfg.batch_size}/{cfg.dev_batch_size}) must divide "
                f"by the process count {cnt} for multi-host training"
            )
        if not cfg.steps_per_epoch:
            # without a fixed step count per epoch, hosts whose shards round
            # to different batch counts would deadlock the collectives
            raise ValueError("multi-host training requires --steps-per-epoch")
        logger.info(f"[+] Multi-host: process {idx}/{cnt}, dataset stride shard")

    logger.info(f"[+] Load train dataset from {cfg.train_dataset_paths}")
    train_factory = build_dataset_factory(cfg, tokenizer, train=True, shard=host_shard)
    logger.info(f"[+] Load dev dataset from {cfg.dev_dataset_paths}")
    # dev is NOT stride-sharded: every host reads the full dev set and takes
    # its own rows from each GLOBAL batch, so all hosts run the exact same
    # number of eval steps (a stride split can differ by one batch per host
    # and deadlock the eval collectives)
    dev_factory = build_dataset_factory(cfg, tokenizer, train=False)

    # ------------------------------------------------------------------ model
    logger.info("[+] Model Initialize")
    model = create_model(cfg.model_config, dtype)
    init_rng = jax.random.PRNGKey(cfg.seed or 0)
    variables = build_variables(model, cfg.model_config, cfg.data_config, init_rng)
    logger.info(f"[+] Parameters: {count_params(variables):,}")

    if cfg.auto_resume and not cfg.pretrained_model_path:
        from ..train import latest_checkpoint

        newest = latest_checkpoint(path_join(cfg.output_path, "models"))
        if newest:
            import re as _re

            cfg.pretrained_model_path = newest
            done = _re.search(r"model-(\d+)epoch", os.path.basename(newest))
            if done and not cfg.skip_epochs:
                cfg.skip_epochs = int(done.group(1))
            logger.info(f"[+] Auto-resume from {newest} (skip_epochs={cfg.skip_epochs})")

    if cfg.pretrained_model_path:
        logger.info("[+] Load weights of model")
        variables = dict(restore_weights(cfg.pretrained_model_path, variables))

    # -------------------------------------------------------------- optimizer
    accum = max(cfg.grad_accum_steps, 1)
    schedule = linear_warmup_decay(
        cfg.total_steps // accum,
        cfg.learning_rate,
        cfg.min_learning_rate,
        cfg.warmup_rate,
        cfg.warmup_steps,
        cfg.offset_steps // accum,
    )
    tx = optax.adam(schedule, eps=1e-7)  # Keras Adam epsilon
    if accum > 1:
        # average grads over N steps, apply once (effective batch N * B);
        # the inner optimizer (and so the LR schedule) steps per APPLY
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
        logger.info(f"[+] Gradient accumulation over {accum} steps")
    state = TrainState.create(variables, tx)

    # static shapes whenever lengths are bounded (policy set or accelerator);
    # otherwise per-batch dynamic padding (compiles per distinct shape)
    static = cfg.max_over_policy is not None or on_accelerator(cfg.device)

    # data-parallel degree: the largest device count dividing both batch sizes;
    # partial batches only exist in dynamic mode, so sharding requires static.
    # With --model-parallel, 'model'-axis devices come off the top first.
    import jax as _jax

    n_devices = len(_jax.devices())
    mp = cfg.model_parallel
    if n_devices % mp:
        raise ValueError(f"model_parallel={mp} does not divide the {n_devices} devices")
    if mp > 1 and not static:
        raise ValueError("model_parallel requires static shapes (set max-over-policy or --device GPU)")
    procs = _jax.process_count()
    if procs > 1 and not static:
        raise ValueError("multi-host training requires static shapes (set max-over-policy or --device GPU)")
    dp = 1
    if static:
        for d in range(min(n_devices // mp, cfg.batch_size), 0, -1):
            if cfg.batch_size % d == 0 and cfg.dev_batch_size % d == 0 and d % procs == 0:
                dp = d
                break
        if procs > 1 and dp % procs:
            raise ValueError(
                f"no data-parallel degree <= {n_devices // mp} divides the batch "
                f"sizes while spanning all {procs} processes"
            )
    mesh = get_device_mesh(data_parallel=dp, model_parallel=mp)
    multi_device = mesh.devices.size > 1
    if mp == 1:
        # this train run's mesh is pure data-parallel: the depthwise-conv
        # grouped-grad SPMD bug needs >1 nontrivial mesh axes, so keep the
        # fast autodiff backward (ops/dw_conv.py docstring; the
        # conservative auto gate can't see the mesh from inside the op)
        os.environ.setdefault("SRT_SPMD_SAFE_DWCONV", "0")
    if multi_device:
        logger.info(f"[+] SPMD over mesh {dict(zip(mesh.axis_names, mesh.devices.shape))}")
        if cfg.fsdp:
            logger.info("[+] FSDP: parameters + optimizer state sharded over 'data'")
        state = state.replace(
            params=shard_params(state.params, mesh, tensor_parallel=mp > 1, fsdp=cfg.fsdp),
            batch_stats=shard_params(state.batch_stats, mesh),
            opt_state=shard_params(state.opt_state, mesh, tensor_parallel=mp > 1, fsdp=cfg.fsdp),
        )

    is_las = isinstance(model, LAS)
    # models whose input is (features, decoder/prediction tokens): the
    # batcher ships ((audio, lengths), tokens[:-1]) / tokens[1:]
    token_conditioned = is_las or isinstance(model, Transducer)
    raw_mode = cfg.on_device_frontend and not cfg.use_tfrecord
    train_preprocess = eval_preprocess = None
    if raw_mode:
        from ..ops.frontend import make_batch_frontend

        logger.info("[+] Fused on-device audio frontend")
        train_frontend = make_batch_frontend(cfg.data_config, spec_augment=True)
        eval_frontend = make_batch_frontend(cfg.data_config, spec_augment=False)

        def _make_preprocess(front):
            # the frontend returns (features, frame_lengths); thread the true
            # lengths into the model so masks survive SpecAugment time masks
            def _pre(model_input, rng):
                if token_conditioned:
                    (audio, lengths), dec_in = model_input
                    return front(audio, lengths, rng), dec_in
                audio, lengths = model_input
                return front(audio, lengths, rng)

            return _pre

        train_preprocess = _make_preprocess(train_frontend)
        eval_preprocess = _make_preprocess(eval_frontend)

    train_step = make_train_step(
        model,
        model.get_loss_fn(),
        model.get_metrics(),
        needs_teacher_forcing_rng=is_las,
        preprocess=train_preprocess,
    )
    eval_step = make_eval_step(
        model, model.get_loss_fn(), model.get_metrics(), preprocess=eval_preprocess
    )

    # -------------------------------------------------------------- batching
    if raw_mode:
        fl, fs = cfg.data_config.frame_length, cfg.data_config.frame_step
        audio_pad = (cfg.data_config.max_audio_length - 1) * fs + fl if static else None
    else:
        audio_pad = cfg.audio_pad_length if static else None
    token_pad = cfg.token_pad_length if static else None

    # per-process (local) feed: each host batches its stride of the dataset
    # into batch_size/process_count rows; shard_batch assembles the global
    # array across hosts (parallel/mesh.py)
    local_batch_size = cfg.batch_size // procs
    local_dev_batch_size = cfg.dev_batch_size // procs

    skip_count = (cfg.steps_per_epoch or 0) * cfg.skip_epochs * cfg.batch_size
    if skip_count and cfg.train_dataset_size:
        # the repeated stream wraps around the dataset: row-level skip is
        # modulo the dataset size (reference dataset.repeat().skip semantics)
        skip_count %= cfg.train_dataset_size
    # sharded streams skip local rows (global stride / process count)
    skip_examples = {"count": skip_count // procs}

    def batch_iterator(factory, batch_size, train: bool, epoch: int = 0):
        # deterministic resume: fast-forward happens at tsv-row/record level
        # inside the factory — skipped examples are never decoded
        skip = skip_examples.pop("count", 0) if train else 0
        stream = factory(skip=skip) if skip else factory()
        if train and cfg.shuffle_buffer_size > 1:
            # reshuffle each epoch (tf.data reshuffle_each_iteration semantics)
            seed = None if cfg.seed is None else cfg.seed + epoch
            stream = shuffle_stream(stream, cfg.shuffle_buffer_size, seed=seed)
        if raw_mode:
            # keep per-example sample counts alongside the padded raw audio
            stream = ((a, np.array([len(a)], np.int32), t) for a, t in stream)

            def _triple_batches():
                batch = []
                for item in stream:
                    batch.append(item)
                    if len(batch) == batch_size:
                        yield batch
                        batch = []
                if batch:
                    yield batch

            from ..data.dataset import _stack_padded

            for batch in _triple_batches():
                a_len = audio_pad or max(a.shape[0] for a, _, _ in batch)
                t_len = token_pad or max(t.shape[0] for _, _, t in batch)
                rows = batch_size if static else len(batch)
                # single-alloc slice-assign stack: the np.pad-per-row form
                # is several times slower at these sizes
                audio = _stack_padded([a[:a_len] for a, _, _ in batch], a_len, np.float32, rows)
                tokens = _stack_padded([t[:t_len] for _, _, t in batch], t_len, np.int32, rows)
                lengths = np.zeros(rows, np.int32)
                lengths[: len(batch)] = [min(int(l[0]), a_len) for _, l, _ in batch]
                if token_conditioned:
                    yield ((audio, lengths), tokens[:, :-1]), tokens[:, 1:]
                else:
                    yield (audio, lengths), tokens
            return
        # under mixed precision the model's first op is astype(bfloat16):
        # stacking the batch directly into bf16 on host (numpy RTNE ==
        # device RTNE, bit-identical) halves host->device transfer bytes
        # and removes the on-device f32->bf16 convert.  SRT_HOST_BF16=0
        # ships f32.
        audio_dtype = (
            np.dtype(dtype)
            if dtype != np.float32 and os.environ.get("SRT_HOST_BF16", "1") == "1"
            else np.float32
        )
        if cfg.bucket_boundaries:
            from ..data.dataset import bucket_batch

            boundaries = [int(b) for b in str(cfg.bucket_boundaries).split(",")]
            # under SPMD, partial bucket remainders can't shard -> drop them
            batches = bucket_batch(
                stream,
                batch_size,
                boundaries,
                token_pad,
                drop_remainder=multi_device,
                over_boundary="clamp" if cfg.max_over_policy == "slice" else "drop",
                with_lengths=True,
                audio_dtype=audio_dtype,
            )
        else:
            batches = padded_batch(
                stream, batch_size, audio_pad, token_pad, pad_to_batch=static,
                with_lengths=True, audio_dtype=audio_dtype,
            )
        # true frame lengths ride along so the model masks exactly even when
        # SpecAugment time masks zero tail frames (the last-nonzero-frame
        # heuristic would truncate the encoder mask; models/las.py)
        for audio, lengths, tokens in batches:
            if token_conditioned:
                model_input, y_true = ((audio, lengths), tokens[:, :-1]), tokens[:, 1:]
            else:
                model_input, y_true = (audio, lengths), tokens
            yield model_input, y_true

    # --------------------------------------------------------------- training
    logger.info("[+] Start training")
    # multi-host: only process 0 writes TensorBoard events
    writer = _make_summary_writer(path_join(cfg.output_path, "logs")) if procs == 1 or _jax.process_index() == 0 else None
    rng = jax.random.PRNGKey((cfg.seed or 0) + 1)
    global_step = 0
    samples_seen = 0

    # with steps_per_epoch, epochs advance continuously through one repeated
    # stream (reference dataset.repeat() semantics, run/train.py:181-185);
    # rebuilding per epoch would retrain on the same first chunk forever
    persistent_train_iter = None
    if cfg.steps_per_epoch:
        from ..data.dataset import prefetch_stream, repeat_stream

        persistent_train_iter = prefetch_stream(
            batch_iterator(
                lambda skip=0: repeat_stream(train_factory, first_skip=skip),
                local_batch_size,
                train=True,
            ),
            size=2,
        )

    from ..train.metrics import AsyncMetricAccumulator

    def flush_tensorboard(pending):
        # one stacked fetch for all queued points (data long computed)
        if not pending:
            return
        import jax.numpy as jnp

        values = np.asarray(jnp.stack([v for _, v in pending]))
        for (step, _), value in zip(pending, values):
            writer.scalar("train/loss", float(value), step)
        pending.clear()

    profiling = False
    for epoch in range(cfg.skip_epochs, cfg.epochs):
        epoch_start = time.time()
        # device metrics fold into host totals `depth` steps late, so the
        # step chain never blocks on a same-step fetch (train/metrics.py)
        running = AsyncMetricAccumulator(depth=8)
        tb_pending = []
        steps = 0
        if persistent_train_iter is not None:
            train_iter = persistent_train_iter
        else:
            from ..data.dataset import prefetch_stream

            train_iter = prefetch_stream(
                batch_iterator(train_factory, local_batch_size, train=True, epoch=epoch), size=2
            )
        for model_input, y_true in train_iter:
            if cfg.profile_steps and epoch == cfg.skip_epochs and steps == 1 and not profiling:
                jax.profiler.start_trace(path_join(cfg.output_path, "profile"))
                profiling = True
                logger.info("[+] Started jax.profiler trace")
            if multi_device:
                model_input = shard_batch(model_input, mesh)
                y_true = shard_batch(y_true, mesh)
            rng, step_rng = jax.random.split(rng)
            state, metrics = train_step(state, model_input, y_true, step_rng)
            steps += 1
            global_step += 1
            if profiling and steps >= 1 + cfg.profile_steps:
                jax.block_until_ready(metrics["loss"])
                jax.profiler.stop_trace()
                profiling = False
                logger.info("[+] Saved profiler trace")
            running.push(metrics)
            if writer and global_step % cfg.tensorboard_update_freq == 0:
                tb_pending.append((global_step, metrics["loss"]))
            if steps % 100 == 0:
                logger.info(
                    f"{epoch + 1} epoch, {steps} step | "
                    + ", ".join(
                        f"{k}: {v / steps:.4f}" for k, v in running.totals().items() if not k.endswith("_count")
                    )
                )
                if writer:
                    flush_tensorboard(tb_pending)
            if cfg.steps_per_epoch and steps >= cfg.steps_per_epoch:
                break

        # ------------------------------------------------------------- validate
        if writer:
            flush_tensorboard(tb_pending)
        val_running = AsyncMetricAccumulator(depth=8)
        val_steps = 0
        from ..data.dataset import prefetch_stream as _prefetch

        for model_input, y_true in _prefetch(
            batch_iterator(dev_factory, cfg.dev_batch_size, train=False), size=2
        ):
            if host_shard is not None:
                # every host iterates the full dev set at the GLOBAL batch
                # size; slice out this host's rows of each batch
                lo = _jax.process_index() * local_dev_batch_size
                _slice = lambda x: x[lo : lo + local_dev_batch_size]
                model_input = jax.tree_util.tree_map(_slice, model_input)
                y_true = jax.tree_util.tree_map(_slice, y_true)
            if multi_device:
                model_input = shard_batch(model_input, mesh)
                y_true = shard_batch(y_true, mesh)
            val_running.push(eval_step(state, model_input, y_true))
            val_steps += 1
        val_metrics = val_running.totals()

        val_loss = val_metrics.get("loss", 0.0) / max(val_steps, 1)
        summary = {"val_loss": val_loss}
        if "accuracy_sum" in val_metrics:
            summary["val_accuracy"] = val_metrics["accuracy_sum"] / max(val_metrics["accuracy_count"], 1)
        logger.info(
            f"{epoch + 1} epoch | "
            + ", ".join(f"{k}: {v:.4f}" for k, v in summary.items())
            + f" | {time.time() - epoch_start:.1f}s"
        )
        if writer:
            for k, v in summary.items():
                writer.scalar(f"val/{k}", v, global_step)

        # ------------------------------------------------------------ checkpoint
        name = model.model_checkpoint_name.format(epoch=epoch + 1, **{
            "val_loss": val_loss,
            "val_accuracy": summary.get("val_accuracy", 0.0),
        })
        ckpt_path = path_join(cfg.output_path, "models", name)
        variables_out = state.variables
        if procs > 1:
            # gather TP-sharded leaves to fully-replicated host values (a
            # collective: every process participates), then only process 0
            # writes the checkpoint
            from jax.sharding import NamedSharding, PartitionSpec as _P

            variables_out = jax.tree_util.tree_map(
                lambda x: np.asarray(jax.device_put(x, NamedSharding(mesh, _P()))),
                variables_out,
            )
        # EVERY process enters the save: it ends in a cross-process
        # barrier and only the primary host writes files
        save_weights(ckpt_path, variables_out)
        if procs == 1 or _jax.process_index() == 0:
            logger.info(f"[+] Saved checkpoint to {ckpt_path}")

    if writer:
        writer.flush()


def _make_summary_writer(log_dir):
    """TensorBoard writer when available (optional dependency).

    gs:// log dirs stage through a local temp dir and upload on flush via
    the TF-free GCS client (reference wrote TB events straight to gs://
    through the Keras TensorBoard callback + gfile; run/train.py:205-207).
    """
    from ..utils.io import is_remote

    try:
        from flax.metrics.tensorboard import SummaryWriter
    except Exception:
        return None
    if not is_remote(log_dir):
        try:
            return SummaryWriter(log_dir)
        except Exception:
            return None

    import atexit
    import shutil
    import tempfile

    from ..utils.io import copy, path_join, walk_files

    local = tempfile.mkdtemp(prefix="srt-tb-")
    atexit.register(shutil.rmtree, local, ignore_errors=True)

    class _RemoteWriter:
        def __init__(self):
            self._w = SummaryWriter(local)
            self._uploaded = {}  # local path -> (size, mtime) at last upload

        def scalar(self, tag, value, step):
            self._w.scalar(tag, value, step)

        def flush(self):
            self._w.flush()
            # incremental upload: only files whose size/mtime changed
            for f in walk_files(local):
                stat = os.stat(f)
                sig = (stat.st_size, stat.st_mtime_ns)
                if self._uploaded.get(f) == sig:
                    continue
                copy(f, path_join(log_dir, f[len(local) + 1 :]))
                self._uploaded[f] = sig

        def close(self):
            self.flush()
            shutil.rmtree(local, ignore_errors=True)

    try:
        return _RemoteWriter()
    except Exception:
        return None


if __name__ == "__main__":
    from ..backend import setup_compile_cache
    from ..utils.yaml import load_yaml

    setup_compile_cache()
    config = vars(parser.parse_args())
    if "from_file" in config:
        with open(config.pop("from_file")) as f:
            config = {**load_yaml(f), **config}
    sys.exit(main(TrainConfig(**config)))
