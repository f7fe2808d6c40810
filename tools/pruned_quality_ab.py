"""Dense-vs-pruned RNN-T training-quality A/B through the REAL CLIs
(VERDICT r4 #1): from-scratch training with both objectives, decoded-WER
endpoints via ``run.evaluate`` (greedy AND TSD beam).

Three legs, all driven end-to-end through ``run.train`` / ``run.evaluate``
subprocesses on CPU (JAX_PLATFORMS=cpu):

1. **Synthetic generalization** (the load-bearing leg): a 20-word "tone
   language" — each word is a fixed-frequency 0.2 s tone, an utterance is
   3-7 words — with a 48-utterance train set and a 16-utterance eval set of
   UNSEEN word sequences.  The model must learn the real audio->word
   mapping, so train WER AND held-out WER are meaningful, not just
   memorization.  Dense vs pruned (s_range 8 and 4) from the same seed.
2. **Libri fixture overfit**: tests/data/wav_dataset.tsv (2 rows, real
   speech) trained to its stable fixture WER with both objectives.
3. **Kspon fixture overfit**: tests/data/kspon_dataset.tsv, same protocol
   (Korean, 8K kspon sentencepiece vocab).

Writes ``tools/pruned_quality_ab.json`` (per-leg, per-objective: loss curve
tail, greedy/beam WER + CER) and prints a summary table.  PERF.md and the
transducer_small.yml default flip cite this artifact.

Run: python tools/pruned_quality_ab.py            (~20-40 min, CPU only)
     LEGS=synthetic python tools/pruned_quality_ab.py   (subset)
"""

import json
import math
import os
import re
import struct
import subprocess
import sys
import wave

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
TEST_DATA = os.path.join(ROOT, "tests", "data")
SP_LIBRI = os.path.join(ROOT, "resources", "sp-models", "sp_model_unigram_16K_libri.model")
SP_KSPON = os.path.join(ROOT, "resources", "sp-models", "sp_model_unigram_8K_kspon.model")

# uppercase: the libri sp model is trained on LibriSpeech transcripts,
# which are all-caps — lowercase words tokenize to UNK
WORDS = [
    "ALPHA", "BRAVO", "CHARLIE", "DELTA", "ECHO", "FOXTROT", "GOLF",
    "HOTEL", "INDIA", "JULIET", "KILO", "LIMA", "MIKE", "NOVEMBER",
    "OSCAR", "PAPA", "QUEBEC", "ROMEO", "SIERRA", "TANGO",
]
SAMPLE_RATE = 22050
TONE_S = 0.18
GAP_S = 0.02


def _write_wav(path, samples):
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        ints = [max(-32767, min(32767, int(s * 32767))) for s in samples]
        w.writeframes(struct.pack(f"<{len(ints)}h", *ints))


def _tone_utterance(words):
    """One utterance: per-word fixed-frequency tone with a short gap.
    Frequencies are log-spaced inside the mel band (80-7600 Hz)."""
    samples = []
    for word in words:
        idx = WORDS.index(word)
        freq = 250.0 * (1.16 ** idx)  # 250 Hz .. ~4.2 kHz
        n = int(TONE_S * SAMPLE_RATE)
        for i in range(n):
            env = min(1.0, i / 200.0, (n - i) / 200.0)  # click-free ramps
            samples.append(0.4 * env * math.sin(2 * math.pi * freq * i / SAMPLE_RATE))
        samples.extend([0.0] * int(GAP_S * SAMPLE_RATE))
    return samples


def build_tone_dataset(root):
    """48 train + 16 eval utterances of 3-7 words; eval sequences are
    disjoint from train (held-out generalization, not memorization)."""
    import random

    rng = random.Random(1234)
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    seen = set()

    def sample_sentence():
        while True:
            words = tuple(rng.choice(WORDS) for _ in range(rng.randint(3, 7)))
            if words not in seen:
                seen.add(words)
                return words

    def write_split(name, n):
        tsv = os.path.join(root, f"{name}.tsv")
        with open(tsv, "w") as f:
            f.write("FilePath\tText\n")
            for i in range(n):
                words = sample_sentence()
                rel = f"audio/{name}_{i:03d}.wav"
                _write_wav(os.path.join(root, rel), _tone_utterance(words))
                f.write(f"{rel}\t{' '.join(words)}\n")
        return tsv

    train_tsv = write_split("train", 48)
    eval_tsv = write_split("eval", 16)

    data_cfg = os.path.join(root, "data_config.yml")
    with open(os.path.join(TEST_DATA, "mini_data_config.yml")) as f:
        cfg = f.read()
    cfg = cfg.replace("max_audio_length: 150", "max_audio_length: 200")
    cfg = cfg.replace("max_token_length: 30", "max_token_length: 40")
    with open(data_cfg, "w") as f:
        f.write(cfg)
    return train_tsv, eval_tsv, data_cfg


def write_model_config(root, tag, pruned_range, encoder_dim=None):
    encoder_dim = encoder_dim or int(os.environ.get("AB_DIM", 48))
    """Mini transducer family config (tests/data/model-configs/
    transducer_mini_for_test.yml sizes, slightly widened so the tone task
    is comfortably learnable), with the objective knob under test."""
    path = os.path.join(root, f"transducer_{tag}.yml")
    lines = [
        "model_name: transducer",
        "vocab_size: 16000",
        f"encoder_dim: {encoder_dim}",
        "num_encoder_layers: 2",
        "num_attention_heads: 2",
        "conv_kernel_size: 7",
        "ffn_expansion: 2",
        "subsample_channels: [8, 8]",
        "pred_dim: 32",
        "num_pred_layers: 1",
        "joint_dim: 32",
        "dropout: 0.05",
        "blank_index: 0",
        "pad_index: 0",
    ]
    if pruned_range:
        lines.append(f"pruned_range: {pruned_range}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


# AB_DEVICE=GPU runs the train/evaluate subprocesses on the card (the dense
# 16K-vocab joint is seconds per step on a CPU; quality numbers are identical
# either way).  Subprocesses are sequential, one at a time on the card.
DEVICE = os.environ.get("AB_DEVICE", "CPU").upper()


def _run(args, log_path):
    env = dict(os.environ)
    if DEVICE == "CPU":
        env["JAX_PLATFORMS"] = "cpu"
    else:
        env.pop("JAX_PLATFORMS", None)
    with open(log_path, "w") as log:
        proc = subprocess.run(
            [sys.executable, "-m"] + args, cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT,
        )
    if proc.returncode != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"{args[1]} failed rc={proc.returncode}:\n{tail}")


def _parse_losses(log_path):
    """Per-epoch dev losses from the train CLI's end-of-epoch log lines
    (``N epoch | val_loss: X.XXXX | ...``; dev set == train set here, so
    this is the full-set loss curve in eval mode)."""
    losses = []
    rx = re.compile(r"\d+ epoch \| val_loss: ([0-9.]+)")
    with open(log_path) as f:
        for line in f:
            m = rx.search(line)
            if m:
                losses.append(float(m.group(1)))
    return losses


def _wer_cer(tsv_path):
    from speech_recognition_tpu.utils import levenshtein_distance

    wers, cers = [], []
    with open(tsv_path) as f:
        next(f)
        for line in f:
            pred, target = line.rstrip("\n").split("\t")[:2]
            wers.append(levenshtein_distance(target.split(), pred.split(), True))
            cers.append(levenshtein_distance(target, pred, True))
    return (
        round(sum(wers) / len(wers) * 100, 2),
        round(sum(cers) / len(cers) * 100, 2),
    )


def make_tfrecord(workdir, tsv, data_cfg, sp_model):
    """Precompute audio features once (run.make_tfrecord) so the many-epoch
    training runs don't redo the host frontend every epoch."""
    _run(
        [
            "speech_recognition_tpu.run.make_tfrecord",
            "--data-config", data_cfg,
            "--dataset-paths", tsv,
            "--output-dir", workdir,
            "--sp-model-path", sp_model,
        ],
        os.path.join(workdir, "make_tfrecord.log"),
    )
    return os.path.join(
        workdir, os.path.basename(tsv).rsplit(".", 1)[0] + ".tfrecord"
    )


def train_and_score(workdir, tag, model_cfg, data_cfg, sp_model, train_path,
                    eval_tsvs, n_rows, epochs, steps_per_epoch, batch):
    out = os.path.join(workdir, f"out_{tag}")
    tfrecord = train_path.endswith(".tfrecord")
    # resume: a finished training (final-epoch checkpoint present) is not
    # redone — lets a crashed/partial A/B run pick up where it stopped
    models_dir = os.path.join(out, "models")
    already = os.path.isdir(models_dir) and any(
        re.search(rf"model-{epochs}epoch", n) for n in os.listdir(models_dir)
    )
    if already:
        print(f"  [{tag}] training already complete, reusing {out}", flush=True)
    else:
        _run(
        [
            "speech_recognition_tpu.run.train",
            "--data-config", data_cfg,
            "--model-config", model_cfg,
            "--sp-model-path", sp_model,
            "--train-dataset-paths", train_path,
            "--dev-dataset-paths", train_path,
            *(["--use-tfrecord"] if tfrecord else []),
            "--train-dataset-size", str(n_rows),
            "--output-path", out,
            "--epochs", str(epochs),
            "--steps-per-epoch", str(steps_per_epoch),
            # near-constant LR: these are overfit-to-WER runs with a few
            # hundred updates — the CLI's default decay to 1e-5 starves the
            # late epochs where the transducer learns to emit
            "--learning-rate", os.environ.get("AB_LR", "3e-3"),
            "--min-learning-rate", os.environ.get("AB_LR", "3e-3"),
            "--batch-size", str(batch),
            "--dev-batch-size", str(batch),
            "--shuffle-buffer-size", str(n_rows),
            "--max-over-policy", "slice",
            "--device", DEVICE,
            "--seed", "42",
        ],
        os.path.join(workdir, f"train_{tag}.log"),
    )
    ckpts = sorted(
        os.listdir(os.path.join(out, "models")),
        key=lambda n: int(re.search(r"model-(\d+)epoch", n).group(1)),
    )
    ckpt = os.path.join(out, "models", ckpts[-1])
    losses = _parse_losses(os.path.join(workdir, f"train_{tag}.log"))

    result = {"loss_first": losses[0] if losses else None,
              "loss_last": losses[-1] if losses else None,
              "loss_curve_tail": losses[-8:], "epochs": epochs}
    for split_name, (tsv, modes) in eval_tsvs.items():
        for mode, beam in (("greedy", []), ("beam4", ["--beam-size", "4"])):
            if mode not in modes:
                continue
            out_tsv = os.path.join(workdir, f"decode_{tag}_{split_name}_{mode}.tsv")
            if os.path.exists(out_tsv):  # resume: re-score, don't re-decode
                wer, cer = _wer_cer(out_tsv)
                result[f"{split_name}_{mode}_wer"] = wer
                result[f"{split_name}_{mode}_cer"] = cer
                print(f"  [{tag}] {split_name}/{mode} (cached): WER {wer}% CER {cer}%", flush=True)
                continue
            _run(
                [
                    "speech_recognition_tpu.run.evaluate",
                    "--data-config", data_cfg,
                    "--model-config", model_cfg,
                    "--dataset-paths", tsv,
                    "--model-path", ckpt,
                    "--sp-model-path", sp_model,
                    "--output-path", out_tsv,
                    "--batch-size", str(batch),
                    "--device", DEVICE,
                    *beam,
                ],
                os.path.join(workdir, f"eval_{tag}_{split_name}_{mode}.log"),
            )
            wer, cer = _wer_cer(out_tsv)
            result[f"{split_name}_{mode}_wer"] = wer
            result[f"{split_name}_{mode}_cer"] = cer
            print(f"  [{tag}] {split_name}/{mode}: WER {wer}% CER {cer}%", flush=True)
    return result


def leg_synthetic(workdir):
    root = os.path.join(workdir, "tone")
    train_tsv, eval_tsv, data_cfg = build_tone_dataset(root)
    train_rec = make_tfrecord(root, train_tsv, data_cfg, SP_LIBRI)
    out = {}
    # 30 steps/epoch x 80 epochs = 2400 updates (the dense objective leaves
    # the all-blank optimum at ~1200 updates at dim 64); epoch boundaries
    # (checkpoint + dev eval) are the wall-clock cost on the card, so pack them
    epochs = int(os.environ.get("AB_EPOCHS", 80))
    for tag in os.environ.get("AB_TAGS", "dense,pruned8,pruned4").split(","):
        prange = {"dense": 0, "pruned8": 8, "pruned4": 4}[tag]
        cfg = write_model_config(root, tag, prange)
        print(f"[synthetic] training {tag}...", flush=True)
        out[tag] = train_and_score(
            root, tag, cfg, data_cfg, SP_LIBRI, train_rec,
            {"train": (train_tsv, ("greedy",)),
             "heldout": (eval_tsv, ("greedy", "beam4"))},
            n_rows=48, epochs=epochs, steps_per_epoch=30, batch=8,
        )
    return out


def leg_fixture(workdir, name, tsv, data_cfg, sp_model, epochs=None):
    # 2-row overfit at 1 step/epoch: RNN-T needs a few hundred updates to
    # leave the all-blank optimum (measured: the tone leg breaks out
    # between updates ~600-1200 at dim 64)
    epochs = epochs or int(os.environ.get("AB_FIXTURE_EPOCHS", 40))
    root = os.path.join(workdir, name)
    os.makedirs(root, exist_ok=True)
    # uppercase the transcripts: the libri sp model is trained on all-caps
    # LibriSpeech text, so the fixtures' mixed-case rows tokenize UNK-heavy
    # and decoded-WER endpoints become meaningless (Korean is case-free, so
    # this is a no-op for kspon)
    up_tsv = os.path.join(root, "train_upper.tsv")
    src_dir = os.path.dirname(os.path.abspath(tsv))
    with open(tsv) as fin, open(up_tsv, "w") as fout:
        fout.write(next(fin))
        # the shipped fixtures give the SAME audio file two different
        # transcripts — fine for parity tests, ILL-POSED for a WER A/B
        # (the loss plateaus at the split-probability floor and decode is
        # a coin flip; measured: dense AND pruned8 plateau at the identical
        # 0.1745).  Keep the first row, duplicated for an even batch.
        path_col, text = next(fin).rstrip("\n").split("\t", 1)
        # FilePath resolves relative to the tsv's directory — mirror the
        # audio tree into the leg dir instead of rewriting paths
        top = path_col.split("/", 1)[0]
        link = os.path.join(root, top)
        if not os.path.exists(link):
            os.symlink(os.path.join(src_dir, top), link)
        fout.write(f"{path_col}\t{text.upper()}\n")
        fout.write(f"{path_col}\t{text.upper()}\n")
    tsv = up_tsv
    train_rec = make_tfrecord(root, tsv, data_cfg, sp_model)
    out = {}
    for tag, prange in (("dense", 0), ("pruned8", 8), ("pruned4", 4)):
        cfg = write_model_config(root, tag, prange)
        print(f"[{name}] training {tag}...", flush=True)
        out[tag] = train_and_score(
            root, tag, cfg, data_cfg, sp_model, train_rec,
            {"train": (tsv, ("greedy", "beam4"))},
            # 150 steps/epoch x 40 epochs = 6000 updates: the 2-row REAL
            # speech rows leave the all-blank optimum much later than the
            # tone task (libri dense was still collapsed at 1800 updates)
            n_rows=2, epochs=epochs, steps_per_epoch=150, batch=2,
        )
    return out


def main():
    import tempfile

    legs = os.environ.get("LEGS", "synthetic,libri,kspon").split(",")
    # WORKDIR= reuses a previous run's directory (with the finished-training
    # skip above, a crashed run resumes instead of redoing its trainings)
    workdir = os.environ.get("WORKDIR") or tempfile.mkdtemp(prefix="pruned-ab-")
    print(f"workdir: {workdir}", flush=True)
    results = {}
    art = os.path.join(ROOT, "tools", "pruned_quality_ab.json")
    if os.path.exists(art):  # subset runs update the committed artifact
        with open(art) as f:
            results.update(json.load(f))
    if "synthetic" in legs:
        results["synthetic"] = leg_synthetic(workdir)
    if "libri" in legs:
        results["libri_fixture"] = leg_fixture(
            workdir, "libri", os.path.join(TEST_DATA, "wav_dataset.tsv"),
            os.path.join(TEST_DATA, "mini_data_config.yml"), SP_LIBRI,
        )
    if "kspon" in legs:
        results["kspon_fixture"] = leg_fixture(
            workdir, "kspon", os.path.join(TEST_DATA, "kspon_dataset.tsv"),
            os.path.join(TEST_DATA, "kspon_mini_data_config.yml"), SP_KSPON,
        )
    with open(art, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))
    print(f"wrote {art}", flush=True)


if __name__ == "__main__":
    main()
