"""LibriSpeech dev-clean / dev-other WER gate (reference README.md:18-21).

The reference's published LAS-small (release v0.0.1) scores WER 9.35 /
24.53 and CER 4.24 / 13.29 on dev-clean / dev-other.  Neither LibriSpeech
nor the release weights exist in the build environment, so this script is
the READY-TO-RUN gate for the day they do:

    python tools/dev_clean_wer.py \
        --checkpoint /path/to/release/las.ckpt \
        --dev-clean-tsv /data/libri/dev-clean.tsv \
        --dev-other-tsv /data/libri/dev-other.tsv \
        [--beam-size 8] [--device GPU]

It (1) converts the TF checkpoint via compat.tf_checkpoint when given a
TF prefix (a checkpoint directory passes through), (2) beam-decodes each tsv
through run.evaluate — the real CLI path, on-device frontend included —
(3) recomputes corpus WER/CER from the per-utterance report, and
(4) prints PASS/FAIL against the reference numbers (+0.5pt tolerance).

Dry run today (fixture tsv + the reference's MINI test checkpoint — full
convert->decode->score flow, gate comparison skipped):

    python tools/dev_clean_wer.py --dry-run
"""

import argparse
import csv
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# reference README.md:18-21
TARGETS = {
    "dev-clean": {"wer": 9.35, "cer": 4.24},
    "dev-other": {"wer": 24.53, "cer": 13.29},
}
TOLERANCE_PT = 0.5  # percentage points above the published number


def ensure_checkpoint_dir(checkpoint: str, staging: str) -> str:
    """Convert a TF checkpoint prefix to a checkpoint directory if needed (idempotent)."""
    if os.path.isdir(checkpoint):  # already a checkpoint directory
        return checkpoint
    from speech_recognition_tpu.compat.tf_checkpoint import convert_and_save

    out = os.path.join(staging, "converted")
    print(f"[gate] converting TF checkpoint {checkpoint} -> {out}", flush=True)
    convert_and_save(checkpoint, out)
    return out


def evaluate(tsv, ckpt, data_config, model_config, sp_model, beam, device, report):
    from speech_recognition_tpu.run.evaluate import main, parser

    args = parser.parse_args([
        "--data-config", data_config,
        "--model-config", model_config,
        "--dataset-paths", tsv,
        "--model-path", ckpt,
        "--sp-model-path", sp_model,
        "--output-path", report,
        "--batch-size", "32",
        "--beam-size", str(beam),
        "--device", device,
    ])
    rc = main(args)
    if rc != 0:
        raise RuntimeError(f"evaluate failed on {tsv} (exit {rc})")


def score(report):
    """Corpus WER/CER (%) from the per-utterance report tsv."""
    wers, cers = [], []
    with open(report) as f:
        rows = list(csv.reader(f, delimiter="\t"))
    for _pred, _target, wer, cer in rows[1:]:
        wers.append(float(wer))
        cers.append(float(cer))
    return 100 * sum(wers) / len(wers), 100 * sum(cers) / len(cers)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", help="release TF checkpoint prefix or checkpoint dir")
    ap.add_argument("--dev-clean-tsv")
    ap.add_argument("--dev-other-tsv")
    ap.add_argument("--data-config", default=os.path.join(REPO, "resources/configs/libri_config.yml"))
    ap.add_argument("--model-config", default=os.path.join(REPO, "resources/configs/las_small.yml"))
    ap.add_argument("--sp-model-path",
                    default=os.path.join(REPO, "resources/sp-models/sp_model_unigram_16K_libri.model"))
    ap.add_argument("--beam-size", type=int, default=8)
    ap.add_argument("--device", default="GPU")
    ap.add_argument("--output-dir", default=None, help="where reports go (default: temp)")
    ap.add_argument("--dry-run", action="store_true",
                    help="fixture tsv + reference mini checkpoint; no gate comparison")
    args = ap.parse_args()

    datasets = {}
    if args.dry_run:
        ref_mini = "/root/reference/tests/data/model-checkpoints/las.ckpt"
        args.checkpoint = args.checkpoint or ref_mini
        args.data_config = os.path.join(REPO, "tests/data/wer_gate_dryrun_data_config.yml")
        args.model_config = os.path.join(REPO, "tests/data/model-configs/las_ref_ckpt_mini.yml")
        args.device = "CPU"
        datasets["fixture"] = os.path.join(REPO, "tests/data/wav_dataset.tsv")
    else:
        if not args.checkpoint:
            ap.error("--checkpoint is required (or use --dry-run)")
        if args.dev_clean_tsv:
            datasets["dev-clean"] = args.dev_clean_tsv
        if args.dev_other_tsv:
            datasets["dev-other"] = args.dev_other_tsv
        if not datasets:
            ap.error("give --dev-clean-tsv and/or --dev-other-tsv (or --dry-run)")

    out_dir = args.output_dir or tempfile.mkdtemp(prefix="wer-gate-")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="wer-gate-ckpt-") as staging:
        ckpt = ensure_checkpoint_dir(args.checkpoint, staging)
        failures = 0
        for name, tsv in datasets.items():
            report = os.path.join(out_dir, f"{name}.tsv")
            print(f"[gate] decoding {name}: {tsv} (beam {args.beam_size})", flush=True)
            evaluate(tsv, ckpt, args.data_config, args.model_config,
                     args.sp_model_path, args.beam_size, args.device, report)
            wer, cer = score(report)
            target = TARGETS.get(name)
            if target is None:
                print(f"[gate] {name}: WER {wer:.2f}% CER {cer:.2f}% (no target — dry run OK)")
                continue
            wer_ok = wer <= target["wer"] + TOLERANCE_PT
            cer_ok = cer <= target["cer"] + TOLERANCE_PT
            status = "PASS" if (wer_ok and cer_ok) else "FAIL"
            failures += status == "FAIL"
            print(
                f"[gate] {name}: WER {wer:.2f}% (target {target['wer']}) "
                f"CER {cer:.2f}% (target {target['cer']}) -> {status}",
                flush=True,
            )
        print(f"[gate] reports in {out_dir}")
        return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
