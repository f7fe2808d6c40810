"""Host-side helpers of chip_smoke.py (the card phases run only on a GPU)."""

import json
import os
import shutil
import subprocess
import sys
import wave

import numpy as np

import chip_smoke
from speech_recognition_tpu.data import SentencePieceTokenizer, load_audio_file
from tests.const import REPO_ROOT, SP_MODEL_LIBRI


def test_phase_selection():
    assert chip_smoke.parse_args([]).phases == ["env", "train", "decode", "gpu_tests", "parity"]
    assert chip_smoke.parse_args(["--four-cards"]).phases == ["four_cards"]


def test_result_line_format():
    line = chip_smoke.result_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    assert json.loads(line) == {"ok": True, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_synthetic_dataset_is_seeded_and_loadable(tmp_path):
    tsv = chip_smoke.write_synthetic_dataset(str(tmp_path / "a"), "train", 3, seed=5, min_seconds=0.5, max_seconds=1.0)
    again = chip_smoke.write_synthetic_dataset(str(tmp_path / "b"), "train", 3, seed=5, min_seconds=0.5, max_seconds=1.0)
    with open(tsv) as f, open(again) as g:
        rows = f.read().splitlines()
        assert rows == g.read().splitlines()
    assert rows[0] == "FilePath\tText" and len(rows) == 4
    load = load_audio_file(16000, "flac", 16000)  # libri_config's format: wav is sniffed
    with open(SP_MODEL_LIBRI, "rb") as f:
        tokenizer = SentencePieceTokenizer(f.read(), add_bos=True, add_eos=True)
    for row in rows[1:]:
        path, text = row.split("\t")
        full = os.path.join(tmp_path / "a", path)
        with wave.open(full) as w:
            assert w.getframerate() == 16000 and w.getnchannels() == 1
            assert 0.5 <= w.getnframes() / 16000 <= 1.0
        audio = load(full)
        assert np.isfinite(audio).all() and np.abs(audio).max() > 0.1
        ids = tokenizer.tokenize(text)
        assert len(ids) > 3 and tokenizer.detokenize(ids[1:-1]).upper() == text


def test_fails_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=120, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
