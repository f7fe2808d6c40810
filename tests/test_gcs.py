"""Native TF-free GCS client (utils/gcs.py) against a local fake GCS server.

Drives the REAL HTTP path — urllib against a threaded in-process server
implementing the GCS JSON API subset the client uses (download media,
media upload, objects.list, objects.get, copyTo) — via the standard
``STORAGE_EMULATOR_HOST`` mechanism.  This closes round-1 coverage item
#33: gs:// no longer requires tensorflow.io.gfile.
"""

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from speech_recognition_tpu.utils import gcs, io

# slow tier: excluded from the default run (pyproject addopts); run with
# `-m interferable` or `-m ""` — fake-GCS end-to-end CLI runs
pytestmark = pytest.mark.interferable


class FakeGCSHandler(BaseHTTPRequestHandler):
    store = {}  # (bucket, name) -> bytes
    updated = {}  # (bucket, name) -> RFC3339 timestamp (logical clock)
    clock = [0]

    @classmethod
    def _stamp(cls, key):
        cls.clock[0] += 1
        cls.updated[key] = f"2024-01-01T00:00:00.{cls.clock[0]:06d}Z"

    def log_message(self, *a):
        pass

    def _send(self, code, payload=b"", ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(parsed.query)
        parts = [urllib.parse.unquote(p) for p in parsed.path.split("/") if p]
        # /storage/v1/b/{bucket}/o            -> list
        # /storage/v1/b/{bucket}/o/{object}   -> metadata or ?alt=media
        if parts[:3] == ["storage", "v1", "b"] and len(parts) >= 5 and parts[4] == "o":
            bucket = parts[3]
            if len(parts) == 5:  # list
                prefix = qs.get("prefix", [""])[0]
                items = [
                    {"name": name, "updated": self.updated.get((b, name), "")}
                    for (b, name) in sorted(self.store)
                    if b == bucket and name.startswith(prefix)
                ]
                return self._send(200, json.dumps({"items": items}).encode())
            obj = "/".join(parts[5:])
            key = (bucket, obj)
            if key not in self.store:
                return self._send(404, b"{}")
            if qs.get("alt") == ["media"]:
                return self._send(200, self.store[key], "application/octet-stream")
            return self._send(200, json.dumps({"name": obj, "size": str(len(self.store[key]))}).encode())
        return self._send(404, b"{}")

    def do_POST(self):
        parsed = urllib.parse.urlparse(self.path)
        qs = urllib.parse.parse_qs(parsed.query)
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        parts = [urllib.parse.unquote(p) for p in parsed.path.split("/") if p]
        # /upload/storage/v1/b/{bucket}/o?uploadType=media&name=...
        if parts[:4] == ["upload", "storage", "v1", "b"]:
            bucket = parts[4]
            name = qs["name"][0]
            self.store[(bucket, name)] = body
            self._stamp((bucket, name))
            return self._send(200, json.dumps({"name": name}).encode())
        # /storage/v1/b/{sb}/o/{so}/copyTo/b/{db}/o/{do}
        if "copyTo" in parts:
            i = parts.index("copyTo")
            sb, so = parts[3], "/".join(parts[5:i])
            db, do = parts[i + 2], "/".join(parts[i + 4:])
            if (sb, so) not in self.store:
                return self._send(404, b"{}")
            self.store[(db, do)] = self.store[(sb, so)]
            self._stamp((db, do))
            return self._send(200, b"{}")
        return self._send(404, b"{}")


@pytest.fixture()
def fake_gcs(monkeypatch):
    FakeGCSHandler.store = {}
    FakeGCSHandler.updated = {}
    FakeGCSHandler.clock = [0]
    server = ThreadingHTTPServer(("127.0.0.1", 0), FakeGCSHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    monkeypatch.setenv("STORAGE_EMULATOR_HOST", f"http://127.0.0.1:{server.server_port}")
    yield FakeGCSHandler.store
    server.shutdown()


def test_write_read_roundtrip(fake_gcs):
    with io.open_file("gs://bkt/dir/x.txt", "w") as f:
        f.write("hello gcs")
    assert fake_gcs[("bkt", "dir/x.txt")] == b"hello gcs"
    with io.open_file("gs://bkt/dir/x.txt") as f:
        assert f.read() == "hello gcs"
    with io.open_file("gs://bkt/dir/x.txt", "rb") as f:
        assert f.read() == b"hello gcs"


def test_binary_and_append(fake_gcs):
    with io.open_file("gs://bkt/b.bin", "wb") as f:
        f.write(b"\x00\x01\xff")
    with io.open_file("gs://bkt/b.bin", "ab") as f:
        f.write(b"tail")
    assert fake_gcs[("bkt", "b.bin")] == b"\x00\x01\xfftail"


def test_glob_and_exists(fake_gcs):
    for name in ("data/a.tsv", "data/b.tsv", "data/deep/c.tsv", "other.txt"):
        gcs.write_bytes(f"gs://bkt/{name}", b"x")
    assert io.glob("gs://bkt/data/*.tsv") == [
        "gs://bkt/data/a.tsv",
        "gs://bkt/data/b.tsv",
    ]
    assert io.exists("gs://bkt/data/a.tsv")
    assert io.exists("gs://bkt/data")  # prefix counts as a directory
    assert not io.exists("gs://bkt/nope.txt")


def test_copy_remote_and_cross(fake_gcs, tmp_path):
    gcs.write_bytes("gs://bkt/src.txt", b"payload")
    io.copy("gs://bkt/src.txt", "gs://bkt/dst.txt")
    assert fake_gcs[("bkt", "dst.txt")] == b"payload"
    with pytest.raises(FileExistsError):
        io.copy("gs://bkt/src.txt", "gs://bkt/dst.txt", overwrite=False)
    # download / upload across the gs:// boundary
    local = tmp_path / "local.txt"
    io.copy("gs://bkt/src.txt", str(local))
    assert local.read_bytes() == b"payload"
    io.copy(str(local), "gs://bkt/up.txt")
    assert fake_gcs[("bkt", "up.txt")] == b"payload"


def test_missing_object_raises(fake_gcs):
    with pytest.raises(FileNotFoundError):
        gcs.read_bytes("gs://bkt/absent")


def test_walk_files_and_copy_tree(fake_gcs, tmp_path):
    src = tmp_path / "tree"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_text("A")
    (src / "sub" / "b.txt").write_text("B")
    io.copy_tree(str(src), "gs://bkt/up/tree")
    assert io.walk_files("gs://bkt/up/tree") == [
        "gs://bkt/up/tree/a.txt",
        "gs://bkt/up/tree/sub/b.txt",
    ]
    # round-trip back down
    dst = tmp_path / "down"
    io.copy_tree("gs://bkt/up/tree", str(dst))
    assert (dst / "a.txt").read_text() == "A"
    assert (dst / "sub" / "b.txt").read_text() == "B"
    # directory marker objects (gfile-parity makedirs) are not files
    gcs.makedirs("gs://bkt/up/tree/empty")
    assert "gs://bkt/up/tree/empty/" not in io.walk_files("gs://bkt/up/tree")


def test_checkpoint_save_restore_gcs(fake_gcs):
    """Weights checkpoints stage through a temp dir to/from gs://
    (parity: reference checkpointed to gs:// via gfile, run/train.py:208-212)."""
    import numpy as np

    from speech_recognition_tpu.train import restore_weights, save_weights

    variables = {
        "params": {"dense": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)}},
    }
    save_weights("gs://bkt/run/models/model-1epoch-0.1234loss_0.5678acc", variables)
    assert any(name.startswith("run/models/model-1epoch") for (_b, name) in fake_gcs)
    restored = restore_weights(
        "gs://bkt/run/models/model-1epoch-0.1234loss_0.5678acc", template=variables
    )
    np.testing.assert_array_equal(
        restored["params"]["dense"]["kernel"], variables["params"]["dense"]["kernel"]
    )


def test_latest_checkpoint_gcs(fake_gcs):
    from speech_recognition_tpu.train import latest_checkpoint

    assert latest_checkpoint("gs://bkt/none/models") is None
    # epoch-templated names win by epoch number regardless of write order
    gcs.write_bytes("gs://bkt/run/models/model-10epoch-0.2loss_0.5acc/ckpt", b"x")
    gcs.write_bytes("gs://bkt/run/models/model-2epoch-0.9loss_0.1acc/ckpt", b"x")
    assert (
        latest_checkpoint("gs://bkt/run/models")
        == "gs://bkt/run/models/model-10epoch-0.2loss_0.5acc"
    )
    # non-templated names fall back to the objects' updated timestamps
    gcs.write_bytes("gs://bkt/other/models/first/ckpt", b"x")
    gcs.write_bytes("gs://bkt/other/models/second/ckpt", b"x")
    assert latest_checkpoint("gs://bkt/other/models") == "gs://bkt/other/models/second"


def test_train_cli_checkpoints_to_gcs(fake_gcs, tmp_path):
    """Full e2e parity gate: ``train --output-path gs://...`` writes configs,
    TB events, and per-epoch checkpoints remotely; ``--auto-resume`` restores
    from the remote checkpoint; ``evaluate --model-path gs://...`` decodes
    with the remote weights (reference run/train.py:208-212, run/evaluate.py:78)."""
    from speech_recognition_tpu.configs import TrainConfig
    from speech_recognition_tpu.run.train import main as train_main, parser as train_parser
    from tests.const import SP_MODEL_LIBRI, TEST_DATA_DIR, TEST_LAS_CONFIG, WAV_DATASET_PATH
    import os

    out = "gs://bkt/exp1"
    args = [
        "--data-config", os.path.join(TEST_DATA_DIR, "mini_data_config.yml"),
        "--model-config", TEST_LAS_CONFIG,
        "--sp-model-path", SP_MODEL_LIBRI,
        "--train-dataset-paths", WAV_DATASET_PATH,
        "--dev-dataset-paths", WAV_DATASET_PATH,
        "--train-dataset-size", "2",
        "--output-path", out,
        "--epochs", "1",
        "--steps-per-epoch", "1",
        "--learning-rate", "1e-3",
        "--batch-size", "2",
        "--dev-batch-size", "2",
        "--shuffle-buffer-size", "1",
        "--max-over-policy", "slice",
        "--device", "CPU",
        "--seed", "42",
    ]
    train_main(TrainConfig(**vars(train_parser.parse_args(args))))
    names = {name for (_b, name) in fake_gcs}
    assert "exp1/train_configs.txt" in names
    assert "exp1/data-config.yml" in names
    assert any(n.startswith("exp1/models/model-1epoch") for n in names)
    assert any(n.startswith("exp1/logs/") for n in names)  # TB events uploaded

    # resume: epoch 2 restores the remote epoch-1 checkpoint and writes epoch 2
    idx = args.index("--epochs")
    args[idx + 1] = "2"
    train_main(TrainConfig(**vars(train_parser.parse_args(args + ["--auto-resume"]))))
    names = {name for (_b, name) in fake_gcs}
    assert any(n.startswith("exp1/models/model-2epoch") for n in names)

    # evaluate from the remote checkpoint, report to a remote tsv
    from speech_recognition_tpu.run.evaluate import main as eval_main, parser as eval_parser
    from speech_recognition_tpu.train import latest_checkpoint

    ckpt = latest_checkpoint("gs://bkt/exp1/models")
    assert ckpt and "model-2epoch" in ckpt
    eval_main(eval_parser.parse_args([
        "--data-config", os.path.join(TEST_DATA_DIR, "mini_data_config.yml"),
        "--model-config", TEST_LAS_CONFIG,
        "--dataset-paths", WAV_DATASET_PATH,
        "--model-path", ckpt,
        "--sp-model-path", SP_MODEL_LIBRI,
        "--output-path", "gs://bkt/exp1/eval.tsv",
        "--batch-size", "2",
        "--device", "CPU",
    ]))
    report = fake_gcs[("bkt", "exp1/eval.tsv")].decode()
    assert report.startswith("Prediction\tTarget")


def test_dataset_reads_from_gcs(fake_gcs):
    """End-to-end: the tsv reader resolves gs:// audio paths and the audio
    loader streams the bytes through the native client."""
    from speech_recognition_tpu.data.dataset import get_dataset, read_tsv_rows
    from tests.const import TEST_DATA_DIR
    import os

    wav = open(os.path.join(TEST_DATA_DIR, "audio_files", "test.wav"), "rb").read()
    gcs.write_bytes("gs://bkt/ds/audio/test.wav", wav)
    gcs.write_bytes(
        "gs://bkt/ds/data.tsv", b"FilePath\tText\naudio/test.wav\thello remote\n"
    )
    rows = read_tsv_rows("gs://bkt/ds/data.tsv")
    assert rows == [("gs://bkt/ds/audio/test.wav", "hello remote")]

    class Tok:
        def tokenize(self, text):
            return [ord(c) for c in text]

    pairs = list(get_dataset("gs://bkt/ds/data.tsv", "wav", 22050, Tok()))
    assert len(pairs) == 1
    audio, tokens = pairs[0]
    assert audio.ndim == 1 and audio.size > 1000
    assert bytes(tokens.tolist()).decode() == "hello remote"
