"""Checkpoint IO, local and gs://.

Replaces Keras ModelCheckpoint/load_weights (reference run/train.py:152-154,
208-212; run/evaluate.py:78).  Checkpoints are weights-only pytrees
{'params', 'batch_stats'} saved per epoch under templated directory names,
mirroring the reference's naming scheme.  Each save is one directory holding
``weights.npz``: every leaf under its '/'-joined tree path
(``params/listener/conv1/kernel``), so a checkpoint is readable with numpy
alone.  A separate converter (speech_recognition_tpu/compat/tf_checkpoint.py)
loads the reference's TF2 checkpoints into the same pytree layout.

gs:// parity: the reference trained with ``--output-path gs://...`` and
restored checkpoints remotely through tf.io.gfile (reference
run/train.py:208-212, run/evaluate.py:78, utils.py:116-120).  Here remote
checkpoints stage through a local temporary directory: save writes the tree
locally then uploads it file-by-file via utils.io (native GCS JSON-API
client, no TF); restore downloads the tree then restores locally.
``latest_checkpoint`` lists either os.listdir (local) or the object store
(remote), ordering by the epoch number embedded in the templated name
(``model-{epoch}epoch...``) with mtime/object-updated as the fallback, so
``--auto-resume`` works against both backends.
"""

import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import jax
import numpy as np

from ..utils import io as uio

_EPOCH_RX = re.compile(r"model-(\d+)epoch")
WEIGHTS_FILE = "weights.npz"


def _flatten(tree, prefix="", leaf=np.asarray) -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
        if "/" in str(key):
            raise ValueError(f"checkpoint keys may not contain '/': {key!r}")
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, path + "/", leaf))
        else:
            out[path] = leaf(value)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _write(directory: str, variables: Any) -> None:
    flat = _flatten(variables)
    # numpy's npz has no bfloat16: such leaves are stored as float32 and
    # cast back to the template's dtype on restore
    flat = {k: v.astype(np.float32) if v.dtype.kind == "V" or v.dtype.name == "bfloat16" else v
            for k, v in flat.items()}
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, WEIGHTS_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, os.path.join(directory, WEIGHTS_FILE))


def _barrier(name: str) -> None:
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


def save_weights(path: str, variables: Any) -> None:
    """Save {'params': ..., 'batch_stats': ...} to ``path`` (a directory,
    local or gs://).

    Multi-process: EVERY process must call this.  Only process 0 writes; the
    call ends in a cross-process barrier, so no process reads the checkpoint
    before it is complete.  Arrays must be host-addressable (the train CLI
    gathers sharded leaves first).
    """
    if jax.process_index() == 0:
        if uio.is_remote(path):
            staging = tempfile.mkdtemp(prefix="srt-ckpt-save-")
            try:
                local = os.path.join(staging, "ckpt")
                _write(local, variables)
                uio.copy_tree(local, path)
            finally:
                shutil.rmtree(staging, ignore_errors=True)
        else:
            _write(os.path.abspath(path), variables)
    _barrier("srt-save-weights")


def restore_weights(path: str, template: Optional[Any] = None) -> Any:
    """Restore a weights pytree from a local or gs:// directory.  With
    ``template``, the tree must have the template's structure and shapes,
    and leaves take the template's dtypes."""
    if uio.is_remote(path):
        staging = tempfile.mkdtemp(prefix="srt-ckpt-restore-")
        try:
            local = os.path.join(staging, "ckpt")
            uio.copy_tree(path, local)
            return restore_weights(local, template)
        finally:
            shutil.rmtree(staging, ignore_errors=True)
    with np.load(os.path.join(os.path.abspath(path), WEIGHTS_FILE)) as data:
        flat = {k: data[k] for k in data.files}
    if template is None:
        return _unflatten(flat)
    expected = _flatten(template, leaf=lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype))
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise ValueError(f"checkpoint {path} does not match the model: missing {missing[:5]}, unexpected {extra[:5]}")
    for key, ref in expected.items():
        if flat[key].shape != ref.shape:
            raise ValueError(f"checkpoint {path}: {key} has shape {flat[key].shape}, the model wants {ref.shape}")
        flat[key] = flat[key].astype(ref.dtype)
    return _unflatten(flat)


def _pick_latest(entries: List[tuple]) -> Optional[str]:
    """Pick the newest checkpoint among ``(path, timestamp)`` pairs.

    Templated names (``model-{N}epoch...``) order by epoch number — a
    lexicographic or mtime fallback would rank model-9epoch over
    model-10epoch after a clock skew.  A NON-templated entry that is
    strictly newer than the newest templated one still wins: a converted
    release checkpoint dropped into a resume directory must not be
    silently skipped in favor of an older templated save (round-4 advisor
    finding).  Entries with no usable timestamp carry ts 0.0 and can only
    win when nothing is templated."""
    if not entries:
        return None
    templated = [
        (int(m.group(1)), p, ts)
        for p, ts in entries
        for m in [_EPOCH_RX.search(os.path.basename(p))]
        if m
    ]
    if not templated:
        return max(entries, key=lambda e: (e[1], e[0]))[0]
    best_epoch, best_path, best_ts = max(templated)
    newer = [
        (ts, p)
        for p, ts in entries
        if not _EPOCH_RX.search(os.path.basename(p)) and ts > best_ts
    ]
    if newer:
        return max(newer)[1]
    return best_path


def _remote_latest(directory: str) -> Optional[str]:
    """List immediate child 'directories' of a gs:// prefix; newest by epoch
    number, falling back to the objects' ``updated`` timestamps."""
    from ..utils import gcs

    directory = directory.rstrip("/")
    bucket, prefix = gcs._split(directory)
    items = gcs.list_objects_meta(bucket, prefix + "/" if prefix else "")
    children = {}  # immediate child name -> newest `updated` below it
    strip = len(prefix) + 1 if prefix else 0
    for item in items:
        rel = item["name"][strip:]
        if "/" not in rel:
            continue  # plain file directly under the directory
        child = rel.split("/", 1)[0]
        ts = gcs.parse_rfc3339(item.get("updated", ""))
        children[child] = max(children.get(child, 0.0), ts)
    if not children:
        return None
    return _pick_latest([(f"{directory}/{c}", ts) for c, ts in children.items()])


def latest_checkpoint(directory: str) -> Optional[str]:
    """Return the newest checkpoint directory under ``directory`` (local or
    gs://), if any."""
    if uio.is_remote(directory):
        if uio._gcs_native() is not None:
            return _remote_latest(directory)
        gfile = uio._gfile()
        if not gfile.exists(directory):
            return None

        def _gfile_ts(p):
            try:
                return float(gfile.stat(p).mtime_nsec) / 1e9
            except Exception:
                return 0.0

        entries = [
            (path, _gfile_ts(path))
            for d in gfile.listdir(directory)
            for path in [uio.path_join(directory, d.rstrip("/"))]
            if gfile.isdir(path)
        ]
        return _pick_latest(entries)
    if not os.path.isdir(directory):
        return None
    entries = [
        (path, os.path.getmtime(path))
        for d in os.listdir(directory)
        for path in [os.path.join(directory, d)]
        if os.path.isdir(path)
    ]
    return _pick_latest(entries)
