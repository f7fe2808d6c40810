"""Convert the reference's TF2 checkpoints into this framework's pytrees.

The reference publishes trained weights as ``tf.train.Checkpoint(model)``
saves (v0.0.1 LAS-small release; also tests/data/model-checkpoints).  This
module reads them with the TF checkpoint reader (TensorFlow is required only
for conversion, never at runtime) and emits {'params', 'batch_stats'}
pytrees matching our module trees — possible because the recurrent
layers deliberately keep Keras parameter layout (ops/rnn.py).

Name mapping (reference attribute paths -> our module paths):
  listener/encoder_layers/N/{forward,backward}_rnn/cell/X
      -> listener/encoder_layerN/{forward,backward}_rnn/cell/X
  listener/projection/N -> listener/projectionN
  listener/batch_norm/N -> listener/batch_normalizationN (gamma->scale,
      beta->bias; moving stats -> batch_stats collection)
  attend_and_speller/decoder_layers/N/cell/X -> attend_and_speller/decoder_layerN/X
  attend_and_speller/embedding/embeddings -> .../embedding/embedding
  convolution/conv_layers/N -> convolution/convN
  recurrent/rnn_layers/N -> recurrent/reccurent_layerN
  recurrent/batch_norm/N -> recurrent/batch_normalizationN
"""

import re
from typing import Any, Dict

_SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def _map_name(name: str):
    """Map a TF checkpoint key -> (collection, our '/'-joined path)."""
    name = name[: -len(_SUFFIX)] if name.endswith(_SUFFIX) else name
    name = re.sub(r"encoder_layers/(\d+)", r"encoder_layer\1", name)
    name = re.sub(r"decoder_layers/(\d+)/cell", r"decoder_layer\1", name)
    name = re.sub(r"rnn_layers/(\d+)", r"reccurent_layer\1", name)
    name = re.sub(r"projection/(\d+)", r"projection\1", name)
    name = re.sub(r"batch_norm/(\d+)", r"batch_normalization\1", name)
    name = re.sub(r"conv_layers/(\d+)", r"conv\1", name)
    name = name.replace("embedding/embeddings", "embedding/embedding")

    collection = "params"
    if name.endswith("/gamma"):
        name = name[: -len("/gamma")] + "/scale"
    elif name.endswith("/beta"):
        name = name[: -len("/beta")] + "/bias"
    elif name.endswith("/moving_mean"):
        collection = "batch_stats"
        name = name[: -len("/moving_mean")] + "/mean"
    elif name.endswith("/moving_variance"):
        collection = "batch_stats"
        name = name[: -len("/moving_variance")] + "/var"
    return collection, name


def convert_tf_checkpoint(checkpoint_path: str) -> Dict[str, Any]:
    """Read a reference TF checkpoint -> {'params': ..., 'batch_stats': ...}."""
    try:
        from tensorflow.train import load_checkpoint  # type: ignore
    except Exception as e:  # pragma: no cover
        raise ImportError("TensorFlow is required to convert TF checkpoints") from e

    reader = load_checkpoint(checkpoint_path)
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key in reader.get_variable_to_shape_map():
        if key == "_CHECKPOINTABLE_OBJECT_GRAPH":
            continue
        # bookkeeping keys written by tf.train.Checkpoint.save / Keras
        # ModelCheckpoint (save_counter, optimizer slots) are not model
        # weights and would break the exact-structure restore template
        if key.startswith(("save_counter", "optimizer/", "optimizer_")):
            continue
        collection, path = _map_name(key)
        node = out[collection]
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = reader.get_tensor(key)
    if not out["batch_stats"]:
        out.pop("batch_stats")
    return out


def convert_and_save(checkpoint_path: str, output_path: str) -> None:
    """Convert a TF checkpoint and save it as a weights checkpoint (train/checkpoint.py)."""
    from ..train import save_weights

    save_weights(output_path, convert_tf_checkpoint(checkpoint_path))


# --------------------------------------------------------------- JAX -> TF
# The reverse direction: hand a model trained HERE back to the reference
# ecosystem (its restore path: reference run/evaluate.py:69-79 loads
# tf.train.Checkpoint attribute-path keys into the Keras model tree).
# Possible losslessly because the forward mapping is a bijection — the
# recurrent layers keep Keras parameter layout (ops/rnn.py) and every
# reference variable has exactly one home in our pytree.


def _unmap_name(collection: str, path: str) -> str:
    """Inverse of _map_name: our '/'-joined pytree path -> TF checkpoint key
    (without the .ATTRIBUTES suffix)."""
    name = path
    if collection == "batch_stats":
        if name.endswith("/mean"):
            name = name[: -len("/mean")] + "/moving_mean"
        elif name.endswith("/var"):
            name = name[: -len("/var")] + "/moving_variance"
    elif "batch_normalization" in name:
        # only batch-norm scale/bias become gamma/beta; dense biases stay
        if name.endswith("/scale"):
            name = name[: -len("/scale")] + "/gamma"
        elif name.endswith("/bias"):
            name = name[: -len("/bias")] + "/beta"
    name = name.replace("embedding/embedding", "embedding/embeddings")
    name = re.sub(r"encoder_layer(\d+)", r"encoder_layers/\1", name)
    name = re.sub(r"decoder_layer(\d+)", r"decoder_layers/\1/cell", name)
    name = re.sub(r"reccurent_layer(\d+)", r"rnn_layers/\1", name)
    name = re.sub(r"projection(\d+)", r"projection/\1", name)
    name = re.sub(r"batch_normalization(\d+)", r"batch_norm/\1", name)
    # only DS2's convolution module enumerates convs as a Keras list
    # (convolution/conv_layers/N); the LAS listener names its stem convs
    # conv1/conv2 directly (reference las.py Listener attributes)
    name = re.sub(r"convolution/conv(\d+)", r"convolution/conv_layers/\1", name)
    return name


def to_tf_checkpoint(variables: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten a {'params', 'batch_stats'} pytree into {tf_key: ndarray}
    with the reference models' attribute-path keys."""
    import numpy as np

    out: Dict[str, Any] = {}

    def walk(collection, node, prefix):
        for key, value in node.items():
            path = f"{prefix}/{key}" if prefix else key
            if isinstance(value, dict):
                walk(collection, value, path)
            else:
                out[_unmap_name(collection, path)] = np.asarray(value)

    for collection in ("params", "batch_stats"):
        walk(collection, variables.get(collection, {}), "")
    return out


def save_tf_checkpoint(variables: Dict[str, Any], output_path: str) -> str:
    """Write our weights pytree as a reference-format TF checkpoint.

    Builds a skeleton trackable tree whose attribute paths equal the
    reference model's (lists for the numeric components, ``tf.Variable``
    leaves) and writes it with ``tf.train.Checkpoint`` — the emitted keys
    are byte-identical in form to the reference's own Keras saves
    (``listener/encoder_layers/0/.../kernel/.ATTRIBUTES/VARIABLE_VALUE``),
    so the reference restore path accepts it.  Returns the written prefix.
    Round-trip law pinned in tests/test_reverse_checkpoint.py:
    convert_tf_checkpoint(save_tf_checkpoint(v)) == v bit-for-bit.
    """
    try:
        import tensorflow as tf  # type: ignore
    except Exception as e:  # pragma: no cover
        raise ImportError("TensorFlow is required to write TF checkpoints") from e

    root = tf.train.Checkpoint()

    def child(node, part, next_is_index):
        if part.isdigit():
            idx = int(part)
            while len(node) <= idx:
                node.append([] if next_is_index else tf.train.Checkpoint())
            return node[idx]
        existing = getattr(node, part, None)
        if existing is None:
            setattr(node, part, [] if next_is_index else tf.train.Checkpoint())
        return getattr(node, part)

    for key, value in to_tf_checkpoint(variables).items():
        parts = key.split("/")
        node = root
        for i, part in enumerate(parts[:-1]):
            node = child(node, part, parts[i + 1].isdigit())
        setattr(node, parts[-1], tf.Variable(value))
    return root.write(output_path)
