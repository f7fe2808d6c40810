"""Full-model numerical parity against the reference TF implementation.

The load-bearing evidence for the WER-parity north star: the reference's
shipped mini checkpoints (tests/data/model-checkpoints/{las,ds}.ckpt) are
loaded into BOTH the reference TF models (/root/reference/speech_recognition/
models/las.py:295-406, deepspeech2.py:122-202) and our converted models,
then both are run on the same inputs — logits must match and greedy decodes
must be identical, including on padded batches.
"""

import os
import sys

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax
import jax.numpy as jnp

REFERENCE_DIR = "/root/reference"
REF_CKPT_DIR = os.path.join(REFERENCE_DIR, "tests/data/model-checkpoints")

pytestmark = [
    # slow tier: excluded from the default run (pyproject addopts)
    pytest.mark.interferable,
    pytest.mark.skipif(
        not os.path.isdir(REF_CKPT_DIR), reason="reference checkpoints unavailable"
    ),
]

if REFERENCE_DIR not in sys.path:
    sys.path.insert(0, REFERENCE_DIR)


def _assign_tf_weights(root, ckpt_path):
    """Assign checkpoint tensors into the reference TF model by attribute path.

    The mini checkpoints were written by Keras 2-era tf.train.Checkpoint;
    under Keras 3 (this environment) the object-graph restore silently leaves
    variables unbound (expect_partial hides it; assert_existing_objects_matched
    reports 9 unmatched objects).  The saved keys are attribute paths of the
    reference code (e.g. listener/encoder_layers/0/forward_rnn/cell/kernel),
    so walk the attributes and assign directly.
    """
    reader = tf.train.load_checkpoint(ckpt_path)
    suffix = "/.ATTRIBUTES/VARIABLE_VALUE"
    n = 0
    for key in reader.get_variable_to_shape_map():
        if not key.endswith(suffix):
            continue
        parts = key[: -len(suffix)].split("/")
        obj = root
        for part in parts[:-1]:
            obj = obj[int(part)] if part.isdigit() else getattr(obj, part)
        getattr(obj, parts[-1]).assign(reader.get_tensor(key))
        n += 1
    assert n >= 20, f"only assigned {n} weights"


def _random_features(rng, batch, time, freq=80, feat=3, lengths=None):
    """Zero-padded random log-mel-like features."""
    audio = rng.standard_normal((batch, time, freq, feat)).astype(np.float32)
    if lengths is not None:
        for i, n in enumerate(lengths):
            audio[i, n:] = 0.0
    return audio


@pytest.fixture(scope="module")
def las_pair():
    """(reference TF LAS, our LAS + converted variables), mini checkpoint loaded."""
    from speech_recognition.models import LAS as RefLAS  # reference package

    from speech_recognition_tpu.compat import convert_tf_checkpoint
    from speech_recognition_tpu.models import LAS

    # teacher_forcing_rate=1.0 so the reference's eval-time Bernoulli draw
    # (las.py:366 — sampled even at training=False) is deterministic
    ref = RefLAS("lstm", 3000, 16, 16, 1, 1, 0.15, 1.0)
    audio = tf.zeros((1, 24, 80, 3))
    tokens = tf.zeros((1, 5), tf.int32)
    ref((audio, tokens), training=False)
    _assign_tf_weights(ref, os.path.join(REF_CKPT_DIR, "las.ckpt"))

    ours = LAS("lstm", 3000, 16, 16, 1, 1, 0.15, 1.0)
    variables = convert_tf_checkpoint(os.path.join(REF_CKPT_DIR, "las.ckpt"))
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    return ref, ours, variables


@pytest.fixture(scope="module")
def ds_pair():
    from speech_recognition.models import DeepSpeech2 as RefDS

    from speech_recognition_tpu.compat import convert_tf_checkpoint
    from speech_recognition_tpu.models import DeepSpeech2

    ref = RefDS(1, [32], [[41, 11]], [[2, 2]], "rnn", 7, 32, 0.1, 0.0, 120, 14)

    # The shipped _audio_mask is broken: its stride_complex expression
    # (deepspeech2.py:74, `tf.reduce_prod([time_stride, _ in self.strides])`)
    # evaluates to 0, producing an all-False mask and therefore CONSTANT
    # logits (verified empirically: std over time/batch == 0).  Patch it to
    # the intended semantics — collapse by the true time-stride product —
    # which is the parity target our DeepSpeech2 implements.
    def _fixed_audio_mask(audio):
        conv = ref.convolution
        seq = tf.shape(audio)[1]
        mask = tf.reduce_any(
            tf.reshape(audio, [tf.shape(audio)[0], seq, -1]) != conv.AUDIO_PAD_VALUE, axis=2
        )
        stride_prod = 1
        for (k, _), (s, _) in zip(conv.kernel_sizes, conv.strides):
            seq = (seq - (k - s)) // s
            stride_prod *= s
        mask = tf.reshape(mask[:, : seq * stride_prod], [tf.shape(audio)[0], seq, stride_prod])
        return tf.reduce_any(mask, axis=2)

    ref.convolution._audio_mask = _fixed_audio_mask
    ref(tf.zeros((1, 100, 80, 3)), training=False)
    _assign_tf_weights(ref, os.path.join(REF_CKPT_DIR, "ds.ckpt"))

    ours = DeepSpeech2(1, (32,), ((41, 11),), ((2, 2),), "rnn", 7, 32, 0.1, 0.0, 120, 14)
    variables = convert_tf_checkpoint(os.path.join(REF_CKPT_DIR, "ds.ckpt"))
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    return ref, ours, variables


def test_las_logits_parity(las_pair):
    ref, ours, variables = las_pair
    rng = np.random.default_rng(0)
    audio = _random_features(rng, 2, 24)
    tokens = np.array([[1, 17, 23, 512, 2], [1, 99, 2, 0, 0]], np.int32)

    ref_logits = ref((tf.constant(audio), tf.constant(tokens)), training=False).numpy()
    our_logits = np.asarray(ours.apply(variables, (jnp.asarray(audio), jnp.asarray(tokens))))

    assert our_logits.shape == ref_logits.shape
    # valid (non-pad-fed) positions must match to fp32 tolerance
    np.testing.assert_allclose(our_logits[0], ref_logits[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(our_logits[1, :3], ref_logits[1, :3], rtol=1e-4, atol=1e-4)


def test_las_logits_parity_padded_batch(las_pair):
    """Padding frames must not change valid logits, and both frameworks must
    agree on the padded batch."""
    ref, ours, variables = las_pair
    rng = np.random.default_rng(1)
    lengths = [24, 15]
    audio = _random_features(rng, 2, 24, lengths=lengths)
    tokens = np.array([[1, 300, 4, 2], [1, 7, 2, 0]], np.int32)

    ref_logits = ref((tf.constant(audio), tf.constant(tokens)), training=False).numpy()
    our_logits = np.asarray(ours.apply(variables, (jnp.asarray(audio), jnp.asarray(tokens))))
    np.testing.assert_allclose(our_logits[0], ref_logits[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(our_logits[1, :3], ref_logits[1, :3], rtol=1e-4, atol=1e-4)


def test_las_greedy_decode_parity(las_pair):
    from speech_recognition.search import LAS_Searcher as RefSearcher

    from speech_recognition_tpu.search import LASSearcher

    ref, ours, variables = las_pair
    rng = np.random.default_rng(2)
    audio = _random_features(rng, 2, 24, lengths=[24, 18])

    # keep the searcher alive across the tf.function call (it holds self weakly)
    ref_searcher = RefSearcher(ref, 8, bos_id=1, eos_id=2, pad_id=0)
    ref_tokens, ref_ppl = ref_searcher.greedy_search(tf.constant(audio))
    our_searcher = LASSearcher(ours, variables, 8, bos_id=1, eos_id=2, pad_id=0)
    our_tokens, our_ppl = our_searcher.greedy_search(jnp.asarray(audio))
    np.testing.assert_array_equal(np.asarray(our_tokens), ref_tokens.numpy())
    np.testing.assert_allclose(np.asarray(our_ppl), ref_ppl.numpy(), rtol=1e-3)


def test_las_beam_decode_parity(las_pair):
    """Beam search must agree with the reference on the TOP beam's tokens
    (same scoring: cumulative logP x ((1+len)/(1+beta))^alpha)."""
    from speech_recognition.search import LAS_Searcher as RefSearcher

    from speech_recognition_tpu.search import LASSearcher

    ref, ours, variables = las_pair
    rng = np.random.default_rng(6)
    audio = _random_features(rng, 2, 24, lengths=[24, 18])

    ref_searcher = RefSearcher(ref, 8, bos_id=1, eos_id=2, pad_id=0)
    ref_tokens, ref_ppl = ref_searcher.beam_search(tf.constant(audio), beam_size=3)
    our_searcher = LASSearcher(ours, variables, 8, bos_id=1, eos_id=2, pad_id=0)
    our_tokens, our_ppl = our_searcher.beam_search(jnp.asarray(audio), beam_size=3)

    np.testing.assert_array_equal(np.asarray(our_tokens)[:, 0, :], ref_tokens.numpy()[:, 0, :])
    np.testing.assert_allclose(np.asarray(our_ppl)[:, 0], ref_ppl.numpy()[:, 0], rtol=1e-3)


def test_ds_logits_parity(ds_pair):
    ref, ours, variables = ds_pair
    rng = np.random.default_rng(3)
    audio = _random_features(rng, 2, 100, lengths=[100, 64])

    ref_logits = ref(tf.constant(audio), training=False).numpy()
    our_logits = np.asarray(ours.apply(variables, jnp.asarray(audio)))
    assert our_logits.shape == ref_logits.shape
    np.testing.assert_allclose(our_logits, ref_logits, rtol=1e-4, atol=1e-4)


def test_las_fixture_decode_parity(las_pair):
    """End-to-end on REAL fixture audio: our audio decode + feature frontend +
    converted model + greedy search must produce the identical token sequence
    (and therefore identical WER/CER) as the reference TF model run on the
    same features — the closest dev-clean proxy this environment allows
    (reference run/evaluate.py:96-116; its CLI needs tensorflow_text/tfio,
    which are not installed)."""
    from speech_recognition.search import LAS_Searcher as RefSearcher

    from speech_recognition_tpu.configs import DataConfig
    from speech_recognition_tpu.data import get_dataset
    from speech_recognition_tpu.ops.features import delta_accelerate
    from speech_recognition_tpu.search import LASSearcher

    from .const import DEFAULT_LIBRI_CONFIG, WAV_DATASET_PATH

    ref, ours, variables = las_pair
    config = DataConfig.from_yaml(DEFAULT_LIBRI_CONFIG)
    feature_fn = config.make_audio_feature_fn("numpy")

    class _Tok:  # decode-only: tokens unused, but get_dataset tokenizes text
        def tokenize(self, text):
            return [1, 2]

    feats = [
        delta_accelerate(feature_fn(audio))
        for audio, _ in get_dataset(WAV_DATASET_PATH, config.file_format, config.sample_rate, _Tok())
    ]
    width = max(f.shape[0] for f in feats)
    batch = np.stack([np.pad(f, [(0, width - f.shape[0]), (0, 0), (0, 0)]) for f in feats])

    ref_searcher = RefSearcher(ref, 16, bos_id=1, eos_id=2, pad_id=0)
    ref_tokens, _ = ref_searcher.greedy_search(tf.constant(batch))
    our_searcher = LASSearcher(ours, variables, 16, bos_id=1, eos_id=2, pad_id=0)
    our_tokens, _ = our_searcher.greedy_search(jnp.asarray(batch))
    np.testing.assert_array_equal(np.asarray(our_tokens), ref_tokens.numpy())


def test_las_raw_frontend_decode_parity(las_pair):
    """The raw-PCM decode path (quantized raw batching + fused on-device
    frontend — the GPU tsv default in evaluate/inference) must produce the
    SAME tokens as the host-featurized path on real fixture audio with the
    converted reference weights (trained => peaked logits, so the ~1e-6
    matmul-STFT-vs-rfft feature deltas cannot flip the decode)."""
    from speech_recognition_tpu.configs import DataConfig
    from speech_recognition_tpu.data import get_dataset
    from speech_recognition_tpu.data.dataset import quantized_padded_raw_batch
    from speech_recognition_tpu.ops.features import delta_accelerate
    from speech_recognition_tpu.ops.frontend import make_batch_frontend
    from speech_recognition_tpu.search import LASSearcher

    from .const import DEFAULT_LIBRI_CONFIG, WAV_DATASET_PATH

    _, ours, variables = las_pair
    config = DataConfig.from_yaml(DEFAULT_LIBRI_CONFIG)

    class _Tok:
        def tokenize(self, text):
            return [1, 2]

    rows = list(get_dataset(WAV_DATASET_PATH, config.file_format, config.sample_rate, _Tok()))
    searcher = LASSearcher(ours, variables, 16, bos_id=1, eos_id=2, pad_id=0)

    # host path
    feature_fn = config.make_audio_feature_fn("numpy")
    feats = [delta_accelerate(feature_fn(a)) for a, _ in rows]
    width = max(f.shape[0] for f in feats)
    host_batch = np.stack([np.pad(f, [(0, width - f.shape[0]), (0, 0), (0, 0)]) for f in feats])
    host_tokens, _ = searcher.greedy_search(jnp.asarray(host_batch))

    # raw path (frame quantum chosen so both paths pad to the same T)
    ((raw, lengths), _tok, n_valid), = quantized_padded_raw_batch(
        iter(rows), len(rows), config.frame_length, config.frame_step, frame_quantum=width
    )
    frontend = make_batch_frontend(config, spec_augment=False)
    raw_feats, _ = frontend(jnp.asarray(raw), jnp.asarray(lengths))
    raw_tokens, _ = searcher.greedy_search(raw_feats)

    assert n_valid == len(rows)
    np.testing.assert_array_equal(np.asarray(raw_tokens), np.asarray(host_tokens))


def test_ds_greedy_decode_parity(ds_pair):
    from speech_recognition.search import DeepSpeechSearcher as RefSearcher

    from speech_recognition_tpu.search import DeepSpeechSearcher

    ref, ours, variables = ds_pair
    rng = np.random.default_rng(4)
    audio = _random_features(rng, 2, 100, lengths=[100, 72])

    ref_searcher = RefSearcher(ref, blank_index=14)
    ref_tokens, _ = ref_searcher.greedy_search(tf.constant(audio))
    our_searcher = DeepSpeechSearcher(ours, variables, blank_index=14)
    our_tokens, _ = our_searcher.greedy_search(jnp.asarray(audio))
    ref_tokens = ref_tokens.numpy()
    our_tokens = np.asarray(our_tokens)
    # pad to common width for comparison (decoders trim differently)
    width = max(ref_tokens.shape[1], our_tokens.shape[1])
    ref_p = np.zeros((ref_tokens.shape[0], width), ref_tokens.dtype)
    our_p = np.zeros((our_tokens.shape[0], width), our_tokens.dtype)
    ref_p[:, : ref_tokens.shape[1]] = ref_tokens
    our_p[:, : our_tokens.shape[1]] = our_tokens
    np.testing.assert_array_equal(our_p, ref_p)


def test_converter_skips_release_checkpoint_bookkeeping(tmp_path):
    """Release-style checkpoints (Keras ModelCheckpoint / tf.train.Checkpoint
    saves, reference run/train.py:208-212) carry ``save_counter`` and
    optimizer slot variables alongside the model weights.  The converter's
    skip list (compat/tf_checkpoint.py) must drop exactly those — untested
    by the mini fixtures, which contain neither.  A Keras-3 re-save cannot
    reproduce the Keras-2-era object graph (it silently drops the RNN/BN
    variables), so this rebuilds the fixture checkpoint key-for-key through
    trackable attribute chains and adds the bookkeeping keys the release
    artifact has.

    Runbook for the published v0.0.1 LAS-small artifact (absent here):
    download the release checkpoint, run
    ``python -m speech_recognition_tpu.compat.tf_checkpoint <ckpt> <out>``,
    load with train.restore_weights — the same flow this test covers.
    """
    from tensorflow.python.trackable.autotrackable import AutoTrackable

    from speech_recognition_tpu.compat import convert_tf_checkpoint

    src = os.path.join(REF_CKPT_DIR, "las.ckpt")
    reader = tf.train.load_checkpoint(src)
    suffix = "/.ATTRIBUTES/VARIABLE_VALUE"

    root = tf.train.Checkpoint()  # .save() writes save_counter itself
    keep_alive = []
    n_model_keys = 0
    for key in sorted(reader.get_variable_to_shape_map()):
        if not key.endswith(suffix):
            continue
        parts = key[: -len(suffix)].split("/")
        obj = root
        for part in parts[:-1]:
            # digit path components (list indices in the original graph) are
            # attached as attributes of the same name — checkpoint keys are
            # attribute names verbatim, so the key layout is preserved
            nxt = getattr(obj, part, None)
            if nxt is None:
                nxt = AutoTrackable()
                setattr(obj, part, nxt)
            obj = nxt
        var = tf.Variable(reader.get_tensor(key))
        keep_alive.append(var)
        setattr(obj, parts[-1], var)
        n_model_keys += 1
    assert n_model_keys >= 20

    opt = AutoTrackable()  # Adam slot layout: optimizer/m/<i>, optimizer/v/<i>
    for slot in ("m", "v"):
        holder = AutoTrackable()
        for i in range(2):
            setattr(holder, str(i), tf.Variable(tf.zeros([4])))
        setattr(opt, slot, holder)
    opt.iterations = tf.Variable(7, dtype=tf.int64)
    root.optimizer = opt
    path = root.save(str(tmp_path / "release" / "ck"))

    keys = set(tf.train.load_checkpoint(path).get_variable_to_shape_map())
    assert any(k.startswith("save_counter") for k in keys)
    assert any(k.startswith("optimizer/") for k in keys)

    converted = convert_tf_checkpoint(path)
    expected = convert_tf_checkpoint(src)
    flat_c = jax.tree_util.tree_flatten_with_path(converted)
    flat_e = jax.tree_util.tree_flatten_with_path(expected)
    assert jax.tree_util.tree_structure(converted) == jax.tree_util.tree_structure(expected)
    for (pc, vc), (pe, ve) in zip(flat_c[0], flat_e[0]):
        assert pc == pe
        np.testing.assert_array_equal(np.asarray(vc), np.asarray(ve), err_msg=str(pc))
