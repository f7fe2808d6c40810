"""Tests for runtime utilities (mirrors reference tests/test_utils.py)."""

from speech_recognition_tpu.utils import levenshtein_distance, path_join


def test_levenshtein_gold_cases():
    assert levenshtein_distance("abc", "abc", normalize=False) == 0
    assert levenshtein_distance("abc", "axc", normalize=False) == 1
    assert levenshtein_distance("kitten", "sitting", normalize=False) == 3
    assert levenshtein_distance("flaw", "lawn", normalize=False) == 2
    assert levenshtein_distance("", "", normalize=False) == 0
    assert levenshtein_distance("abc", "", normalize=False) == 3
    assert levenshtein_distance("", "abc", normalize=False) == 3


def test_levenshtein_korean_and_normalized():
    assert levenshtein_distance("안녕하세요", "안녕하세용", normalize=False) == 1
    assert levenshtein_distance("안녕하세요", "안녕하세용") == 1 / 5
    assert levenshtein_distance(["hello", "world"], ["hello", "word"], normalize=False) == 1
    assert levenshtein_distance(["hello", "world"], ["hello", "word"]) == 0.5


def test_levenshtein_matches_reference_dp():
    import numpy as np

    rng = np.random.default_rng(0)
    for _ in range(20):
        a = "".join(rng.choice(list("abcd"), rng.integers(0, 12)))
        b = "".join(rng.choice(list("abcd"), rng.integers(1, 12)))
        # O(mn) reference DP (reference utils.py:80-101)
        m, n = len(a) + 1, len(b) + 1
        d = np.zeros([m, n], np.int32)
        d[0] = np.arange(n)
        d[:, 0] = np.arange(m)
        for i in range(1, m):
            for j in range(1, n):
                diff = int(a[i - 1] != b[j - 1])
                d[i, j] = min(d[i - 1, j - 1] + diff, d[i - 1, j] + 1, d[i, j - 1] + 1)
        assert levenshtein_distance(a, b, normalize=False) == d[m - 1, n - 1]


def test_path_join():
    assert path_join("gs://bucket", "a", "b") == "gs://bucket/a/b"
    assert path_join("gs://bucket/", "a/") == "gs://bucket/a"
    assert path_join("/local", "a", "b").endswith("/local/a/b")


def test_flag_registry_covers_sources():
    """Every SRT_* flag referenced anywhere in the package must have a
    registry entry (and therefore a README row + a train_configs.txt dump
    line); a new undocumented flag fails here, and so does a stale entry."""
    import pathlib
    import re

    import speech_recognition_tpu
    from speech_recognition_tpu.utils.srt_flags import SRT_FLAG_DEFAULTS

    pkg = pathlib.Path(speech_recognition_tpu.__file__).parent
    used = set()
    for path in pkg.rglob("*.py"):
        used |= set(re.findall(r"SRT_[A-Z_0-9]+", path.read_text()))
    used.discard("SRT_FLAG_DEFAULTS")
    missing = used - set(SRT_FLAG_DEFAULTS)
    assert not missing, f"undocumented SRT_* flags: {sorted(missing)}"
    stale = set(SRT_FLAG_DEFAULTS) - used
    assert not stale, f"registry entries with no source use: {sorted(stale)}"


def test_matmul_stft_lowers_to_matmuls_at_shipped_frontend_params():
    """The default-on matmul STFT must lower to dot_generals, not an FFT,
    at the shipped frontend params (frame 320 / step 160 / fft 320)."""
    import jax
    import jax.numpy as jnp

    from speech_recognition_tpu.ops.features import power_stft

    jaxpr = str(
        jax.make_jaxpr(lambda a: power_stft(a, 320, 160, 320))(jax.ShapeDtypeStruct((2, 16000), jnp.float32))
    )
    assert "fft" not in jaxpr
    assert "dot_general" in jaxpr


def test_conformer_training_dropout_is_the_hash():
    """The Conformer's training dropout must be the counter-based hash (no
    threefry bit generation in the traced step) unless SRT_FAST_DROPOUT=0."""
    import os

    import jax
    import jax.numpy as jnp

    from speech_recognition_tpu.models.conformer import ConformerBlock

    assert os.environ.get("SRT_FAST_DROPOUT", "1") != "0"
    block = ConformerBlock(64, 2, 8, 2, 0.1, dtype=jnp.bfloat16)
    x = jnp.zeros((2, 16, 64), jnp.bfloat16)
    mask = jnp.ones((2, 16), bool)
    variables = block.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x, mask, True)
    jaxpr = str(
        jax.make_jaxpr(lambda v, x: block.apply(v, x, mask, True, rngs={"dropout": jax.random.PRNGKey(2)}))(
            variables, x
        )
    )
    assert "threefry" not in jaxpr
    assert "bernoulli" not in jaxpr
