"""The in-repo YAML loader against PyYAML (a test-only dependency)."""

import glob
import os
import subprocess
import sys

import pytest

from speech_recognition_tpu.utils.yaml import YAMLError, load_yaml
from tests.const import CONFIG_DIR, REPO_ROOT, TEST_DATA_DIR

CONFIG_FILES = sorted(glob.glob(os.path.join(CONFIG_DIR, "*.yml")) + glob.glob(os.path.join(TEST_DATA_DIR, "**", "*.yml"), recursive=True))


@pytest.mark.parametrize("path", CONFIG_FILES, ids=[os.path.relpath(p, REPO_ROOT) for p in CONFIG_FILES])
def test_shipped_config_loads_as_pyyaml_does(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        expected = yaml.safe_load(f)
    with open(path) as f:
        assert load_yaml(f) == expected


def test_subset_matches_pyyaml():
    yaml = pytest.importorskip("yaml")
    text = """
# comment
a: 1
b: -2.5e-3   # trailing comment
c: 1e-5
d: [1, [2, 3], {x: y, z: null}]
e:
- 1
- two
f:
  - k: 1
    j: [true, False, yes, off]
  - k: ~
g: 'it''s # not a comment'
h: "tab\\there"
i: .5
j: .inf
k:
l: plain words here
"""
    assert load_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize(
    "text",
    ["a: &anchor 1", "a: *alias", "a: !!str 1", "a: |\n  block", "a: 1\n---\nb: 2", "a: [1, 2", "a: 0x1F", "a: 012",
     "a: 1:30", "a: 1\n    b: 2"],
)
def test_unsupported_yaml_fails_loudly(text):
    with pytest.raises(YAMLError):
        load_yaml(text)


def test_clis_import_without_pyyaml_flax_or_orbax():
    """The main path needs none of them: block them and import every CLI."""
    code = (
        "import sys\n"
        "for name in ('yaml', 'flax', 'orbax', 'orbax.checkpoint', 'tensorflow'):\n"
        "    sys.modules[name] = None\n"
        "import speech_recognition_tpu.run.train, speech_recognition_tpu.run.evaluate\n"
        "import speech_recognition_tpu.run.inference, speech_recognition_tpu.run.make_tfrecord\n"
        "import speech_recognition_tpu.search, speech_recognition_tpu.train\n"
        "from speech_recognition_tpu.configs import get_model_config\n"
        f"model = get_model_config({os.path.join(TEST_DATA_DIR, 'model-configs', 'las_mini_for_test.yml')!r}).create_model()\n"
        "import jax, jax.numpy as jnp\n"
        "v = model.init(jax.random.PRNGKey(0), (jnp.zeros((1, 16, 80, 1)), jnp.zeros((1, 3), jnp.int32)))\n"
        "print(sorted(v))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "['batch_stats', 'params']"
