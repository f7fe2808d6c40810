"""The in-repo module core (speech_recognition_tpu/nn.py) against Flax Linen.

The model sources are written against the Linen subset that ``nn`` provides,
so the very same model code can be bound to Flax: a child process maps
``speech_recognition_tpu.nn`` to ``flax.linen`` before importing the models,
initializes every model family and runs it.  This process then checks that
``nn`` builds the identical variable trees (names, shapes, dtypes, and
initial values outside ``scan``, whose lifted rng streams differ) and that,
given Flax's variables, it computes the same outputs and the same updated
batch statistics.  Flax is a test-only dependency.
"""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.const import TEST_MODEL_CONFIG_DIR as MODEL_CONFIG_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (case name, model config file, field overrides)
CASES = [
    (os.path.splitext(os.path.basename(p))[0], os.path.basename(p), {})
    for p in sorted(glob.glob(os.path.join(MODEL_CONFIG_DIR, "*.yml")))
] + [
    ("conformer_scan_remat", "conformer_mini_for_test.yml", {"scan_layers": True, "remat": True}),
    ("conformer_remat", "conformer_mini_for_test.yml", {"remat": True}),
]

_SCRIPT = r"""
import sys, json
import flax.linen
sys.modules["speech_recognition_tpu.nn"] = flax.linen
sys.path.insert(0, ROOT)
exec(open(HELPERS).read())
run_cases(OUT, json.loads(CASES_JSON))
"""

_HELPERS = r'''
import os
import jax, jax.numpy as jnp, numpy as np

def _flatten(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = np.asarray(leaf)
    return out

def _inputs(model):
    from speech_recognition_tpu.models import LAS, Transducer
    rng = np.random.RandomState(0)
    audio = rng.randn(2, 40, 80, 1).astype(np.float32)
    audio[1, 30:] = 0.0
    tokens = rng.randint(1, 50, size=(2, 6)).astype(np.int32)
    tokens[1, 4:] = 0
    if isinstance(model, (LAS, Transducer)):
        return (jnp.asarray(audio), jnp.asarray(tokens))
    return jnp.asarray(audio)

def build(config_file, overrides):
    from speech_recognition_tpu.configs.model_config import get_model_config
    cfg = get_model_config(os.path.join(MODEL_CONFIG_DIR, config_file))
    model = cfg.create_model()
    fields = dict(overrides)
    if hasattr(model, "dropout"):
        fields["dropout"] = 0.0
    return model.clone(**fields)

def forward(model, variables):
    variables = {k: v for k, v in variables.items() if k in ("params", "batch_stats")}
    inp = _inputs(model)
    out = model.apply(variables, inp)
    train_out, updates = model.apply(
        variables, inp, training=True, rngs={"dropout": jax.random.PRNGKey(1)},
        mutable=["batch_stats", "aux_loss"],
    )
    return out, train_out, updates

def run_cases(out_dir, cases):
    for name, config_file, overrides in cases:
        model = build(config_file, overrides)
        variables = model.init({"params": jax.random.PRNGKey(0)}, _inputs(model))
        arrays = _flatten(variables, "vars/")
        out, train_out, updates = forward(model, variables)
        arrays.update(_flatten(out, "out/"))
        arrays.update(_flatten(train_out, "train_out/"))
        arrays.update(_flatten(updates, "updates/"))
        np.savez(os.path.join(out_dir, name + ".npz"), **arrays)
'''


def _unflatten(arrays, prefix):
    tree = {}
    for key, value in arrays.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def _namespace():
    ns = {"MODEL_CONFIG_DIR": MODEL_CONFIG_DIR}
    exec(_HELPERS, ns)
    return ns


@pytest.fixture(scope="module")
def flax_results(tmp_path_factory):
    pytest.importorskip("flax")
    import json

    out = tmp_path_factory.mktemp("flax_ref")
    helpers = out / "helpers.py"
    helpers.write_text(f"MODEL_CONFIG_DIR = {MODEL_CONFIG_DIR!r}\n" + _HELPERS)
    script = (
        f"ROOT = {ROOT!r}\nHELPERS = {str(helpers)!r}\nOUT = {str(out)!r}\n"
        f"CASES_JSON = {json.dumps(json.dumps(CASES))}\n" + _SCRIPT
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {name: dict(np.load(out / f"{name}.npz")) for name, _, _ in CASES}


@pytest.mark.parametrize("name,config_file,overrides", CASES, ids=[c[0] for c in CASES])
def test_variable_trees_match_flax(flax_results, name, config_file, overrides):
    ns = _namespace()
    model = ns["build"](config_file, overrides)
    variables = model.init({"params": jax.random.PRNGKey(0)}, ns["_inputs"](model))
    ours = ns["_flatten"](variables, "vars/")
    ref = {k: v for k, v in flax_results[name].items() if k.startswith("vars/")}
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key].shape == ref[key].shape, key
        assert ours[key].dtype == ref[key].dtype, key
        if not overrides.get("scan_layers"):
            # same rng derivation as Linen: identical initial values
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


@pytest.mark.parametrize("name,config_file,overrides", CASES, ids=[c[0] for c in CASES])
def test_outputs_match_flax_given_its_variables(flax_results, name, config_file, overrides):
    ns = _namespace()
    model = ns["build"](config_file, overrides)
    ref = flax_results[name]
    variables = _unflatten(ref, "vars/")
    out, train_out, updates = ns["forward"](model, variables)
    got = ns["_flatten"](out, "out/")
    got.update(ns["_flatten"](train_out, "train_out/"))
    got.update(ns["_flatten"](updates, "updates/"))
    expected = {k: v for k, v in ref.items() if not k.startswith("vars/")}
    assert sorted(got) == sorted(expected)
    for key, value in expected.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-6, err_msg=key)
