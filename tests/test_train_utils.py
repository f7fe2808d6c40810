"""Train-layer unit tests: LR schedule parity, train/eval step behavior."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from speech_recognition_tpu.train import TrainState, linear_warmup_decay, make_eval_step, make_train_step


def test_schedule_warmup_then_decay_to_min():
    sched = linear_warmup_decay(1000, 1e-3, 1e-5, warmup_steps=100)
    # linear ramp over warmup (clamped below at min_lr, reference utils.py:35)
    np.testing.assert_allclose(float(sched(0)), 1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(sched(50)), 0.5e-3, rtol=1e-5)
    np.testing.assert_allclose(float(sched(100)), 1e-3, rtol=1e-5)
    # decays and clamps at min_lr (reference utils.py:11-35 & tests/test_utils.py)
    np.testing.assert_allclose(float(sched(2000)), 1e-5, rtol=1e-5)
    assert float(sched(999)) < float(sched(500))


def test_schedule_offset_resume():
    base = linear_warmup_decay(1000, 1e-3, 1e-5, warmup_steps=100)
    shifted = linear_warmup_decay(1000, 1e-3, 1e-5, warmup_steps=100, offset_steps=300)
    np.testing.assert_allclose(float(shifted(0)), float(base(300)), rtol=1e-6)
    np.testing.assert_allclose(float(shifted(200)), float(base(500)), rtol=1e-6)


def test_schedule_warmup_rate_default():
    sched = linear_warmup_decay(1000, 1e-3, 1e-5, warmup_rate=0.1)
    # warmup = total*rate + 1 = 101
    np.testing.assert_allclose(float(sched(101)), 1e-3, rtol=1e-2)


def test_train_step_reduces_loss():
    from speech_recognition_tpu import nn

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x, training=False):
            return nn.Dense(4)(x)

    model = Tiny()
    x = jax.random.normal(jax.random.PRNGKey(7), (8, 3))
    y = jnp.array([1, 2, 3, 0, 1, 2, 3, 1])
    variables = model.init(jax.random.PRNGKey(0), x)

    def loss_fn(y_true, logits):
        return optax.softmax_cross_entropy_with_integer_labels(logits, y_true).mean()

    state = TrainState.create(dict(variables), optax.adam(1e-1))
    step = make_train_step(model, loss_fn)
    losses = []
    for i in range(20):
        state, metrics = step(state, x, y, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.5
    assert int(state.step) == 20

    eval_step = make_eval_step(model, loss_fn)
    m = eval_step(state, x, y)
    np.testing.assert_allclose(float(m["loss"]), losses[-1], rtol=0.5)


def test_async_metric_accumulator_defers_and_sums():
    """AsyncMetricAccumulator folds device metrics `depth` steps late and
    drains to exact running totals (train/metrics.py)."""
    import jax.numpy as jnp

    from speech_recognition_tpu.train.metrics import AsyncMetricAccumulator

    acc = AsyncMetricAccumulator(depth=3)
    for i in range(10):
        acc.push({"loss": jnp.float32(i), "acc": jnp.float32(2 * i)})
        # never more than depth steps pending, and nothing folds early
        assert len(acc._pending) <= 3
        if i < 3:
            assert acc._totals == {}
    totals = acc.totals()
    assert not acc._pending
    assert totals["loss"] == sum(range(10))
    assert totals["acc"] == 2 * sum(range(10))
    # drain is idempotent; further pushes keep accumulating
    acc.push({"loss": jnp.float32(100.0), "acc": jnp.float32(0.0)})
    assert acc.totals()["loss"] == sum(range(10)) + 100.0


def test_latest_checkpoint_mixed_directory(tmp_path):
    """Epoch-templated names order by epoch number, but a NON-templated
    checkpoint that is strictly newer than the newest templated save must
    win (a converted release ckpt dropped into a resume dir; round-4
    advisor finding) — and must NOT win when it is older."""
    import os

    from speech_recognition_tpu.train import latest_checkpoint

    def mkdir_at(name, ts):
        d = tmp_path / name
        d.mkdir()
        os.utime(d, (ts, ts))
        return str(d)

    # epoch number beats mtime (model-10epoch is the OLDER directory)
    ten = mkdir_at("model-10epoch-0.2loss_0.5acc", 1000.0)
    mkdir_at("model-2epoch-0.9loss_0.1acc", 2000.0)
    assert latest_checkpoint(str(tmp_path)) == ten

    # an older foreign entry is ignored...
    mkdir_at("converted_release_old", 500.0)
    assert latest_checkpoint(str(tmp_path)) == ten

    # ...but a strictly newer one wins over the newest templated save
    fresh = mkdir_at("converted_release_new", 3000.0)
    assert latest_checkpoint(str(tmp_path)) == fresh

    # all-foreign directory: plain newest-mtime ordering
    only = tmp_path / "only_foreign"
    only.mkdir()
    a = only / "aaa"
    a.mkdir()
    os.utime(a, (100.0, 100.0))
    b = only / "zzz"
    b.mkdir()
    os.utime(b, (50.0, 50.0))
    assert latest_checkpoint(str(only)) == str(a)


def test_train_step_reports_the_gradient_global_norm():
    from speech_recognition_tpu import nn

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x, training=False):
            return nn.Dense(4)(x)

    model = Tiny()
    x = jax.random.normal(jax.random.PRNGKey(3), (8, 3))
    y = jnp.array([1, 2, 3, 0, 1, 2, 3, 1])
    variables = model.init(jax.random.PRNGKey(0), x)

    def loss_fn(y_true, logits):
        return optax.softmax_cross_entropy_with_integer_labels(logits, y_true).mean()

    grads = jax.grad(lambda p: loss_fn(y, model.apply({"params": p}, x)))(variables["params"])
    expected = np.sqrt(sum(float(np.sum(np.square(g))) for g in jax.tree_util.tree_leaves(grads)))
    state = TrainState.create(dict(variables), optax.sgd(0.1))
    _, metrics = make_train_step(model, loss_fn)(state, x, y, jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(metrics["grad_norm"]), expected, rtol=1e-5)
