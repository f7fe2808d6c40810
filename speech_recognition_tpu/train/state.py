"""Train state and jitted train/eval steps.

Replaces the Keras compile/fit machinery (reference run/train.py:156-217)
with explicit functional steps: forward (mutable batch_stats) -> loss ->
grad -> optax update, all inside one jitted, donated-buffer function.  Under
a multi-device mesh the same step runs SPMD: batch sharded over 'data',
gradient psums inserted automatically by XLA.
"""

import dataclasses
import functools
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import optax


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["step", "params", "batch_stats", "opt_state"],
    meta_fields=["tx"],
)
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Any
    batch_stats: Any
    opt_state: Any
    tx: optax.GradientTransformation

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    @classmethod
    def create(cls, variables, tx):
        params = variables["params"]
        return cls(
            step=jnp.zeros((), jnp.int32),
            params=params,
            batch_stats=variables.get("batch_stats", {}),
            opt_state=tx.init(params),
            tx=tx,
        )

    @property
    def variables(self):
        v = {"params": self.params}
        if self.batch_stats:
            v["batch_stats"] = self.batch_stats
        return v


def make_train_step(
    model,
    loss_fn: Callable,
    metric_fns=(),
    needs_teacher_forcing_rng: bool = False,
    preprocess: Optional[Callable] = None,
) -> Callable:
    """Build the jitted train step: (state, model_input, y_true, rng) -> (state, metrics).

    ``preprocess(model_input, rng) -> model_input`` runs inside the jit —
    used for the fused on-device audio frontend (raw PCM -> features fused
    into the step, no gradient through it).
    """

    # LAS can emit scan-native time-major [N,B,V] logits, skipping two
    # vocab-space transposes per step (fwd + VJP); the loss/metric fns are
    # layout-agnostic, so only y_true needs the (tiny) transpose.
    time_major = bool(getattr(model, "logits_time_major_supported", False))
    apply_kwargs = {"time_major_logits": True} if time_major else {}

    def train_step(state: TrainState, model_input, y_true, rng):
        rng_names = ["dropout", "frontend"] + (
            ["teacher_forcing"] if needs_teacher_forcing_rng else []
        )
        rngs = dict(zip(rng_names, jax.random.split(rng, len(rng_names))))
        front_rng = rngs.pop("frontend")
        if preprocess is not None:
            model_input = jax.lax.stop_gradient(preprocess(model_input, front_rng))
        if time_major:
            y_true = jnp.swapaxes(y_true, 0, 1)

        def compute_loss(params):
            variables = {"params": params}
            # 'aux_loss' collects regularizers sown inside the forward (the
            # MoE load-balancing loss, models/moe.py) — usually empty
            mutable = (["batch_stats"] if state.batch_stats else []) + ["aux_loss"]
            if state.batch_stats:
                variables["batch_stats"] = state.batch_stats
            (outputs, updates) = model.apply(
                variables, model_input, training=True, rngs=rngs, mutable=mutable,
                **apply_kwargs,
            )
            loss = loss_fn(y_true, outputs)
            for leaf in jax.tree_util.tree_leaves(updates.get("aux_loss", {})):
                loss = loss + jnp.sum(leaf)
            new_batch_stats = updates.get("batch_stats", state.batch_stats)
            return loss, (outputs, new_batch_stats)

        (loss, (outputs, new_batch_stats)), grads = jax.value_and_grad(compute_loss, has_aux=True)(
            state.params
        )
        updates, new_opt_state = state.tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        new_state = state.replace(
            step=state.step + 1,
            params=new_params,
            batch_stats=new_batch_stats,
            opt_state=new_opt_state,
        )
        metrics = {"loss": loss, "grad_norm": optax.global_norm(grads)}
        _add_metrics(metrics, metric_fns, y_true, outputs)
        return new_state, metrics

    return jax.jit(train_step, donate_argnums=(0,))


def _add_metrics(metrics, metric_fns, y_true, outputs):
    """Streaming metric sums ``{name}_sum`` / ``{name}_count``."""
    for name, fn in metric_fns:
        correct, count = fn(y_true, outputs)
        metrics[f"{name}_sum"] = correct
        metrics[f"{name}_count"] = count


def make_eval_step(model, loss_fn: Callable, metric_fns=(), preprocess: Optional[Callable] = None) -> Callable:
    """Build the jitted eval step: (state, model_input, y_true) -> metrics."""

    time_major = bool(getattr(model, "logits_time_major_supported", False))
    apply_kwargs = {"time_major_logits": True} if time_major else {}

    def eval_step(state: TrainState, model_input, y_true):
        if preprocess is not None:
            model_input = preprocess(model_input, None)
        if time_major:
            y_true = jnp.swapaxes(y_true, 0, 1)
        outputs = model.apply(state.variables, model_input, training=False, **apply_kwargs)
        loss = loss_fn(y_true, outputs)
        metrics = {"loss": loss}
        _add_metrics(metrics, metric_fns, y_true, outputs)
        return metrics

    return jax.jit(eval_step)
