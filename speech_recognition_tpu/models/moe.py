"""Mixture-of-experts layer for model trunks (beyond parity).

The reference's model families are dense (speech_recognition/models/
deepspeech2.py, las.py); this residual Switch-routed FFN
(``parallel/expert.py``) is the sparse-scaling option: capacity grows with
expert count at near-constant per-token FLOPs.  Off by default everywhere —
a config without ``moe_experts`` builds the exact parity architecture.

Dispatch is placement-aware at trace time: on a mesh whose ``model`` axis
has more than one device (and divides the expert count), experts shard over
that axis with all_to_all token travel (expert parallelism); otherwise the
dense single-device form runs — identical math either way
(tests/test_expert_parallel.py).
"""

import jax.numpy as jnp
import numpy as np

from .. import nn
from ..parallel import expert_parallel_moe, get_active_mesh, moe_ffn


class MoELayer(nn.Module):
    """Residual routed FFN: ``x + MoE(x)``.

    Padding tokens (``mask`` False) are never dispatched — they consume no
    expert capacity, their output is the identity residual, and they are
    excluded from the load-balancing statistics, so padded batches route
    real tokens exactly like unpadded ones.

    The Switch load-balancing auxiliary loss is sown into the ``aux_loss``
    collection (already scaled by ``aux_weight``); the train step collects
    and adds it to the objective (train/state.py).
    """

    n_experts: int
    hidden_dim: int
    k: int = 1
    capacity_factor: float = 1.25
    aux_weight: float = 1e-2
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jnp.ndarray, mask=None):
        d = x.shape[-1]
        E, H = self.n_experts, self.hidden_dim
        params = {
            "router": self.param(
                "router", nn.initializers.normal(1.0 / np.sqrt(d)), (d, E)
            ),
            "w_in": self.param(
                "w_in", nn.initializers.normal(1.0 / np.sqrt(d)), (E, d, H)
            ),
            "b_in": self.param("b_in", nn.initializers.zeros, (E, H)),
            "w_out": self.param(
                "w_out", nn.initializers.normal(1.0 / np.sqrt(H)), (E, H, d)
            ),
            "b_out": self.param("b_out", nn.initializers.zeros, (E, d)),
        }
        xc = x.astype(self.dtype)
        mesh = _ep_mesh_for(E, x.shape[0])
        if mesh is not None:
            y, aux = expert_parallel_moe(
                params, xc, mesh, expert_axis="model", data_axis="data",
                k=self.k, capacity_factor=self.capacity_factor, mask=mask,
            )
        else:
            y, aux = moe_ffn(
                params, xc, k=self.k, capacity_factor=self.capacity_factor, mask=mask
            )
        self.sow("aux_loss", "moe", self.aux_weight * aux)
        return x + y.astype(x.dtype)


def _ep_mesh_for(n_experts: int, n_rows: int):
    """The active mesh, when its 'model' axis can host the experts.

    The standard train mesh is ('data', 'model') (parallel/mesh.py); MoE
    reuses the tensor-parallel axis as the expert axis — on a pure-dp mesh
    (model == 1) the dense form is the right program anyway.
    """
    mesh = get_active_mesh()
    if mesh is None or "model" not in mesh.axis_names or "data" not in mesh.axis_names:
        return None
    ep = mesh.shape["model"]
    if ep <= 1 or n_experts % ep:
        return None
    if n_rows % (mesh.shape["data"] * ep):
        return None
    return mesh
