"""Registry of the `SRT_*` runtime tuning flags.

Every measured fast path in this framework is gated by an environment
flag (README "Runtime tuning flags" documents each).  These flags decide
which compiled program actually runs — they are configuration — so the
train CLI dumps their effective values into the run's ``train_configs.txt``
alongside the YAML-derived configs, mirroring how the reference copied all
of its configs into the output dir for reproducibility
(reference speech_recognition/run/train.py:53-60).

``tests/test_utils.py::test_flag_registry_covers_sources`` greps
the package for ``SRT_`` tokens and fails when a new flag is introduced
without a registry entry, so this table cannot silently go stale.
"""

import os
from typing import Dict

# flag -> shipped default ("" = unset / auto)
SRT_FLAG_DEFAULTS: Dict[str, str] = {
    # plain-JAX fast paths (default on)
    "SRT_FAST_DROPOUT": "1",
    "SRT_MATMUL_STFT": "1",
    # scan/VJP structure
    "SRT_DECODER_CUSTOM_VJP": "1",
    "SRT_LSTM_CUSTOM_VJP": "1",
    "SRT_DEC_UNROLL": "1",
    "SRT_RNN_UNROLL": "1",
    "SRT_RNN_REMAT": "0",
    # layout / experiment levers
    "SRT_BEAM_UNTILED": "1",
    "SRT_S2D_CONV": "0",
    "SRT_PDX_CONV": "0",
    "SRT_SPMD_SAFE_DWCONV": "",  # auto: safe when >1 device visible
    # host pipeline / IO
    "SRT_HOST_BF16": "1",
    "SRT_GCS_NATIVE": "1",
}


def effective_flags() -> Dict[str, str]:
    """Flag -> effective value (environment override or shipped default)."""
    return {
        name: os.environ.get(name, default)
        for name, default in sorted(SRT_FLAG_DEFAULTS.items())
    }
