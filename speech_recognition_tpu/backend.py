"""Device policy: the one place that decides whether the program runs on the
accelerator (an NVIDIA GPU through JAX's CUDA backend) or on the CPU, and
where compiled programs are cached.

- ``select_device("GPU")`` pins JAX to the GPU and raises when there is none;
  it never carries on on the CPU.  ``select_device("CPU")`` pins the CPU.
- ``on_accelerator(device)`` is the rule every shape/pipeline default keys on
  (static padding, the on-device frontend).
- ``setup_compile_cache()`` keeps JAX's persistent compilation cache where
  ``JAX_COMPILATION_CACHE_DIR`` says, or else at one fixed path inside the
  checkout, so later runs of the same programs skip compilation.
"""

import os
from typing import Optional

DEVICES = ("CPU", "GPU")
ACCELERATOR = "GPU"
# fixed, so the cache key (which includes the directory) is stable run to run
DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

# --device value -> (jax_platforms setting, jax.Device.platform)
_PLATFORMS = {"CPU": ("cpu", "cpu"), "GPU": ("cuda,cpu", "gpu")}


def select_device(device: str) -> None:
    """Pin JAX to ``device`` ("CPU" or "GPU"); raise RuntimeError when JAX
    finds no such device.  With "GPU" the CPU backend stays available for
    explicit use (``jax.devices("cpu")``); the default device is the GPU."""
    import jax

    device = device.upper()
    if device not in _PLATFORMS:
        raise ValueError(f"device {device} is invalid ({' | '.join(DEVICES)})")
    platforms, platform = _PLATFORMS[device]
    previous = jax.config.jax_platforms
    jax.config.update("jax_platforms", platforms)
    try:
        if jax.devices()[0].platform != platform:
            # another backend was initialized before this call (e.g. by an
            # embedding process): config updates alone don't re-resolve it
            from jax.extend import backend as jax_backend

            jax_backend.clear_backends()
            if jax.devices()[0].platform != platform:
                raise RuntimeError(f"the default JAX device is not a {device}")
    except RuntimeError as e:
        jax.config.update("jax_platforms", previous)
        raise RuntimeError(f"--device {device}: JAX finds no {device} ({e})") from e


def on_accelerator(device: Optional[str] = None) -> bool:
    """True when ``device`` (a --device value) names the accelerator, or,
    with no argument, when JAX's default backend is the GPU."""
    if device is not None:
        return device.upper() == ACCELERATOR
    import jax

    return jax.default_backend() == "gpu"


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory:
    ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself and nothing
    is changed), else ``DEFAULT_CACHE_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
