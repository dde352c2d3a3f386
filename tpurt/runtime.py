"""Where the program runs: the Pallas execution mode, the device check of
the measuring entry points, and the persistent compile cache.

The fused kernel (tpurt.kernels.mega_regen) is compiled for an NVIDIA GPU
through Pallas' Triton route. On the CPU it runs in Pallas' interpret mode,
which is how the tests reach it; no other platform runs it.
"""

from __future__ import annotations

import os
import sys

import jax

# the checkout's own cache directory (listed in .gitignore): a fixed path,
# because the path is part of the cache key
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def pallas_interpret(platform: str | None = None) -> bool:
    """Whether a Pallas kernel runs interpreted on `platform` (default: the
    platform of jax.devices()[0]). Compiled on "gpu", interpreted on "cpu";
    any other platform raises — a kernel never silently falls back to the
    interpreter on an accelerator it was not written for."""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"the fused kernel compiles for 'gpu' and interprets on 'cpu'; "
        f"platform {platform!r} runs neither — use backend='xla'")


def require_gpu() -> jax.Device:
    """The first device, if it is a GPU; otherwise exit with status 2. For
    entry points whose output is a device measurement."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"error: needs a GPU, JAX found {dev.platform!r} "
              f"({dev.device_kind})", file=sys.stderr)
        sys.exit(2)
    return dev


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory:
    JAX_COMPILATION_CACHE_DIR when it is set (JAX reads it itself), else
    `.jax_cache/` at the root of the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", _REPO_CACHE)
    return _REPO_CACHE


def device_fields() -> dict:
    """platform / device_kind / device count of this process, for every
    result line a measuring entry point prints."""
    devs = jax.devices()
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind, "device_count": len(devs)}
