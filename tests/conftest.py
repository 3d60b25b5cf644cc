"""Test config: run JAX on a virtual 8-device CPU mesh so sharding tests
execute anywhere (shard_map over 8 virtual devices).  Must run before the
first `import jax`."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# persistent compilation cache makes test re-runs much faster
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import jax  # noqa: E402

from tiny_mp2v_dec_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# JAX_PLATFORMS may list an accelerator first; the tests run on the CPU
jax.config.update("jax_platforms", "cpu")
enable_compile_cache()
# Async CPU dispatch stays ON.  The intermittent corruption this flag once
# masked was root-caused: the JAX CPU client zero-copy ALIASES small
# aligned numpy arrays in jnp.asarray, so reusing a host staging buffer
# while an async computation still reads it corrupted inputs.  Staging
# slots are now guarded by the consuming computation's outputs
# (ops/recon.py), which fixes it under async dispatch.
