"""Test configuration: force an 8-device virtual CPU mesh.

Multi-chip sharding logic (DP batch sharding, MOD table sharding, all-to-all
embedding exchange) is exercised on a virtual 8-device CPU platform, per the
strategy in SURVEY.md §4 ("multi-device-without-a-cluster"). jax may
already be imported when this runs, so the platform is also set through
jax.config before any backend initializes.
"""

import os

# XLA reads this at backend-init time (first computation), which has not
# happened yet even though jax is already imported.
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
