"""Test config: run the tests on the CPU with a virtual 8-device mesh.

Sharding tests use XLA's host-platform device virtualization, so a
multi-device path runs here without several accelerators (SURVEY.md
section 4, point 4). The tests marked ``gpu`` need the card: run them
there with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``; an
explicit JAX_PLATFORMS is kept, and the default is the CPU.

Env vars are too late here (the jaxtyping pytest plugin imports jax before
conftest loads), but jax.config updates stick until a backend is actually
initialized, which no plugin does at import time.
"""

import os

# for any subprocesses we spawn
platforms = os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", platforms)
jax.config.update("jax_num_cpu_devices", 8)
