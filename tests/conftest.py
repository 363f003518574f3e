"""Test env: the CPU with an 8-device virtual mesh, set before JAX starts.

Multi-device sharding paths are tested on this virtual mesh (the reference
has no distributed story at all — SURVEY.md §2.4; we test ours anyway).

The platform is pinned through jax.config, not only the environment, so
the suite runs on the CPU even on a machine with a GPU.  The tests marked
``gpu`` need the card: run them there with ``NCLT_TEST_PLATFORM=cuda,cpu``
(README, "Tests"); the ``gpu`` fixture skips them everywhere else.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms",
                  os.environ.get("NCLT_TEST_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """The first device, or a skip when it is not an NVIDIA GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run with NCLT_TEST_PLATFORM=cuda,cpu "
                    "python -m pytest -m gpu tests/")
    return dev
