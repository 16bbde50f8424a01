"""Run the tests on a virtual 8-device CPU mesh.

JAX picks its platform when it first initializes, so pytest re-execs
itself once with JAX_PLATFORMS=cpu and eight virtual host devices.  A run
that selects the `gpu` marker (`-m gpu`) keeps the machine's GPU instead.
"""
import os
import sys

import pytest

_N_DEVICES = "8"


def _selects_gpu(argv) -> bool:
    for i, arg in enumerate(argv):
        expr = (argv[i + 1] if arg == "-m" and i + 1 < len(argv)
                else arg[2:] if arg.startswith("-m") else "")
        if "gpu" in expr and "not gpu" not in expr:
            return True
    return False


def _needs_reexec() -> bool:
    if os.environ.get("FGOICP_TEST_REEXEC") == "1" or _selects_gpu(sys.argv):
        return False
    if os.environ.get("JAX_PLATFORMS", "") != "cpu":
        return True
    return "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", "")


if _needs_reexec():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        f" --xla_force_host_platform_device_count={_N_DEVICES}"
                        ).strip()
    env["FGOICP_TEST_REEXEC"] = "1"
    os.execve(sys.executable,
              [sys.executable, "-m", "pytest", *sys.argv[1:]], env)


@pytest.fixture()
def gpu():
    """The first GPU, for tests marked `gpu`; skips where there is none."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest tests -m gpu` on "
                    "a machine with one")
    return dev
