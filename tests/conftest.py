"""Test configuration: force the 8-device host-CPU backend before any jax
backend initializes (the suite needs no accelerator; the sharding tests
use a virtual 8-device CPU mesh).  Tests marked ``gpu`` need a CUDA
device and skip elsewhere; chip_smoke.py covers those paths on the card."""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
# JAX_PLATFORMS=cuda keeps the card visible for `pytest -m gpu` on a GPU
# machine; the CPU tests then still run on the host CPU devices
_KEEP_GPU = os.environ.get("JAX_PLATFORMS") == "cuda"
if not _KEEP_GPU:
    os.environ["SHOTGUN_TPU_PLATFORM"] = "cpu"

import jax  # noqa: E402

if not _KEEP_GPU:
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (run `JAX_PLATFORMS=cuda python -m "
        "pytest -m gpu tests/` on the card); skips elsewhere")


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none.  The
    decision is made here, at run time, never at import."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a CUDA GPU; chip_smoke.py covers this path on "
                    "the card")
    return gpus[0]


@pytest.fixture
def tiny_fasta() -> str:
    return (
        ">genomeA\n"
        "ACGTACGTACGTACGTCCCC\n"
        ">genomeB\n"
        "ACGTACGTACGTACGTGGGG\n"
        ">genomeC\n"
        "TTTTTTTTTTTTTTTTTTTT\n"
    )


@pytest.fixture
def tiny_fastq() -> str:
    return (
        "@read1\n"
        "ACGTACGTACGTACGTCCCC\n"
        "+\n"
        "IIIIIIIIIIIIIIIIIIII\n"
        "@read2\n"
        "TTTTTTTTTTTTTTTTTT\n"
        "+\n"
        "IIIIIIIIIIIIIIIIII\n"
    )
