"""Multi-host execution proof: two ``jax.distributed`` CPU processes run
the real CLI end-to-end and the host-0 dumpalign JSON byte-matches the
recorded single-process reference golden.

Covers SURVEY.md §5.8 (jax.distributed + cross-host merge): each process
gets 4 virtual CPU devices (8 global), reads shard over the 'data' axis of
the global mesh, per-genome counters and order keys merge with Gloo
collectives, and only process 0 prints.  The subprocesses strip the site's
accelerator hook (PYTHONPATH) because it pre-registers a PJRT backend that
conflicts with a fresh 2-process coordination service.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _case_args(name: str):
    with open(os.path.join(GOLDEN, "manifest.json")) as fh:
        manifest = json.load(fh)
    return [
        a.replace("data/", os.path.join(GOLDEN, "data") + "/")
        for a in manifest[name]["args"]
    ]


def _dist_env(port: int, pid: int, devices_per_proc: int = 4) -> dict:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)  # children import the package from REPO
    env.update(
        JAX_PLATFORMS="cpu",
        SHOTGUN_TPU_PLATFORM="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={devices_per_proc}",
        SHOTGUN_TPU_NPROCS="2",
        SHOTGUN_TPU_PROC_ID=str(pid),
        SHOTGUN_TPU_COORDINATOR=f"localhost:{port}",
    )
    return env


@pytest.mark.parametrize("case", ["plain", "combo"])
def test_two_process_dumpalign_matches_golden(case):
    args = _case_args(case)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "main.py"), *args,
             "--batch-size", "16"],
            env=_dist_env(port, pid), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
        outs.append(out.decode())

    # the CPU backend's Gloo transport prints connection banners to
    # stdout from multiple threads -- they can
    # interleave mid-line, so prefix filtering is unreliable.  The CLI
    # drains C stdio before printing, so the JSON is the final block.
    golden = open(os.path.join(GOLDEN, f"{case}.out")).read()
    assert outs[0].endswith(golden), outs[0][-2000:]
    assert "{" not in outs[1]  # non-primary host prints no summary


def test_local_read_slice_covers_input_exactly():
    """Per-host contiguous slices partition any read count, including
    uneven tails (round-1 verdict: untested interaction)."""
    from shotgun_tpu.parallel import distributed

    class _FakeJax:
        def __init__(self, nproc, pid):
            self.nproc, self.pid = nproc, pid

    real_count = distributed.jax.process_count
    real_index = distributed.jax.process_index
    try:
        for nproc in (1, 2, 3, 4):
            for total in (0, 1, 7, 8, 9, 100):
                slices = []
                for pid in range(nproc):
                    distributed.jax.process_count = lambda: nproc
                    distributed.jax.process_index = lambda p=pid: p
                    slices.append(distributed.local_read_slice(total))
                covered = []
                for s in slices:
                    covered.extend(range(*s.indices(total)))
                assert covered == list(range(total)), (nproc, total, slices)
    finally:
        distributed.jax.process_count = real_count
        distributed.jax.process_index = real_index
