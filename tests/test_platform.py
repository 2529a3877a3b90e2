"""Host-side policy derived from the environment and the device: the
compile-cache directory, the device-memory budget, and the native
library's build stamp."""

import os
import shutil

import pytest

from shotgun_tpu.index import device_build
from shotgun_tpu.io import native
from shotgun_tpu.reference import KmerReference
from shotgun_tpu.utils import platform


@pytest.mark.parametrize("env,plat,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/cache/x"}, None, "/cache/x"),
    ({"JAX_COMPILATION_CACHE_DIR": "/cache/x", "JAX_PLATFORMS": "cpu"},
     None, "/cache/x"),
    ({}, None, os.path.join(platform._REPO, ".xla_cache")),
    ({"JAX_PLATFORMS": "cuda"}, None,
     os.path.join(platform._REPO, ".xla_cache")),
    ({"JAX_PLATFORMS": "cpu"}, None, None),
    ({}, "cpu", None),
])
def test_cache_dir_resolution(env, plat, want):
    assert platform.cache_dir_for(env, plat) == want


@pytest.mark.parametrize("stats,want", [
    (None, None),
    ({}, None),
    ({"bytes_in_use": 5}, None),
    ({"bytes_limit": 60 << 30, "bytes_in_use": 10 << 30},
     (50 << 30) - device_build.ALIGN_BATCH_MARGIN),
    ({"bytes_limit": 8 << 30}, (8 << 30) - device_build.ALIGN_BATCH_MARGIN),
])
def test_budget_from_memory_stats(stats, want):
    assert device_build.budget_from_stats(stats) == want


def test_device_build_bytes_grows_past_a_card():
    pad = KmerReference._pad_rows
    small = device_build.device_build_bytes(60_000_000, pad)
    big = device_build.device_build_bytes(2_000_000_000, pad)
    budget = device_build.budget_from_stats({"bytes_limit": 60 << 30})
    assert small < budget < big


def test_device_hash_table_declines_over_budget(monkeypatch):
    monkeypatch.setattr(device_build, "device_memory_budget", lambda: 1024)

    def boom(*a, **k):
        raise AssertionError("assembly must not start over budget")

    monkeypatch.setattr(device_build, "_hash_table_from_rows", boom)
    built = {"num_kmers": 1 << 20, "klo": _Rows(1 << 21)}
    assert device_build.device_hash_table(built) is None


class _Rows:
    def __init__(self, n):
        self.shape = (n,)


def test_device_hash_table_propagates_non_memory_errors(monkeypatch):
    import jax

    monkeypatch.setattr(device_build, "device_memory_budget", lambda: None)

    def fail(*a, **k):
        raise jax.errors.JaxRuntimeError("INTERNAL: compile failed")

    monkeypatch.setattr(device_build, "_hash_table_from_rows", fail)
    built = {"num_kmers": 100, "klo": _Rows(128), "khi": None, "sid": None,
             "gc": None}
    with pytest.raises(jax.errors.JaxRuntimeError, match="INTERNAL"):
        device_build.device_hash_table(built)


def test_build_stamp_tracks_machine_and_sources(tmp_path):
    for name in native._SOURCES:
        shutil.copy(os.path.join(native._NATIVE_DIR, name), tmp_path)
    a = native.build_stamp(str(tmp_path), "x86_64", "avx2 sse4_2")
    assert a == native.build_stamp(str(tmp_path), "x86_64", "avx2 sse4_2")
    assert a != native.build_stamp(str(tmp_path), "x86_64", "avx512f sse4_2")
    assert a != native.build_stamp(str(tmp_path), "aarch64", "avx2 sse4_2")
    with open(tmp_path / "kmer_build.cpp", "a") as fh:
        fh.write("\n// edit\n")
    assert a != native.build_stamp(str(tmp_path), "x86_64", "avx2 sse4_2")


def _native_copy(tmp_path, monkeypatch):
    for name in native._SOURCES:
        shutil.copy(os.path.join(native._NATIVE_DIR, name), tmp_path)
    lib = str(tmp_path / native._LIB_NAME)
    monkeypatch.setattr(native, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_LIB_PATH", lib)
    monkeypatch.setattr(native, "_STAMP_PATH", lib + ".stamp")
    return lib


def test_stamp_mismatch_rebuilds_library(tmp_path, monkeypatch):
    """A library built elsewhere (stale stamp) is rebuilt, not loaded."""
    lib = _native_copy(tmp_path, monkeypatch)
    with open(lib, "wb") as fh:
        fh.write(b"built for another machine")
    with open(lib + ".stamp", "w") as fh:
        fh.write("some other host")
    assert native.needs_rebuild(lib, lib + ".stamp",
                                native.build_stamp(str(tmp_path)))
    with open(tmp_path / "shotgun_io.cpp", "a") as fh:
        fh.write("\n// a source edit changes the stamp too\n")
    native._ensure_built()
    with open(lib, "rb") as fh:
        assert fh.read(4) == b"\x7fELF"
    assert not native.needs_rebuild(lib, lib + ".stamp",
                                    native.build_stamp(str(tmp_path)))


def test_matching_stamp_skips_build(tmp_path, monkeypatch):
    lib = _native_copy(tmp_path, monkeypatch)
    with open(lib, "wb") as fh:
        fh.write(b"already built here")
    with open(lib + ".stamp", "w") as fh:
        fh.write(native.build_stamp(str(tmp_path)))

    def no_make(*a, **k):
        raise AssertionError("make must not run")

    monkeypatch.setattr(native.subprocess, "run", no_make)
    native._ensure_built()
    assert open(lib, "rb").read() == b"already built here"
