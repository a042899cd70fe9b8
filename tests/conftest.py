"""Test environment: virtual 8-device CPU mesh (SURVEY.md §4) + reference
binaries built on demand as the golden-stream fixture.

The suite runs on the CPU backend unless ``JAX_PLATFORMS`` names another
platform: ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/`` runs the card-only checks on a GPU."""
import os
import pathlib
import subprocess

# Simulate an 8-device mesh on CPU.  Backends initialize lazily, on first
# device use, so the flag and platform set here apply even when jax was
# imported before this file.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest

REFERENCE_DIR = pathlib.Path("/root/reference")
REFBIN_DIR = pathlib.Path("/tmp/refbin")

# --- the `quick` tier: fast host-only tests for the edit loop -------------
# Modules whose tests run without JAX compiles; individual tests measured
# > ~3 s on the 2-vCPU CI host are excluded so `pytest -m quick` stays
# under a minute while still covering format law, native codec parity,
# CLI surface, robustness and the NumPy oracle.
_QUICK_MODULES = {
    "test_format", "test_native", "test_cli", "test_robustness",
    "test_oracle", "test_host_parallel",
}
_QUICK_EXCLUDE = {
    "test_checksummed_frames", "test_engine_flag_host_parallel",
    "test_custom_block_sizes_roundtrip", "test_reference_decodes_ours",
    "test_level_flag_and_bundling", "test_dictionary_cli",
    "test_file_arguments", "test_profile_flag",
    "test_ring_decoder_matches_reference", "test_ring_decoder_small_out_chunk",
    "test_stdin_stdout_roundtrip", "test_multiblock_bit_exact_vs_reference",
    "test_legacy_restrictions", "test_block_size_flag", "test_checksum_flag",
    "test_verbose_progress_updates_per_block_buffered_engine",
    "test_bit_exact_modern", "test_bit_exact_legacy",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if (item.module.__name__ in _QUICK_MODULES
                and item.originalname not in _QUICK_EXCLUDE
                and "slow" not in item.keywords):
            item.add_marker(pytest.mark.quick)


def _build_reference() -> None:
    REFBIN_DIR.mkdir(parents=True, exist_ok=True)
    if not (REFBIN_DIR / "smallz4").exists():
        subprocess.run(
            ["g++", "-O2", "-s", str(REFERENCE_DIR / "smallz4.cpp"), "-o", str(REFBIN_DIR / "smallz4")],
            check=True, capture_output=True,
        )
    if not (REFBIN_DIR / "smallz4cat").exists():
        subprocess.run(
            ["gcc", "-O2", "-std=c99", "-s", str(REFERENCE_DIR / "smallz4cat.c"), "-o", str(REFBIN_DIR / "smallz4cat")],
            check=True, capture_output=True,
        )


class Reference:
    """Drive the reference binaries as compression/decompression oracles."""

    def __init__(self):
        _build_reference()

    def compress(self, data: bytes, level: int = 9, legacy: bool = False) -> bytes:
        args = [str(REFBIN_DIR / "smallz4"), f"-{level}"] + (["-l"] if legacy else [])
        res = subprocess.run(args, input=data, capture_output=True)
        assert res.returncode == 0, res.stderr
        return res.stdout

    def decompress(self, data: bytes, dict_path: str | None = None) -> bytes:
        # NB: the reference CLI requires -D *after* the filename (argv bug,
        # smallz4cat.c:408); piping via stdin avoids the filename entirely.
        args = [str(REFBIN_DIR / "smallz4cat"), "-"]
        if dict_path:
            args += ["-D", dict_path]
        res = subprocess.run(args, input=data, capture_output=True)
        assert res.returncode == 0, res.stderr
        return res.stdout


@pytest.fixture()
def gpu():
    """Skip unless JAX runs on a GPU (card-only checks, marker ``gpu``)."""
    from smallz4_tpu.utils import device

    if device.info()["platform"] != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")


@pytest.fixture(scope="session")
def reference() -> Reference:
    if not REFERENCE_DIR.exists():
        pytest.skip("reference sources not available")
    return Reference()


@pytest.fixture(scope="session")
def corpora() -> dict[str, bytes]:
    """Small differential-test corpus: compressible, incompressible, runs,
    structured, boundary sizes (SURVEY.md §4)."""
    rng = np.random.default_rng(1234)
    text = (REFERENCE_DIR / "smallz4.h").read_bytes() if REFERENCE_DIR.exists() else b"lorem ipsum " * 4000
    return {
        "empty": b"",
        "one": b"x",
        "tiny": b"abc",
        "just12": b"abcdabcdabcd",
        "hello": b"hello hello hello hello world",
        "text": text[:24000],
        "random": rng.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
        "run": b"a" * 12000,
        "run_mid": b"x" * 6000 + b"abcx" * 64 + b"y" * 2000,
        "struct": b"the quick brown fox jumps over the lazy dog. " * 200,
        "mixed": b"".join(
            rng.integers(0, 256, 80, dtype=np.uint8).tobytes() + b"needle" * 10
            for _ in range(40)
        ),
    }
