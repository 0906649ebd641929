"""Test configuration: force an 8-device virtual CPU mesh before JAX loads.

SURVEY.md §4: "multi-node without a cluster" — sharded batch decode is
tested on CPU with XLA's host-platform device multiplexing
(xla_force_host_platform_device_count).

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX's first device is not a GPU.  They
run on a GPU machine with ``ALAC_TEST_GPU=1``, which leaves JAX's
platform alone:

    ALAC_TEST_GPU=1 python -m pytest tests/ -m gpu -o addopts=''
"""

import os

if not os.environ.get("ALAC_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xA1AC)


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, at run time, so every xdist worker collects the same
    tests."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


import jax  # noqa: E402

# The CPU suite runs without the persistent compilation cache: it saves
# nothing on a fresh checkout, and CLI tests would otherwise switch it on
# (cli.main calls utils.compile_cache) for the rest of a worker's run.
jax.config.update("jax_enable_compilation_cache", False)
# Never destroy JIT'd CPU executables mid-process (no `_clear_cache()`):
# a late large compile in a long-lived worker has crashed XLA:CPU's
# unwinder on stale registered frames of freed code.


# ---------------------------------------------------------------------------
# Fast/slow test tiers: `pytest -m "not slow"` is the inner-loop tier.
# Membership is centralized here (measured from a full --durations run,
# cutoff ~45 s/test) instead of scattering decorators: the list is data,
# and re-tiering after a perf change is a one-place edit.  A plain
# `pytest tests/` runs both tiers.
# ---------------------------------------------------------------------------

_SLOW_BASES = {
    "tests/test_handcrafted.py::TestExtraBitsDomains::test_16bit_stereo_ub2",
    "tests/test_handcrafted.py::TestExtraBitsDomains::test_24bit_mono",
    "tests/test_handcrafted.py::TestExtraBitsDomains::test_24bit_stereo",
    "tests/test_fuzz_differential.py::test_randomized_differential_fuzz",
    "tests/test_aux.py::TestBenchHarness::test_run_e2e_benchmark_smoke",
    "tests/test_aux.py::TestBenchHarness::test_run_benchmark_smoke",
    "tests/test_encoder_tpu.py::test_device_pack_randomized_sweep",
    "tests/test_handcrafted.py::TestPredictionHeaderDomains::test_quant15_high_order",
    "tests/test_handcrafted.py::TestPredictionHeaderDomains::test_quant0",
    "tests/test_pipeline_plan.py::TestDecodeBlobMixedOrders::test_output_order_restored_and_bit_exact",
    "tests/test_pipeline_plan.py::TestDecodeBlobMixedOrders::test_device_pack_ab_bit_exact",
    "tests/test_device_parity.py::test_forced_fused_pipeline_cpu",
    "tests/test_distributed.py::test_multiprocess_decode_bit_exact",
    "tests/test_sharding.py::test_graft_dryrun_multichip",
    "tests/test_handcrafted.py::TestRiceParameterDomains::test_ricemodifier0_zero_history",
    "tests/test_handcrafted.py::TestRiceParameterDomains::test_ricemodifier7_max",
    "tests/test_sharding.py::test_decode_blob_over_mesh",
    "tests/test_device_parity.py::test_mixed_file_batch",
    "tests/test_encode_pairs.py::test_pair_pack_mesh_byte_identity",
    "tests/test_handcrafted.py::TestHassizePathological::test_explicit_n_partial_matches_oracle",
    "tests/test_aux.py::TestFuzz::test_random_garbage_frames_never_crash",
    "tests/test_aux.py::TestDecodeBlobSink::test_sink_matches_materialized",
    "tests/test_aux.py::TestFailureDetection::test_lenient_mode_poisons_only_bad_lane",
    "tests/test_fixtures.py::test_fixture_decodes_bit_exact",
    "tests/test_batch_api.py::TestDecodeFiles::test_mesh_passthrough",
    "tests/test_batch_api.py::TestEncodeFiles::test_pooled_matches_per_file",
    "tests/test_batch_api.py::TestEncodeFiles::test_mixed_formats_grouped",
    "tests/test_api.py::TestAlacContext::test_read_frames_sequential",
    "tests/test_sharding.py::test_graft_entry_single_chip",
    "tests/test_sharding.py::test_sharded_decode_bit_exact",
    "tests/test_sharding.py::test_sharded_encode_byte_identical",
    "tests/test_sharding.py::test_decode_blob_cpu_mesh_under_gpu_default_backend",
}

_SLOW_EXACT = {
    "tests/test_device_parity.py::test_device_bit_exact[stereo24_uncompressed]",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        nodeid = item.nodeid
        if nodeid in _SLOW_EXACT or nodeid.split("[")[0] in _SLOW_BASES:
            item.add_marker(pytest.mark.slow)
