"""Test harness config: an 8-device virtual CPU mesh, set before jax loads.

The tests run on the CPU (JAX_PLATFORMS=cpu), where exact-parity tests
are defined on IEEE f64.  Multi-device sharding is validated on the
virtual CPU devices (xla_force_host_platform_device_count); the GPU
path is exercised by chip_smoke.py on the card, which also runs the
tests marked `gpu` (with JAX_PLATFORMS=cuda).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

# The dense k-mer LUT (index/build.py device()) is a 4^k random-gather
# table; on the CPU test backend it is cache-hostile and roughly doubled
# suite time, so tests default to the searchsorted path.  The LUT path's
# equivalence is covered explicitly in test_map_e2e.py.
os.environ.setdefault("VGALIGNER_DENSE_LUT_MAX", "0")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_platforms", "cpu")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

from vgaligner_tpu.graph.handlegraph import HashGraph  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips elsewhere (chip_smoke.py runs "
        "these on the card)",
    )


@pytest.fixture
def simple_graph() -> HashGraph:
    """The diamond debug graph (index.rs:646-678).

          | 2: CT \\
    1: A            4: GCA
          \\ 3: GA |
    """
    g = HashGraph()
    h1 = g.create_handle("A", 1)
    h2 = g.create_handle("CT", 2)
    h3 = g.create_handle("GA", 3)
    h4 = g.create_handle("GCA", 4)
    g.create_edge(h1, h2)
    g.create_edge(h1, h3)
    g.create_edge(h2, h4)
    g.create_edge(h3, h4)
    p1 = g.create_path("P1")
    for h in (h1, h2, h4):
        g.append_step(p1, h)
    p2 = g.create_path("P2")
    for h in (h1, h3, h4):
        g.append_step(p2, h)
    return g


@pytest.fixture
def simple_graph_2() -> HashGraph:
    """Second debug graph (index.rs:688-701): GAT -> {T,A} -> CA."""
    g = HashGraph()
    h1 = g.create_handle("GAT", 1)
    h2 = g.create_handle("T", 2)
    h3 = g.create_handle("A", 3)
    h4 = g.create_handle("CA", 4)
    g.create_edge(h1, h2)
    g.create_edge(h1, h3)
    g.create_edge(h2, h4)
    g.create_edge(h3, h4)
    return g
