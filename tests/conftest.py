import os
import sys

# tests run single-device (the dry-run sets its own 512-device flag in a
# separate process); keep jax quiet and on CPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def make_abstract_mesh(sizes, names):
    """AbstractMesh across jax versions: (sizes, names) vs shape_tuple."""
    from jax.sharding import AbstractMesh
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")
