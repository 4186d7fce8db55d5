"""A private build of the JAX package's native library for the port's tests
that write or read their reference through it.

The JAX package compiles `libcarto_native.so` next to its sources at first
use (`deep_cartograph_tpu/native/build.py`), straight onto the shared,
git-ignored file. In a fresh checkout every pytest-xdist worker that needs
it compiles it at once; a worker that loads the file half-written marks
the build failed and writes no XTC, DCD or colvars through it. The
`jax_native` fixture builds the library once per worker into that worker's
own temporary folder, under a file lock, and points the JAX package's
loader at it for the module that uses it (autouse wherever it is
imported); nothing in the JAX package changes.

    from tests.test_torch_jax_native import jax_native, jax_native_library  # noqa: F401
"""

import fcntl
import os

import pytest

from deep_cartograph_tpu.native import build as jax_native_build


@pytest.fixture(scope="session")
def jax_native_library(tmp_path_factory):
    """Path of this worker's own build of the JAX native library."""
    folder = tmp_path_factory.getbasetemp() / "jax_native"
    folder.mkdir(exist_ok=True)
    path = folder / "libcarto_native.so"
    with open(folder / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_native_build, "_LIB_PATH", str(path))
                if not jax_native_build.build_native():
                    pytest.fail("the JAX package's native library did not build")
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def jax_native(jax_native_library):
    """The JAX package loads this worker's private library during the
    module, from a clean cache; its own state comes back after."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native_build, "_LIB_PATH", jax_native_library)
        mp.setattr(jax_native_build, "_LIB_CACHE", None)
        mp.setattr(jax_native_build, "_BUILD_FAILED", False)
        yield jax_native_library


def test_the_private_library_is_what_the_jax_package_loads(jax_native):
    lib = jax_native_build.load_native()
    assert lib is not None
    assert lib._name == jax_native and os.path.dirname(jax_native) != jax_native_build._NATIVE_DIR
    for name in ("xtc_compress_coords", "colvars_parse", "dcd_open", "dip_statistics_batch"):
        assert hasattr(lib, name), name


def test_a_failed_shared_build_does_not_reach_the_private_library(monkeypatch):
    """A worker whose shared build failed (`_BUILD_FAILED`) before the module
    began still loads the private library inside it."""
    assert jax_native_build._BUILD_FAILED is False
    monkeypatch.setattr(jax_native_build, "_LIB_CACHE", None)
    monkeypatch.setattr(jax_native_build, "_BUILD_FAILED", True)
    assert jax_native_build.load_native() is None  # the JAX package's own rule
    monkeypatch.setattr(jax_native_build, "_BUILD_FAILED", False)
    assert jax_native_build.load_native() is not None
