"""The JAX package's native library, loaded whole before a parity test uses
it.

``sddmm_tpu.native`` builds ``libsddmm_native.so`` in place with ``g++ -o``
at first use.  Test workers that start side by side can find the file
half-written: ``ctypes`` then fails to load it, the module sets
``_build_failed``, and that worker runs the JAX package's numpy fallbacks
in place of the native code for the rest of its life.  A parity test of the
port against such a worker compares against another code path.
``reference_native()`` retries the load, with ``_build_failed`` reset,
while the library file is there and for up to ``timeout_s``; if it is
still not loaded the test fails with the reason (it never skips).

Every ``tests/test_torch_*.py`` that imports the JAX package imports the
autouse fixture ``reference_native_loaded`` by name, so the library is
loaded before its tests and their module fixtures run."""

import time

import pytest


def reference_native(timeout_s: float = 60.0):
    """The loaded ``ctypes`` library of ``sddmm_tpu.native``, or a test
    failure naming why it is not there."""
    from sddmm_tpu import native

    deadline = time.monotonic() + timeout_s
    while True:
        lib = native._load()
        if lib is not None:
            return lib
        if not native._LIB_PATH.exists():
            pytest.fail(f"sddmm_tpu.native: no library at {native._LIB_PATH}"
                        " (the g++ build failed)")
        if time.monotonic() >= deadline:
            pytest.fail(f"sddmm_tpu.native: {native._LIB_PATH} is there but "
                        f"did not load within {timeout_s:.0f} s")
        # another worker may still be writing it: load it again
        native._build_failed = False
        time.sleep(0.5)


@pytest.fixture(autouse=True, scope="session")
def reference_native_loaded():
    """``reference_native()`` before the importing file's tests.  Set up
    once a file at session scope, so before the file's module fixtures too
    (pytest sets up the wider scopes first), which build JAX references as
    well; once loaded the library stays loaded for the worker's life."""
    reference_native()
