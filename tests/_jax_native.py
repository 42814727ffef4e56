"""The JAX package's C++ DSP library, loaded for the port's tests to compare
against.

``music2midi_tpu/native.py`` builds ``native/libm2m_dsp.so`` with ``make``
in the source tree at first use.  In a fresh checkout under pytest-xdist
every worker reaches that first use at once (``tests/test_native.py`` asks
for the library while it is imported), so several ``g++`` write the same
file, and a worker that loads it half-written keeps ``_load_failed`` for
the rest of its run.  ``loaded()`` waits for the writers and loads again.
"""

import time

from music2midi_tpu import native


def loaded(timeout_s: float = 120.0):
    """-> ``music2midi_tpu.native`` with its library loaded; raises
    AssertionError if it cannot be loaded within `timeout_s`."""
    deadline = time.monotonic() + timeout_s
    while not native.available():
        assert time.monotonic() < deadline, \
            "the JAX package's native library did not load"
        time.sleep(1.0)
        native._load_failed = False
    return native
