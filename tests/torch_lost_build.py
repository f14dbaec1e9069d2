"""A pytest plugin that puts every worker in the state of one that lost
the reference's native build race.

``aero_tpu/native/__init__.py:_build_and_load`` compiles straight into
``aero_tpu/native/`` with no lock and no temporary file, and caches None
for the whole process when ``ctypes.CDLL`` then fails.  With several
xdist workers on a checkout that has no library yet, a worker that opens
a half-written file keeps the reference's numpy and scipy paths for the
rest of the run.  This plugin sets the reference's two cache entries to
None at the start of every session, as such a worker has them.

Not collected as tests.  Run the tier-1 command with
``-p tests.torch_lost_build`` added.
"""


def pytest_sessionstart(session):
    # imported here, not at module import: tests/conftest.py must set the
    # JAX platform and XLA flags before anything imports aero_tpu
    from aero_tpu import native
    native._libs["libaeroingest.so"] = None
    native._libs["libaeroviterbi.so"] = None
