"""No module that a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``aero_tpu`` (the JAX package; ``aero_tpu_torch`` is another
name, so names are compared whole, never by prefix)."""

from __future__ import annotations

import json
import subprocess
import sys

from aerobench import run

RUN_TINY = """
import json, sys, time
sys.path.insert(0, "aerobench/tests")
from conftest import run_tiny, tiny_lband
out, info = run_tiny(*tiny_lband(), seconds=1.0)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    res = subprocess.run([sys.executable, "-c", RUN_TINY], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    names = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "aero_tpu_torch" in names and "aerobench" in names
    assert not names & set(run.BANNED), names & set(run.BANNED)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "aero_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert run.banned_modules() == [] or set(run.banned_modules()) <= {
        "jax", "jaxlib", "flax", "aero_tpu"}
    before = set(run.banned_modules())
    monkeypatch.setitem(sys.modules, "aero_tpu.ops", sys)
    assert set(run.banned_modules()) == before | {"aero_tpu"}
