"""The port's import boundary and its drift guard against ``aero_tpu``.

1. With ``jax`` and ``aero_tpu`` blocked on the import path (the condition
   on a machine that has no JAX), every module of ``aero_tpu_torch``
   imports.
2. Statically, the port, ``chip_smoke.py``, the port's tools and the test
   helpers that run on the card import nothing of ``aero_tpu`` and never
   ``jax``.
3. Drift guard: each verbatim copy equals its ``aero_tpu`` original after
   the ``aero_tpu`` -> ``aero_tpu_torch`` import rewrite, the native C++
   sources are byte-for-byte copies, the port's native libraries give the
   reference's outputs, and the copied functions, methods and modules
   (station accounting, the fused station's ``quantize`` / ``_drain`` /
   ``vfo_telemetry`` / ``vfo_spectrum``, the batched framer bank's
   ``feed`` / ``flush``, the burst wrapper's ``process``, the R/T framer
   module, the classic station's ``process``, the checkpoint's host-state
   helpers, the single-VFO decoder's data path) parse to the same syntax
   tree as the originals, up to the listed substitutions.  A later fix to
   ``aero_tpu`` fails here until the port takes it too.
"""

import ast
import inspect
import os
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "aero_tpu_torch")

VERBATIM = ["protocol/crc.py", "protocol/scrambler.py",
            "protocol/interleaver.py", "protocol/framing.py",
            "protocol/isu.py", "protocol/acars.py", "protocol/su_dispatch.py",
            "protocol/database.py", "protocol/c_framing.py",
            "channelizer/config.py", "ops/design.py", "io/output.py",
            "io/forwarder.py", "utils/signals.py", "utils/logging.py",
            "io/zmq_transport.py", "io/sdr.py", "runtime/hunter.py",
            "protocol/bitio.py", "protocol/uper.py", "protocol/fans.py",
            "protocol/cpdlc.py", "protocol/adsc.py",
            "protocol/acars_apps.py"]

NATIVE_SOURCES = ["native/ingest.cc", "native/viterbi.cc"]

# files outside the package that run on the card's machine (no JAX there)
CARD_SIDE = ["chip_smoke.py", "tools/torch_profile_step.py",
             "tools/viterbi_time.py", "tools/l54_burst_level.py",
             "tests/torch_soft.py",
             "tests/torch_station_bank.py", "tests/torch_lband54.py",
             "tests/test_torch_cuda.py"]

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "aero_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, sys.argv[1])
import aero_tpu_torch
names = [m.name for m in pkgutil.walk_packages(aero_tpu_torch.__path__,
                                               "aero_tpu_torch.")]
for n in names:
    importlib.import_module(n)
assert not any(k.split(".")[0] in ("jax", "aero_tpu") for k in sys.modules)
print(" ".join(names))
"""

# modules the walk must reach (each subpackage, and the classic station's
# and the single-VFO CLIs' modules)
REQUIRED = {"aero_tpu_torch." + m for m in (
    "parallel.vfo_bank", "channelizer.channelizer", "channelizer.pfb",
    "runtime.station", "runtime.checkpoint", "runtime.hunter",
    "runtime.decoder", "runtime.decode_main", "runtime.publish_main",
    "runtime.station_main", "utils.profiling", "utils.logging",
    "io.zmq_transport", "io.sdr", "ops.spectral", "protocol.acars_apps",
    "parallel.mesh", "parallel.time_shard", "parallel.multihost",
    "parallel.selftest", "parallel.dryrun")}


def _scanned_files():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    for rel in CARD_SIDE:
        yield os.path.join(ROOT, rel)


def test_port_imports_with_jax_blocked():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, ROOT],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 40 and REQUIRED <= names, REQUIRED - names


def test_port_import_boundary_is_static():
    bad = []
    for path in _scanned_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            else:
                continue
            for m in mods:
                if m.split(".")[0] in ("jax", "jaxlib", "aero_tpu"):
                    bad.append((os.path.relpath(path, ROOT), m))
    assert not bad, bad


def _rewrite_imports(src: str) -> str:
    return re.sub(r"^(\s*(?:from|import) )aero_tpu(?=[. ])", r"\1aero_tpu_torch",
                  src, flags=re.M)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copies_match(rel):
    orig = open(os.path.join(ROOT, "aero_tpu", rel)).read()
    port = open(os.path.join(PORT, rel)).read()
    assert port == _rewrite_imports(orig), (
        f"aero_tpu_torch/{rel} drifted from aero_tpu/{rel}: copy it again "
        "(only import lines may differ)")


@pytest.mark.parametrize("rel", NATIVE_SOURCES)
def test_native_sources_are_byte_copies(rel):
    with open(os.path.join(ROOT, "aero_tpu", rel), "rb") as f:
        orig = f.read()
    with open(os.path.join(PORT, rel), "rb") as f:
        assert f.read() == orig, (
            f"aero_tpu_torch/{rel} drifted from aero_tpu/{rel}: copy it again")


@pytest.fixture
def natives():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native libraries")
    from aero_tpu import native as jn
    from aero_tpu_torch import native as tn
    assert tn.have_native() and tn.have_native_ingest()
    assert jn.have_native() and jn.have_native_ingest()
    return jn, tn


@pytest.mark.parametrize("dtype", ["int4", "int2", "int8", "int16"])
def test_native_quantize_matches_reference(natives, dtype):
    jn, tn = natives
    rng = np.random.default_rng(len(dtype))
    iq = (0.3 * (rng.standard_normal(4096) + 1j * rng.standard_normal(4096))
          ).astype(np.complex64)
    iq[:8] = [0, 1.5, -1.5, 0.07 + 0.5j, -0.0714 - 0.0715j, 1e-9, 2j, -2j]
    want, got = jn.quantize_native(iq, dtype), tn.quantize_native(iq, dtype)
    if dtype == "int2":
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_native_viterbi_matches_reference(natives):
    jn, tn = natives
    rng = np.random.default_rng(9)
    for n in (2, 124, 1262, 5102):
        soft = rng.integers(0, 256, n).astype(np.float32)
        np.testing.assert_array_equal(tn.viterbi_decode_soft_native(soft),
                                      jn.viterbi_decode_soft_native(soft))


def test_native_libraries_build_outside_the_reference(natives):
    _, tn = natives
    assert tn.BUILD_DIR == os.path.join(ROOT, "build", "aero_tpu_torch")
    built = [f for f in os.listdir(tn.BUILD_DIR) if f.endswith(".so")]
    assert any(f.startswith("libaeroviterbi_") for f in built)
    assert any(f.startswith("libaeroingest_") for f in built)


def _tree(obj, subs=()):
    src = obj if isinstance(obj, str) else inspect.getsource(obj)
    src = _rewrite_imports(textwrap.dedent(src))
    for a, b in subs:
        assert src.count(a) == 1, (obj, a)
        src = src.replace(a, b)
    return ast.dump(ast.parse(src))


_FLUSH_SUBS = (
    ("jnp.asarray(soft), jnp.asarray(prefixes)",
     "self._tensor(soft), self._tensor(prefixes)"),
    ('np.asarray(dec["info_bits"])', 'dec["info_bits"].cpu().numpy()'),
    ('np.asarray(dec["su_ok"])', 'dec["su_ok"].cpu().numpy()'),
)


# the R/T framer takes its checkpoint decoder as an argument: the import,
# the constructor argument and its default, and the call at the decode
_RT_SUBS = (
    ("from aero_tpu_torch.protocol.viterbi import viterbi_decode_soft\n",
     "from aero_tpu_torch.ops.viterbi_kernel import stream_decoder\n"),
    ("                 db=None):\n", "                 db=None, decoder=None):\n"),
    ("        self.oqpsk = oqpsk\n",
     "        self.oqpsk = oqpsk\n"
     "        self.decoder = decoder or stream_decoder(\"cpu\")\n"),
    ("viterbi_decode_soft(block[idx])", "self.decoder(block[idx])"),
)

# the burst wrapper's host logic: where arrays cross to the device
_PROCESS_SUBS = (
    ("np.asarray(_envelope(padded,", "_host(_envelope(self._put(padded),"),
    ("np.asarray(_autocorr_rho(padded,",
     "_host(_autocorr_rho(self._put(padded),"),
    ("self._window_fn(win, gwin.astype(np.float32),",
     "self._window_fn(self._put(win), self._put(gwin.astype(np.float32)),"),
    ('np.asarray(out["soft"])', '_host(out["soft"])'),
    ('np.asarray(out["active"])', '_host(out["active"])'),
)

# the port's station state holds tensors, not packed complex planes, and
# a row is read in the shard that holds it
_SPECTRUM_SUBS = (
    ("    from aero_tpu_torch.ops.compat import tree_unpack\n", ""),
    ('st = tree_unpack(self._state["grp"][key]["demod"])',
     'shard, row = self._shard_row(key, row)\n'
     '        st = self._shards[shard]["grp"][key]["demod"]'),
    ("np.asarray(st.coarse_y[row])", "st.coarse_y[row].cpu().numpy()"),
)


# the classic station's bank outputs are tensors on its device
_STATION_SUBS = tuple(
    (f'np.asarray(out["{k}"])', f'out["{k}"].cpu().numpy()')
    for k in ("soft_bits", "signal", "slip"))

# the classic checkpoint flattens with the port's jax-free tree_leaves
_CLASSIC_SAVE_SUBS = (
    ("jax.tree_util.tree_leaves(_classic_device_tree(st))",
     "convert.tree_leaves(_classic_device_tree(st))"),)

# the port pickles its reassembly blobs under the JAX package's module
# name (runtime/checkpoint.py:_dumps), so that JAX loads them too
_SAVE_TOPICS_SUBS = (
    ("np.frombuffer(\n                    pickle.dumps((d.isudata, "
     "d.parser.defrag)), np.uint8)", "_dumps((d.isudata, d.parser.defrag))"),
    ("np.frombuffer(\n                pickle.dumps((f.risudata, f.isudata, "
     "f.parser.defrag)),\n                np.uint8)",
     "_dumps((f.risudata, f.isudata, f.parser.defrag))"),
)

# host state of checkpoints, and the single-VFO decoder's data path
_CHECKPOINT_FUNCS = ("_framer_state", "_restore_framer", "_rt_framer_state",
                     "_restore_rt_framer", "_burst_demod_state",
                     "_restore_burst_demod", "_save_topics", "_load_topics",
                     "_load_stats", "_atomic_savez", "load_residual")
_DECODER_METHODS = ("feed_audio", "_consume", "handle_acars", "close",
                    "run_zmq", "run_file", "_make_framing")
# its R/T framer decodes with the Viterbi kernel on the decoder's device
_DECODER_SUBS = {"_make_framing": (
    ("        from aero_tpu_torch.protocol.rt_framing import RTChannelFramer\n",
     "        from aero_tpu_torch.ops.viterbi_kernel import stream_decoder\n"
     "        from aero_tpu_torch.protocol.rt_framing import RTChannelFramer\n"),
    ("            db=db)\n    elif",
     "            db=db, decoder=stream_decoder(self.device))\n    elif"))}


def _source(mod):
    return open(mod.__file__).read()


def _pairs():
    from aero_tpu.runtime import station as js, fused_station as jf
    from aero_tpu.protocol import batch_framing as jb, rt_framing as jr
    from aero_tpu.models import burst_common as jc
    from aero_tpu_torch.runtime import station as ts, fused_station as tf
    from aero_tpu_torch.protocol import batch_framing as tb, rt_framing as tr
    from aero_tpu_torch.models import burst_common as tc
    from aero_tpu.runtime import checkpoint as jk, decoder as jd
    from aero_tpu_torch.runtime import checkpoint as tk, decoder as td
    pairs = {f"checkpoint.{n}": (getattr(jk, n), getattr(tk, n), ())
             for n in _CHECKPOINT_FUNCS}
    pairs["checkpoint._save_topics"] = (jk._save_topics, tk._save_topics,
                                        _SAVE_TOPICS_SUBS)
    pairs["checkpoint.save_classic_checkpoint"] = (
        jk.save_classic_checkpoint, tk.save_classic_checkpoint,
        _CLASSIC_SAVE_SUBS)
    pairs.update({f"decoder.{n}": (getattr(jd.Decoder, n),
                                   getattr(td.Decoder, n),
                                   _DECODER_SUBS.get(n, ()))
                  for n in _DECODER_METHODS})
    pairs["Station.process"] = (js.Station.process, ts.Station.process,
                                _STATION_SUBS)
    return pairs | {
        "StationStats": (js.StationStats, ts.StationStats, ()),
        "new_burst_stats": (js.new_burst_stats, ts.new_burst_stats, ()),
        "account_burst_outputs": (js.account_burst_outputs,
                                  ts.account_burst_outputs, ()),
        "account_framer_events": (js.account_framer_events,
                                  ts.account_framer_events, ()),
        "quantize": (jf.FusedStation.quantize, tf.FusedStation.quantize, ()),
        "_drain": (jf.FusedStation._drain, tf.FusedStation._drain,
                   (("np.asarray(packed)", "packed.cpu().numpy()"),)),
        "vfo_telemetry": (jf.FusedStation.vfo_telemetry,
                          tf.FusedStation.vfo_telemetry, ()),
        "bank.feed": (jb.BatchPChannelFramerBank.feed,
                      tb.BatchPChannelFramerBank.feed, ()),
        "bank.flush": (jb.BatchPChannelFramerBank.flush,
                       tb.BatchPChannelFramerBank.flush, _FLUSH_SUBS),
        "vfo_spectrum": (jf.FusedStation.vfo_spectrum,
                         tf.FusedStation.vfo_spectrum, _SPECTRUM_SUBS),
        "burst.process": (jc.BurstWindowDemodulator.process,
                          tc.BurstWindowDemodulator.process, _PROCESS_SUBS),
        "rt_framing": (_source(jr), _source(tr), _RT_SUBS),
    }


@pytest.mark.parametrize("name", [
    "StationStats", "new_burst_stats", "account_burst_outputs",
    "account_framer_events", "quantize", "_drain", "vfo_telemetry",
    "bank.feed", "bank.flush", "vfo_spectrum", "burst.process", "rt_framing",
    "Station.process", "checkpoint.save_classic_checkpoint"]
    + [f"checkpoint.{n}" for n in _CHECKPOINT_FUNCS]
    + [f"decoder.{n}" for n in _DECODER_METHODS])
def test_copied_code_matches_original(name):
    orig, port, subs = _pairs()[name]
    assert _tree(port) == _tree(orig, subs), (
        f"{name}: the port's copy drifted from aero_tpu — take the change")
