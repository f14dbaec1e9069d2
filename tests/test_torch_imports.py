"""The port's import boundary and its drift guard against ``aero_tpu``.

1. With ``jax`` and ``aero_tpu`` blocked on the import path (the condition
   on a machine that has no JAX), every module of ``aero_tpu_torch``
   imports.
2. Statically, the port, ``chip_smoke.py``, the port's tools and the test
   helpers that run on the card import nothing of ``aero_tpu`` and never
   ``jax``.
3. Drift guard: each verbatim copy equals its ``aero_tpu`` original after
   the ``aero_tpu`` -> ``aero_tpu_torch`` import rewrite (the SU
   dispatcher and the ACARS parser are no copies: the port routes without
   the display line where none is asked for and strips parity by table,
   and tests/test_torch_su_dispatch.py holds both to the originals'
   outputs on the same SU streams), the native C++
   sources are byte-for-byte copies, the port's native libraries give the
   reference's outputs, and the copied functions, methods and modules
   (station accounting, the fused station's ``quantize`` /
   ``vfo_telemetry`` / ``vfo_spectrum``, the batched framer bank's
   ``feed`` / ``flush``, the R/T framer module, the classic station's
   ``process``, the checkpoint's host-state helpers, the single-VFO
   decoder's data path, the parity tool's ``parity``) parse to the same
   syntax tree as the originals, up to the listed substitutions.  A
   later fix to ``aero_tpu`` fails here until the port takes it too.
   The burst wrapper's ``process`` runs its detection on the device and
   is no copy: tests/test_torch_burst.py holds it to the host loop it
   replaced, block by block.  The fused station's ``_drain`` feeds every
   continuous group through its framer bank, C groups too, where JAX's
   frames C channels one framer at a time: the last test holds it to
   JAX's ``_drain``, both of its framing paths, on the same packed rows.
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

from tests.torch_natives import reference_natives  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "aero_tpu_torch")

VERBATIM = ["protocol/crc.py", "protocol/scrambler.py",
            "protocol/interleaver.py", "protocol/isu.py",
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
             "tools/su_dispatch_time.py",
             "tools/viterbi_time.py", "tools/l54_burst_level.py",
             "tools/torch_parity_check.py", "tools/torch_make_fixture.py",
             "tools/frame_diff.py", "tests/torch_soft.py",
             "tests/torch_station_bank.py", "tests/torch_lband54.py",
             "tests/torch_impair.py", "tests/torch_burst_oracle.py",
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

# modules the walk must reach (each subpackage, the classic station's and
# the single-VFO CLIs' modules, and the bench)
REQUIRED = {"aero_tpu_torch." + m for m in (
    "parallel.vfo_bank", "channelizer.channelizer", "channelizer.pfb",
    "runtime.station", "runtime.checkpoint", "runtime.hunter",
    "runtime.decoder", "runtime.decode_main", "runtime.publish_main",
    "runtime.station_main", "utils.profiling", "utils.logging",
    "io.zmq_transport", "io.sdr", "ops.spectral", "protocol.acars_apps",
    "parallel.mesh", "parallel.time_shard", "parallel.multihost",
    "parallel.selftest", "parallel.dryrun", "bench")}


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


_BLOCKED_SCRIPTS = _BLOCKED_IMPORT.split("import aero_tpu_torch\n")[0] + r"""
import runpy
sys.path[1:1] = [sys.argv[1] + "/tests", sys.argv[1] + "/tools"]
for rel in sys.argv[2:]:
    runpy.run_path(sys.argv[1] + "/" + rel, run_name="card_side")
assert not any(k.split(".")[0] in ("jax", "aero_tpu") for k in sys.modules)
"""


def test_card_side_scripts_import_with_jax_blocked():
    """The smoke, the parity and fixture tools and the impairment streams
    load with ``jax`` and ``aero_tpu`` blocked, as on the card's machine."""
    rels = ["chip_smoke.py", "tools/torch_parity_check.py",
            "tools/torch_make_fixture.py", "tests/torch_impair.py"]
    res = subprocess.run([sys.executable, "-c", _BLOCKED_SCRIPTS, ROOT,
                          *rels], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


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
def natives(reference_natives):
    """Both packages' native modules, each with its libraries loaded; the
    reference's come through ``reference_natives`` where this worker lost
    the reference's build race (tests/torch_natives.py)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native libraries")
    jn = reference_natives
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
    ("batch_decode_p_frames(", "self._decode("),
    # the tensor's device picks the decoder: no ``use_pallas``
    ("use_pallas=self.use_pallas, pre_deinterleaved=True",
     "pre_deinterleaved=True"),
    ("jnp.asarray(soft), jnp.asarray(prefixes)",
     "self._tensor(soft), self._tensor(prefixes)"),
    ('np.asarray(dec["info_bits"])', 'dec["info_bits"].cpu().numpy()'),
    ('np.asarray(dec["su_ok"])\n', 'dec["su_ok"].cpu().numpy()\n'
     "        if TRACER.on:\n"
     "            _decoded(n, n_pad)\n"),
    # the tracer's spans (utils/profiling.py): each round's decode, from
    # the stack of pending frames to its outputs on the host (closed by
    # ``_decoded``, which opens the round's bookkeeping), the rewinds'
    # count, and the bookkeeping's end
    ("        soft = np.stack(",
     "        if TRACER.on:\n"
     '            TRACER.open("framers.decode")\n'
     "        soft = np.stack("),
    ("                    assert not evs\n",
     "                    assert not evs\n"
     "                    if TRACER.on:\n"
     '                        TRACER.count("frames.rewound", len(later))\n'),
    ("        if not rewound:\n",
     "        if TRACER.on:\n"
     "            TRACER.close()\n"
     "        if not rewound:\n"),
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
    from aero_tpu_torch.runtime import station as ts, fused_station as tf
    from aero_tpu_torch.protocol import batch_framing as tb, rt_framing as tr
    from aero_tpu.runtime import checkpoint as jk, decoder as jd
    from aero_tpu_torch.runtime import checkpoint as tk, decoder as td
    from tools import parity_check as jp, torch_parity_check as tp
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
        "vfo_telemetry": (jf.FusedStation.vfo_telemetry,
                          tf.FusedStation.vfo_telemetry, ()),
        "bank.feed": (jb.BatchPChannelFramerBank.feed,
                      tb.BatchPChannelFramerBank.feed, ()),
        "bank.flush": (jb.BatchPChannelFramerBank.flush,
                       tb.BatchPChannelFramerBank.flush, _FLUSH_SUBS),
        "vfo_spectrum": (jf.FusedStation.vfo_spectrum,
                         tf.FusedStation.vfo_spectrum, _SPECTRUM_SUBS),
        "rt_framing": (_source(jr), _source(tr), _RT_SUBS),
        "parity_check.parity": (jp.parity, tp.parity, ()),
    }


@pytest.mark.parametrize("name", [
    "StationStats", "new_burst_stats", "account_burst_outputs",
    "account_framer_events", "quantize", "vfo_telemetry",
    "bank.feed", "bank.flush", "vfo_spectrum", "rt_framing",
    "Station.process", "checkpoint.save_classic_checkpoint",
    "parity_check.parity"]
    + [f"checkpoint.{n}" for n in _CHECKPOINT_FUNCS]
    + [f"decoder.{n}" for n in _DECODER_METHODS])
def test_copied_code_matches_original(name):
    orig, port, subs = _pairs()[name]
    assert _tree(port) == _tree(orig, subs), (
        f"{name}: the port's copy drifted from aero_tpu — take the change")


# ---- the fused station's drain, held to JAX's by behaviour ----

@pytest.fixture(scope="module")
def drained():
    """A C-band bank on the 4x plan (two P, two C and a T watcher at 288
    kS/s: ACARS on a P channel, voice with a call-progress hex on both C
    channels, a T burst) through the port's station on the CPU: the
    packed rows each drain took, and what the drain gave."""
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.protocol.crc import append_crc16_bytes as crc
    from aero_tpu_torch.runtime.fused_station import FusedStation
    from test_torch_cuda import cband_ini, cband_layout, cband_wideband
    fs, L, blocks = 288000, 96000, 14
    layout = cband_layout(2, 2, 1, 48000)
    rng = np.random.default_rng(11)
    cframes = [([crc(bytes([0x30, 0x12, 0x34, 0x56])
                     + bytes(rng.integers(0, 256, 6).tolist()))]
                + [crc(bytes(rng.integers(0, 256, 10).tolist()))
                   for _ in range(2)],
                bytes(rng.integers(0, 256, 300).tolist())) for _ in range(5)]
    wide = cband_wideband(fs, layout, {"P00": ("P", ["DRAIN P"]),
                                       "C02": ("C", cframes),
                                       "C03": ("C", cframes[::-1]),
                                       "T04": ("T", "DRAIN T", 1.5)},
                          blocks * L, seed=3)
    ini = cband_ini(fs, layout)
    rows, out = [], _Outputs()
    st = FusedStation(load_ini(ini, is_text=True), ingest_dtype="int4",
                      pfb_oversample=4, device="cpu", on_acars=out.acars,
                      on_voice=out.voice)
    drain, account = st._drain, st._account_framer_events

    def recorded(packed):
        rows.append(packed.cpu().numpy().copy())
        drain(packed)
    st._drain = recorded
    st._account_framer_events = out.accounting(account)
    for b in range(blocks):
        st.process(wide[b * L:(b + 1) * L])
    st.flush()
    return ini, rows, out.result(st)


class _Outputs:
    """A station's ACARS, voice and framer events, in the order its drain
    gave them."""

    def __init__(self):
        self.items, self.voices, self.events = [], [], []

    def acars(self, topic, item):
        self.items.append((topic, item.message))

    def voice(self, topic, data, hex_aes):
        self.voices.append((topic, bytes(data), hex_aes))

    def accounting(self, account):
        def call(stats, rate, evs, dispatcher=None):
            self.events.append((rate, [_event(e) for e in evs]))
            account(stats, rate, evs, dispatcher)
        return call

    def result(self, st):
        s = st.stats
        bursts = {t: (b["windows"], b["packets"])
                  for t, b in st.burst_stats.items()}
        return {"acars": self.items, "voice": self.voices,
                "events": self.events, "bursts": bursts,
                "stats": (s.frames, s.su_ok, s.su_bad, s.acars,
                          s.voice_frames, s.burst_windows,
                          s.burst_packets)}


def _event(ev):
    return {k: [bool(x) for x in v] if k == "su_crc_ok" else v
            for k, v in vars(ev).items()}


@pytest.mark.parametrize("batch", [False, True])
def test_drain_gives_the_reference_drains_outputs(drained, reference_natives,
                                                  monkeypatch, batch):
    """The same packed rows through JAX's ``_drain``, its station built
    with batch framing off and on (its C channels framed one framer at a
    time either way): the same framer events per group and topic, ACARS,
    voice frames, burst counts and stats as the port's drain."""
    from aero_tpu.channelizer import load_ini
    from aero_tpu.runtime import fused_station as jf
    ini, rows, want = drained
    out = _Outputs()
    monkeypatch.setattr(jf, "account_framer_events",
                        out.accounting(jf.account_framer_events))
    st = jf.FusedStation(load_ini(ini, is_text=True), ingest_dtype="int4",
                         batch_host_framing=batch, on_acars=out.acars,
                         on_voice=out.voice)
    for packed in rows:
        st._drain(packed)
    got = out.result(st)
    assert got == want
    assert {t for t, _, _ in got["voice"]} == {"C02", "C03"}
    assert sum(len(evs) for rate, evs in got["events"] if rate == 8400) >= 8
    assert any(t == "P00" for t, _ in got["acars"])
    assert "123456" in {h for _, _, h in got["voice"]}
    assert got["bursts"]["T04"][1] >= 1
