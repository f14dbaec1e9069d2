"""Checkpoint/resume for streaming stations (torch).

Counterpart of ``aero_tpu/runtime/checkpoint.py`` (read its docstring for
what a checkpoint holds and why).  The file format is JAX's, leaf for
leaf, both ways: ``dev_i`` are the device state's leaves in
``jax.tree_util.tree_leaves`` order of the JAX station's tree, complex
carries packed as float32 re/im planes (``convert`` maps the port's
tensors to and from that layout); the deframer, hunter, audio-buffer and
stats entries are plain arrays under the same names.  So a checkpoint
written by the JAX ``FusedStation`` or classic ``Station`` resumes in the
port's station of the same configuration, and the port's device and
framer state loads into JAX's.

The ISU/ACARS reassembly blobs pickle the reassembly objects.  The
port's copy of ``aero_tpu/protocol/isu.py`` holds the same classes, so the
port writes its blobs under the JAX package's module name (``_dumps``),
which JAX's restricted unpickler accepts; the restricted unpickler here
maps the (module, name) pairs of ``aero_tpu.protocol.isu`` and
``aero_tpu_torch.protocol.isu`` onto the port's copies (it never imports
the JAX package) and refuses any other class.

A station on the 4x filterbank plan (``FusedStation(pfb_oversample=4)``)
adds one entry, ``meta_pfb_oversample``; a file without it is of the 2x
plan, JAX's.  A load refuses a file of another plan than the station's.

A sharded station saves its whole state in this one layout (its
``_state`` and its banks' ``states`` gather the shards), and a load
re-shards onto the station's mesh, so a file crosses between sharded
and unsharded stations of either package.

    st.save_checkpoint("station.ckpt")         # drains in-flight work
    st2 = FusedStation(same_cfg, ...)          # fresh process
    st2.load_checkpoint("station.ckpt")
    st2.process(next_block)                    # continues where st stopped
"""

from __future__ import annotations

import io
import os
import pickle
import pickletools

import numpy as np

from aero_tpu_torch import convert
from aero_tpu_torch.protocol import isu as _isu


# v3: the demod states carry slope/grid_rate (Doppler and sample-clock
# tracking); a version bump gives older checkpoints a clear error instead
# of a confusing leaf-count mismatch
FORMAT_VERSION = 3

# the only classes a checkpoint's reassembly blobs may instantiate, under
# the JAX package's module name or the port's
_ISU_MODULES = ("aero_tpu.protocol.isu", "aero_tpu_torch.protocol.isu")
_ALLOWED_NAMES = ("ISUItem", "RISUItem", "ISUData", "RISUData",
                  "ACARSItem", "ACARSDefragmenter")


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _ISU_MODULES and name in _ALLOWED_NAMES:
            return getattr(_isu, name)
        raise pickle.UnpicklingError(
            f"checkpoint reassembly blob names disallowed class "
            f"{module}.{name}")


def _restricted_loads(blob: bytes):
    return _RestrictedUnpickler(io.BytesIO(blob)).load()


def _dumps(obj) -> np.ndarray:
    """A reassembly blob that either package loads: pickle protocol 3 (its
    GLOBAL opcodes name a class as text lines, and it has no frames whose
    lengths a rename would break), with the port's isu module renamed to
    the JAX package's."""
    raw = pickle.dumps(obj, protocol=3)
    ops = list(pickletools.genops(raw))
    ends = [pos for _, _, pos in ops[1:]] + [len(raw)]
    out = []
    for (op, arg, pos), end in zip(ops, ends):
        if op.name == "GLOBAL" and arg.startswith(_ISU_MODULES[1] + " "):
            name = arg.split(" ")[1]
            out.append(f"c{_ISU_MODULES[0]}\n{name}\n".encode())
        else:
            out.append(raw[pos:end])
    return np.frombuffer(b"".join(out), np.uint8)


# ---- per-component plain-array state (framers hold numpy scalars/arrays
#      and python ints/bools only — no pickle needed) ----

def _framer_state(f) -> dict:
    from aero_tpu_torch.protocol.framing import PChannelFramer
    from aero_tpu_torch.protocol.c_framing import CChannelFramer
    if isinstance(f, PChannelFramer):
        return {
            "buf": f.buf.copy(),
            "locked": np.bool_(f.locked),
            "frame_index": np.int64(f.frame_index),
            "dcd_count": np.int64(f.dcd_count),
            "dcd": np.bool_(f.dcd),
            "arm_flip": f._arm_flip.copy(),
            "vit_carry": f.viterbi._carry.copy(),
        }
    assert isinstance(f, CChannelFramer), type(f)
    return {
        "buf": f.buf.copy(),
        "locked": np.bool_(f.locked),
        "frame_index": np.int64(f.frame_index),
        "flip": f._flip.copy(),
        "hex": np.frombuffer(f._hex.encode(), np.uint8).copy(),
        "vit_carry": f.viterbi._carry.copy(),
    }


def _restore_framer(f, d: dict):
    from aero_tpu_torch.protocol.framing import PChannelFramer
    f.buf = np.asarray(d["buf"], np.float32)
    f.locked = bool(d["locked"])
    f.frame_index = int(d["frame_index"])
    f.viterbi._carry = np.asarray(d["vit_carry"], np.float32)
    if isinstance(f, PChannelFramer):
        f.dcd_count = int(d["dcd_count"])
        f.dcd = bool(d["dcd"])
        f._arm_flip = np.asarray(d["arm_flip"], bool)
    else:
        f._flip = np.asarray(d["flip"], np.int32)
        f._hex = bytes(np.asarray(d["hex"], np.uint8)).decode()


def _rt_framer_state(f) -> dict:
    return {
        "collect": f._collect.copy(),
        "synced": np.bool_(f._synced),
        "done": np.bool_(f._done),
        "target_su": np.int64(f._target_su),
        "target_rows": np.int64(f._target_rows),
        "flip_pattern": f._flip_pattern.copy(),
        "tried": np.asarray(sorted(f._tried), np.int64),
    }


def _restore_rt_framer(f, d: dict):
    f._collect = np.asarray(d["collect"], np.float32)
    f._synced = bool(d["synced"])
    f._done = bool(d["done"])
    f._target_su = int(d["target_su"])
    f._target_rows = int(d["target_rows"])
    f._flip_pattern = np.asarray(d["flip_pattern"], np.int32)
    f._tried = set(int(x) for x in d["tried"])


def _burst_demod_state(b) -> dict:
    return {"ring": b._ring.copy(),
            "noise_floor": np.float64(b._noise_floor)}


def _restore_burst_demod(b, d: dict):
    b._ring = np.asarray(d["ring"], np.float32)
    b._noise_floor = float(d["noise_floor"])


def _save_topics(st, entries: dict, topics) -> None:
    """Per-topic host state (framers, reassembly, burst demods) — shared
    by the FusedStation and classic Station checkpoint formats."""
    for j, t in enumerate(topics):
        if t in st.framers:
            for k, v in _framer_state(st.framers[t]).items():
                entries[f"fr{j}_{k}"] = v
            if t in st.dispatchers:
                d = st.dispatchers[t]
                entries[f"reasm{j}"] = _dumps((d.isudata, d.parser.defrag))
        else:
            for k, v in _rt_framer_state(st.rt_framers[t]).items():
                entries[f"rt{j}_{k}"] = v
            f = st.rt_framers[t]
            entries[f"reasm{j}"] = _dumps((f.risudata, f.isudata,
                                           f.parser.defrag))
            for k, v in _burst_demod_state(st.burst_demods[t]).items():
                entries[f"bd{j}_{k}"] = v


def _load_topics(st, z, topics) -> None:
    for j, t in enumerate(topics):
        if t in st.framers:
            d = {k[len(f"fr{j}_"):]: z[k] for k in z.files
                 if k.startswith(f"fr{j}_")}
            _restore_framer(st.framers[t], d)
            if t in st.dispatchers and f"reasm{j}" in z.files:
                isudata, defrag = _restricted_loads(
                    z[f"reasm{j}"].tobytes())
                st.dispatchers[t].isudata = isudata
                st.dispatchers[t].parser.defrag = defrag
        else:
            d = {k[len(f"rt{j}_"):]: z[k] for k in z.files
                 if k.startswith(f"rt{j}_")}
            _restore_rt_framer(st.rt_framers[t], d)
            risudata, isudata, defrag = _restricted_loads(
                z[f"reasm{j}"].tobytes())
            st.rt_framers[t].risudata = risudata
            st.rt_framers[t].isudata = isudata
            st.rt_framers[t].parser.defrag = defrag
            b = {k[len(f"bd{j}_"):]: z[k] for k in z.files
                 if k.startswith(f"bd{j}_")}
            _restore_burst_demod(st.burst_demods[t], b)


def _load_stats(st, z) -> None:
    for k in z.files:
        if k.startswith("stat_"):
            v = z[k]
            setattr(st.stats, k[5:],
                    float(v) if v.dtype.kind == "f" else int(v))


def _atomic_savez(path: str, entries: dict) -> None:
    """Write ``entries`` to EXACTLY ``path``: np.savez_compressed given a
    bare name appends '.npz', so a --checkpoint station.ckpt save would
    land at station.ckpt.npz while resume checks station.ckpt — passing
    an open file object pins the name.  The temp-file + os.replace dance
    means a crash mid-write (the very scenario checkpoints exist for)
    can never leave a truncated archive as the only copy."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **entries)
            f.flush()
            os.fsync(f.fileno())     # data durable BEFORE the rename, so
            # a power loss cannot persist the rename without the bytes
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)           # don't strand .tmp litter on ENOSPC
        except OSError:
            pass
        raise


def load_residual(path: str) -> np.ndarray:
    """Wideband IQ buffered by the CALLER at save time (e.g. the pump's
    partial block in station_main, up to buflen-1 samples) — restoring it
    keeps the resumed stream sample-contiguous with the capture.  Empty
    if the checkpoint carries none."""
    with np.load(path, allow_pickle=False) as z:
        if "meta_residual" in z.files:
            return np.asarray(z["meta_residual"], np.complex64)
    return np.zeros(0, np.complex64)


def _device_leaves(z, template) -> list:
    """The checkpoint's ``dev_i`` arrays, checked leaf by leaf against the
    station's own tree (JAX layout, numpy): count, shapes and dtypes."""
    leaves = convert.tree_leaves(template)
    if int(z["meta_n_dev"]) != len(leaves):
        raise ValueError("checkpoint device state does not match "
                         "station configuration")
    out = []
    for i, cur in enumerate(leaves):
        arr = z[f"dev_{i}"]
        if arr.shape != cur.shape or arr.dtype != cur.dtype:
            raise ValueError(f"device leaf {i}: checkpoint "
                             f"{arr.shape}/{arr.dtype} != station "
                             f"{cur.shape}/{cur.dtype}")
        out.append(arr)
    return out


def _check_header(z, st) -> list:
    version = int(z["meta_version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {version} != "
                         f"{FORMAT_VERSION}")
    topics = [str(t) for t in z["meta_topics"]]
    if topics != sorted(set(st.framers) | set(st.rt_framers)):
        raise ValueError("checkpoint VFO topics do not match station "
                         "configuration")
    return topics


def save_station_checkpoint(st, path: str, residual=None):
    """Write a FusedStation checkpoint.  Drains pending/in-flight blocks
    first so host bookkeeping is consistent with the device state."""
    st.flush()
    leaves = convert.tree_leaves(convert.fused_state_to_numpy(st._state))
    entries = {f"dev_{i}": np.asarray(x) for i, x in enumerate(leaves)}

    topics = sorted(set(st.framers) | set(st.rt_framers))
    entries["meta_version"] = np.int64(FORMAT_VERSION)
    entries["meta_topics"] = np.asarray(topics)
    entries["meta_n_dev"] = np.int64(len(leaves))
    entries["meta_gain"] = np.float64(st._gain)
    entries["meta_ingest"] = np.asarray(st.ingest_dtype)
    entries["meta_block_len"] = np.int64(st.block_len)
    if st.pfb_oversample != 2:
        entries["meta_pfb_oversample"] = np.int64(st.pfb_oversample)
    _save_topics(st, entries, topics)
    for k, v in vars(st.stats).items():
        entries[f"stat_{k}"] = np.asarray(v)
    if residual is not None:
        entries["meta_residual"] = np.asarray(residual, np.complex64)
    _atomic_savez(path, entries)


def load_station_checkpoint(st, path: str):
    """Load a FusedStation checkpoint (written by the port or by JAX) into
    a station built with the same configuration.  Any pending/in-flight
    blocks on the target station are drained first so pre-load soft bits
    cannot leak into the restored framers."""
    st.flush()
    with np.load(path, allow_pickle=False) as z:
        topics = _check_header(z, st)
        for name, have in (("meta_gain", st._gain),
                           ("meta_block_len", st.block_len)):
            if float(z[name]) != float(have):
                raise ValueError(f"checkpoint {name}={z[name]} != station "
                                 f"{have}; bit-identical resume needs the "
                                 "same configuration")
        if str(z["meta_ingest"]) != st.ingest_dtype:
            raise ValueError(f"checkpoint ingest_dtype {z['meta_ingest']} "
                             f"!= station {st.ingest_dtype}")
        plan = (int(z["meta_pfb_oversample"])
                if "meta_pfb_oversample" in z.files else 2)
        if plan != st.pfb_oversample:
            raise ValueError(f"checkpoint filterbank plan pfb_oversample="
                             f"{plan} != station {st.pfb_oversample}: the "
                             "filterbank carries and residual phases "
                             "belong to the plan")
        template = convert.fused_state_to_numpy(st._state)
        leaves = _device_leaves(z, template)
        st._state = convert.fused_state_from_numpy(
            convert.tree_unflatten(template, leaves), st.device)
        _load_topics(st, z, topics)
        _load_stats(st, z)


# ---- classic Station (tree/pfb channelizer + VfoBank groups) ----

def _classic_device_tree(st) -> dict:
    """``Station.device_state`` as numpy in the JAX file's layout: complex
    leaves packed ``{"__c64__": planes}``, except the filterbank carries,
    which JAX keeps as bare [2, ...] planes."""
    tree = st.device_state()
    pfb = tree.pop("pfb", None)
    dev = convert.tree_to_numpy(tree)
    if pfb is not None:
        dev["pfb"] = {r: convert.c64_to_planes(z) for r, z in pfb.items()}
    return dev


def _classic_set_device_tree(st, dev: dict) -> None:
    """Inverse of ``_classic_device_tree``, onto the station's device."""
    dev = dict(dev)
    pfb = dev.pop("pfb", None)
    tree = convert.tree_from_numpy(dev, st.device)
    if pfb is not None:
        tree["pfb"] = {r: convert.planes_to_c64(p, st.device)
                       for r, p in pfb.items()}
    st.set_device_state(tree)


def save_classic_checkpoint(st, path: str, residual=None):
    """Classic-Station counterpart of ``save_station_checkpoint``:
    channelizer carries, per-bank demod states, per-topic audio
    accumulators, hunter scan positions, framers/reassembly/burst rings,
    stats."""
    leaves = convert.tree_leaves(_classic_device_tree(st))
    entries = {f"dev_{i}": np.asarray(x) for i, x in enumerate(leaves)}

    topics = sorted(set(st.framers) | set(st.rt_framers))
    entries["meta_version"] = np.int64(FORMAT_VERSION)
    entries["meta_kind"] = np.asarray("classic")
    entries["meta_topics"] = np.asarray(topics)
    entries["meta_n_dev"] = np.int64(len(leaves))
    entries["meta_fs"] = np.int64(st.cfg.sample_rate)
    if hasattr(st.channelizer, "_dc_state"):
        entries["meta_dc"] = st.channelizer._dc_state.copy()
    for j, t in enumerate(sorted(st._audio_buf)):
        entries[f"abuf{j}"] = np.asarray(st._audio_buf[t], np.float32)
    for j, t in enumerate(sorted(st.hunters)):
        h = st.hunters[t]
        entries[f"hunt{j}"] = np.asarray(
            [h.freq_center, float(h.tries), float(h.scanned_all),
             float(h._dcd)], np.float64)
    _save_topics(st, entries, topics)
    for k, v in vars(st.stats).items():
        entries[f"stat_{k}"] = np.asarray(v)
    if residual is not None:
        entries["meta_residual"] = np.asarray(residual, np.complex64)
    _atomic_savez(path, entries)


def load_classic_checkpoint(st, path: str):
    """Load a classic-Station checkpoint (written by the port or by JAX)
    into a station of the same configuration and backend."""
    with np.load(path, allow_pickle=False) as z:
        if "meta_kind" not in z.files or str(z["meta_kind"]) != "classic":
            raise ValueError("not a classic-Station checkpoint")
        topics = _check_header(z, st)
        if int(z["meta_fs"]) != st.cfg.sample_rate:
            raise ValueError("checkpoint sample_rate mismatch")
        template = _classic_device_tree(st)
        leaves = _device_leaves(z, template)
        _classic_set_device_tree(st, convert.tree_unflatten(template,
                                                            leaves))
        if "meta_dc" in z.files and hasattr(st.channelizer, "_dc_state"):
            st.channelizer._dc_state = np.asarray(z["meta_dc"], np.float32)
        for j, t in enumerate(sorted(st._audio_buf)):
            st._audio_buf[t] = np.asarray(z[f"abuf{j}"], np.float32)
        for j, t in enumerate(sorted(st.hunters)):
            if f"hunt{j}" not in z.files:
                continue   # checkpoint written with hunting disabled
            h = st.hunters[t]
            v = z[f"hunt{j}"]
            h.freq_center = float(v[0])
            h.tries = int(v[1])
            h.scanned_all = bool(v[2])
            h._dcd = bool(v[3])
        _load_topics(st, z, topics)
        _load_stats(st, z)
