"""One cell, one run: the fused station of ``aero_tpu_torch`` on a card.

    python3 -m aerobench.run --workload lband50.busy --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names its configuration (``aerobench/configs/<name>.json``)
and its traffic mix (``aerobench/traffic/<name>.json``); a per-layer
metric is read by ``aerobench/metrics/<name>.py``.  Nothing here is
particular to a cell.

The run builds the station as ``station_main --backend fused
--batch-framing --ingest-dtype int4 --device cuda`` builds it (the
configuration's ``station`` flags), makes the traffic on the card from the
seed, warms up by feeding whole passes of the capture until no graph is
captured in a pass, and then measures for ``--seconds``: closed loop
(blocks fed as fast as the station takes them, the capture replayed as
``station_main --loop`` replays a file) or paced (block i fed at its due
time (i+1) x block_len / fs after the start, on a schedule that does not
slow when the station does).  The window drives ``FusedStation.process``
with complex64 blocks: quantize, upload, graph replay, drain, batched P
decode, burst watchers, framers and the jsondump output.  Then a few more
blocks and a flush let what is due in the window come out, and
``check.py`` decides ``correct``.

With ``--trace 1`` the same run reports the per-layer metrics instead of
the end-to-end ones, from the probe's spans and a profiler stretch.

The last line on stdout is one JSON object: correct, attempted, failed,
metrics, device, breakdown (traced runs) and checks (each number
compared, with its limit).  ``attempted`` counts the messages, voice
frames and packets due in the window's blocks and the P frames whose
batched decode was compared; ``failed`` those that did not come out or
whose decode differs.  Without a card, or with fewer cards than the
cell asks for, the run exits 3 and prints no result; it exits 4 and
prints no result if ``jax``, ``jaxlib``, ``flax`` or the JAX package
``aero_tpu`` is loaded once the window has closed; it exits 5 and prints
no result, before any window, if the program refuses a keyword of the
configuration's ``station_args``.

A configuration may carry two optional keys.  ``reference`` names the
module ``aerobench/ref/<reference>.py`` whose ``RefStation`` the run is
held to (``step`` unless it names another; a copy keeps ``step``'s wire
layout and imports nothing of the program).  ``station_args`` holds
keywords that go to ``FusedStation`` as they stand, after the flags of
``station``, so that a program without the feature a configuration
needs refuses it at once.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
from array import array  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from aerobench import check, traffic  # noqa: E402
from aerobench.probe import Probe  # noqa: E402
from aerobench.trace import (Stretch, Trace, device_ops,  # noqa: E402
                             warm_profiler)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
BANNED = ("jax", "jaxlib", "flax", "aero_tpu")
COMPARE_S = 4.0          # radio seconds of blocks compared with the reference
TAIL_BLOCKS = 3          # blocks fed after the window, so its due items end
MAX_WARM_PASSES = 6
# the profiled stretch of a traced window: a closed loop runs ~60 blocks
# in 2 s, a paced one 7 blocks in 5 s
STRETCH_S = {"closed": 2.0, "paced": 5.0}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT):
    """(BENCHMARK.json, the cell, its configuration, its mix)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = load_json(os.path.join(HERE, "configs", cell["config"] + ".json"))
    mix = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    return bench, cell, cfg, mix


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The cell's metrics: end-to-end without a trace, per-layer with."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read(trace, run) -> float | None``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"aerobench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``aero_tpu_torch`` is not ``aero_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def reference_of(cfg: dict):
    """The ``RefStation`` class the configuration is held to: that of
    ``aerobench/ref/<cfg["reference"]>.py``, ``step`` by default."""
    mod = importlib.import_module(
        "aerobench.ref." + cfg.get("reference", "step"))
    return mod.RefStation


class Refused(Exception):
    """The program cannot build the configuration: its station refused a
    keyword of ``station_args``."""


def build_station(cfg: dict, on_acars, on_voice, device):
    """The station as ``station_main.mk_station`` builds it for the
    configuration's flags, then its ``station_args``; raises ``Refused``
    where the station refuses one of those."""
    from aero_tpu_torch.channelizer import load_ini
    from aero_tpu_torch.runtime.fused_station import FusedStation
    flags = cfg["station"]
    extra = cfg.get("station_args", {})
    try:
        return FusedStation(load_ini(traffic.ini_text(cfg), is_text=True),
                            on_acars=on_acars, on_voice=on_voice,
                            station_id=flags["station_id"],
                            ingest_dtype=flags["ingest_dtype"],
                            hunt=flags["hunt"],
                            pipeline_depth=flags["pipeline_depth"],
                            blocks_per_step=flags["blocks_per_step"],
                            batch_host_framing=flags["batch_framing"],
                            device=device, **extra)
    except (TypeError, ValueError) as e:
        if not extra:
            raise
        raise Refused(str(e)) from e


def captures(st) -> int:
    """Graphs captured so far by the station's steps and its drains'."""
    n = st.captures
    n += sum(b._decode.captures for b in st._batch_banks.values())
    for dm in st.burst_demods.values():
        n += sum(s.captures for s in (dm._envelope, dm._autocorr_rho,
                                      dm._window_fn))
    return n


class Sink:
    """Outputs as they come: topic, payload, the block being drained and
    the time, in flat lists and arrays."""

    def __init__(self):
        self.topics, self.payloads = [], []
        self.blocks, self.times = array("q"), array("d")

    def add(self, topic: str, payload, block: int) -> None:
        self.topics.append(topic)
        self.payloads.append(payload)
        self.blocks.append(block)
        self.times.append(time.perf_counter())

    def __len__(self) -> int:
        return len(self.topics)

    def rows(self):
        return zip(self.topics, self.payloads, self.blocks, self.times)


def _tally(items, top: int = 20) -> list:
    """The most common items with their counts."""
    from collections import Counter
    return [[list(k), n] for k, n in Counter(items).most_common(top)]


def _quantile(sorted_v: list, q: float) -> float:
    """Nearest-rank quantile of a sorted list."""
    return sorted_v[max(0, math.ceil(q * len(sorted_v)) - 1)]


class WindowHost:
    """What the host did in the window, beside the metrics: the cores'
    time the process used over the window's wall time, the garbage
    collector's pauses, and the rate of drained blocks in each fifth of
    the window."""

    def __init__(self):
        self.gc_s, self.gc_n, self._t = 0.0, 0, 0.0
        self.cpu0 = time.process_time()
        gc.callbacks.append(self._gc)
        self.readings = {}

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.gc_n += 1

    def close(self, t0: float, t1: float, drains: list, block_s: float):
        cpu = time.process_time() - self.cpu0
        gc.callbacks.remove(self._gc)
        w = t1 - t0
        fifths = [0] * 5
        for t in drains:
            if t0 <= t < t1:
                fifths[min(4, int(5 * (t - t0) / w))] += 1
        self.readings = {
            "cpu_share": cpu / w,
            "gc_s": self.gc_s, "gc_n": self.gc_n,
            "rate_by_fifth": [n * block_s / (w / 5) for n in fifths],
            "cpus": len(os.sched_getaffinity(0)),
            "threads": torch.get_num_threads()}


def run_cell(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device, metric_specs=(), t_process=None) -> dict:
    """One run of a cell on ``device``; returns the result line as a
    dict (``metrics`` holds the cell's metrics that have something to
    read)."""
    from aero_tpu_torch.device import set_fp32_precision
    from aero_tpu_torch.io.output import to_output_format
    from aero_tpu_torch.protocol.acars_apps import enrich

    device = torch.device(device)
    cuda = device.type == "cuda"
    t_process = T_PROCESS if t_process is None else t_process
    set_fp32_precision()
    tr = traffic.make(cfg, mix, seed, device)
    L, nb, fs = tr.block_len, tr.blocks, cfg["sample_rate"]
    block_dur = L / fs
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    station_id = cfg["station"]["station_id"]
    # what comes out, kept flat (strings, bytes and arrays of numbers are
    # not tracked by the garbage collector, so the record adds nothing to
    # the station's collections in the window)
    lines = Sink()
    voices = Sink()
    box = {}
    voice_f = None
    if cfg["station"]["voice_out"]:      # station_main --voice-out, TMPDIR
        voice_f = tempfile.NamedTemporaryFile(prefix="aerobench-voice-",
                                              suffix=".bin")

    def on_acars(topic, item):
        enrich(item)
        lines.add(topic, to_output_format("jsondump", station_id, False,
                                          item), box["probe"].block)

    def on_voice(topic, data, hex_aes):
        if voice_f is not None:
            voice_f.write(data)
            voice_f.flush()
        voices.add(topic, bytes(data), box["probe"].block)

    st = build_station(cfg, on_acars, on_voice, device)
    n_cmp = max(1, math.ceil(COMPARE_S / block_dur))
    probe = box["probe"] = Probe(st, trace, keep_blocks=range(n_cmp))

    def block(g: int) -> np.ndarray:
        k = g % nb
        return tr.iq[k * L:(k + 1) * L]

    # warm-up: whole passes until one captures no graph
    g = 0
    for p in range(MAX_WARM_PASSES):
        before = captures(st)
        for _ in range(nb):
            st.process(block(g))
            g += 1
        st.flush()
        if p >= 1 and captures(st) == before:
            break
    if cuda:
        torch.cuda.synchronize()
    snapshot = st._state
    g0 = g
    probe.keep |= set(range(g0, g0 + n_cmp))
    probe.spans.clear()
    probe.events.clear()
    probe.launches.clear()
    cap0 = captures(st)
    if trace:
        warm_profiler(cuda)
    setup_s = time.perf_counter() - t_process

    # the window
    tr_out = Trace(kind=torch.cuda.get_device_name(device) if cuda
                   else "cpu")
    due_time, late = {}, []
    loop = mix["loop"]
    t0 = time.perf_counter()
    stretch = (Stretch(cuda, t0 + 0.4 * seconds,
                       min(STRETCH_S[loop], 0.5 * seconds))
               if trace else None)
    d0 = probe.drained
    host = WindowHost()
    if loop == "closed":
        t_end = t0 + seconds
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            if stretch is not None:
                stretch.tick(now)
            st.process(block(g))
            g += 1
        t1 = time.perf_counter()
        n_drained = probe.drained - d0
        last = g
        for _ in range(TAIL_BLOCKS):
            st.process(block(g))
            g += 1
    else:
        rate = float(mix.get("rate", 1.0))
        dur = block_dur / rate
        n_w = int(seconds / dur)
        for i in range(n_w + TAIL_BLOCKS):
            due = t0 + (i + 1) * dur
            now = time.perf_counter()
            if now < due:
                time.sleep(due - now)
            late.append(max(0.0, time.perf_counter() - due))
            if stretch is not None:
                stretch.tick(due)
            due_time[g] = due
            st.process(block(g))
            g += 1
            if i == n_w - 1:
                t1 = time.perf_counter()
        n_drained = 0
        last = g0 + n_w
    host.close(t0, t1, [probe.drain_start[b] for b in range(g0, last)
                        if b in probe.drain_start], block_dur)
    if stretch is not None and stretch.t1 is None:
        stretch.stop()
    st.flush()
    if cuda:
        torch.cuda.synchronize()
    t_done = time.perf_counter()
    cap_window = captures(st) - cap0
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    banned = banned_modules()

    # the traced run's readings, then the program's state goes
    if trace:
        tr_out.spans = {k: list(v) for k, v in probe.spans.items()}
        tr_out.step_ms = probe.step_ms()
        tr_out.queue_s = [probe.drain_start[b] - due_time[b]
                          for b in range(g0, last) if b in due_time]
        stretch.reduce(tr_out, probe.launches)
    rows, decodes, packets = probe.rows, probe.decodes, probe.packets
    vfos = [(v.topic, v.offset_hz, v.data_rate, v.burst)
            for v in traffic.bank(cfg)]
    ingest = cfg["station"]["ingest_dtype"]
    del st, probe, box
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if voice_f is not None:
        voice_f.close()                 # and deleted

    # what came out against what the traffic carries
    emitted = [("acars", t, check.acars_key(line), b, te)
               for t, line, b, te in lines.rows()]
    emitted += [("voice", t, data, b, te) for t, data, b, te in voices.rows()]
    emitted += [(kind, t, info[:17] if kind == "R" else info[:4], b, None)
                for b, t, kind, info in packets]
    emitted.sort(key=lambda e: e[3])
    res = check.match(tr, emitted, g0, last)
    miss = check.missing(res)

    # the device step against the reference, and the batched decodes
    ref = reference_of(cfg)(vfos, fs, ingest, hunt=cfg["station"]["hunt"],
                            device=device)
    pairs = []
    streams = {}
    for start, s in ((0, ref.init_state()), (g0, ref.adopt(snapshot))):
        got, want = [], []
        for b in range(start, start + n_cmp):
            if b not in rows:       # a window shorter than the comparison
                break
            s, p = ref.step(s, block(b))
            got.append(rows[b])
            want.append(p.cpu().numpy())
        pairs += zip(got, want)
        both = (check.p_streams(ref, got), check.p_streams(ref, want))
        streams.update({start + k: both + (k, len(got))
                        for k in range(len(got))})
    del s, snapshot
    step_nums = check.compare_packed(ref, pairs)
    dec = check.compare_decodes(decodes, streams)
    limits = cfg["limits"]
    checks = {"missing": (len(miss), 0),
              "unplanted": (len(res["unplanted"]), 0),
              "voice_disorder": (res["disorder"], 0),
              "decode_bits": (dec["decode_bits"], 0),
              "decode_sus": (dec["decode_sus"], 0),
              "decode_unfound": (dec["decode_unfound"], 0)}
    for k, lim in limits.items():
        checks[k] = (step_nums[k], lim)
    correct = all(v <= lim for v, lim in checks.values())

    # end-to-end or per-layer metrics
    metrics = {}
    run = {"setup_s": setup_s, "window_s": t1 - t0,
           "drained": n_drained, "block_s": block_dur}
    if loop == "paced":
        lat = []
        for e, b in res["attempted"]:
            if e.kind != "acars":
                continue
            hit = res["matched"].get((e.kind, e.topic, e.key, b))
            lat.append((hit[1] if hit else t_done) - due_time[b])
        lat.sort()
        if lat:
            run["emit_p50_ms"] = 1e3 * _quantile(lat, 0.50)
            run["emit_p95_ms"] = 1e3 * _quantile(lat, 0.95)
        run["late_ms"] = [1e3 * x for x in late]
    else:
        run["realtime_x"] = n_drained * block_dur / (t1 - t0)
    for m in metric_specs:
        if trace:
            v = reader(m["name"])(tr_out, run)
        else:
            v = run.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": tr_out.kind, "count": 1,
           "memory_peak_bytes": int(memory_peak)}
    if trace:
        dev["busy_s"] = tr_out.busy_s
        dev["window_s"] = tr_out.window_s
    # every answer judged one by one: the items due in the window, and the
    # P frames whose decode was held against the plain Viterbi
    out = {"correct": bool(correct and not banned),
           "attempted": (len(res["attempted"]) + dec["frames"]
                         + dec["decode_unfound"]),
           "failed": len(miss) + dec["bad"] + dec["decode_unfound"],
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = {"device_ops": device_ops(tr_out),
                            "idle_gaps": [[k, v]
                                          for k, v in tr_out.idle_gaps]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    info = {"banned": banned, "captures_in_window": cap_window,
            "warm_blocks": g0, "window_blocks": last - g0,
            "compared_blocks": [list(range(n_cmp)),
                                list(range(g0, g0 + n_cmp))],
            "decoded_frames": dec["frames"],
            "decode_diffs": dec["diffs"],
            "step_numbers": step_nums,
            "missing_by": _tally((e.topic, e.kind) for e, b in miss),
            "missing_at": _tally((e.topic, e.kind, e.due) for e, b in miss),
            "unplanted_by": _tally((t, k) for k, t, _, d
                                   in res["unplanted"]),
            "outputs": {"acars": len(lines), "voice": len(voices),
                        "packets": len(packets)},
            "window_host": host.readings,
            "setup_s": setup_s}
    if late:
        info["feeder_late_ms"] = {"max": 1e3 * max(late),
                                  "mean": 1e3 * sum(late) / len(late),
                                  "over_1ms": sum(x > 1e-3 for x in late)}
    return out, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="aerobench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, cfg, mix = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"aerobench: the cell needs {cell['chips']} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"device_count {torch.cuda.device_count()}")
        return 3
    specs = metrics_of(bench, cell["name"], bool(args.trace))
    try:
        out, info = run_cell(cell, cfg, mix, args.seed, args.seconds,
                             bool(args.trace), "cuda", specs)
    except Refused as e:
        log(f"aerobench: the program cannot build configuration "
            f"{cfg['name']}: {e}")
        return 5
    log("aerobench: " + json.dumps(info))
    if info["banned"]:
        log(f"aerobench: modules of JAX or the JAX package loaded: "
            f"{info['banned']}")
        return 4
    for k, c in out["checks"].items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
