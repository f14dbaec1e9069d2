"""SDRReceiver-compatible INI configuration.

Behavioral equivalent of Publisher::loadSettings
(ref: publish/publisher.cpp:55-227): top-level keys ``sample_rate``,
``center_frequency``, ``mix_offset``, ``zmq_address``, ``correct_dc_bias``;
``main_vfos`` array (frequency / out_rate / zmq_address / zmq_topic /
compress_scale); ``vfos`` array (frequency / data_rate / out_rate / topic /
filter_bandwidth / gain).  Sub VFOs attach to the nearest main VFO by
frequency; decimation counts are log2 ratios with the x5/x6 late-decimate
cases (publisher.cpp:183-210).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

VALID_SAMPLE_RATES = (288000, 1536000, 1920000)  # ref: publish/publisher.h:32


@dataclass(frozen=True)
class MainVfoConfig:
    freq: int                  # absolute RF Hz
    out_rate: int
    topic: str = ""
    zmq_address: str = ""
    compress_scale: int = 1
    decim_count: int = 0


@dataclass(frozen=True)
class SubVfoConfig:
    topic: str
    freq: int                  # absolute RF Hz (mix_offset applied)
    out_rate: int
    data_rate: int = 0
    filter_bw: int = 0
    gain: float = 0.01
    main_idx: int = 0
    decim_count: int = 0
    late_decimate: int = 0     # 0, 5 or 6
    burst: bool = False        # aero-tpu extension: R/T burst VFO


@dataclass
class ChannelizerConfig:
    sample_rate: int
    center_frequency: int
    zmq_address: str = ""
    correct_dc_bias: bool = False
    mix_offset: int = 0
    mains: list = field(default_factory=list)
    subs: list = field(default_factory=list)

    @property
    def buflen_complex(self) -> int:
        """Reader block length in complex samples (publisher.cpp:92-100:
        2*Fs/4 floats, or /5 to hit a multiple of 512)."""
        if ((2 * self.sample_rate) // 4) % 512 > 0:
            return (2 * self.sample_rate) // 5 // 2
        return (2 * self.sample_rate) // 4 // 2


def _parse_qsettings_ini(text: str) -> dict:
    """Parse a QSettings-style INI: sections, plain keys, and
    ``N\\key=value`` array entries with a ``size`` key."""
    root: dict = {"": {}}
    section = ""
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith((";", "#")):
            continue
        if line.startswith("[") and line.endswith("]"):
            section = line[1:-1].strip()
            root.setdefault(section, {})
            continue
        if "=" not in line:
            continue
        key, _, val = line.partition("=")
        root[section][key.strip()] = val.strip()
    return root


def _read_array(section: dict) -> list[dict]:
    size = int(section.get("size", 0))
    out = []
    for i in range(1, size + 1):
        prefix = f"{i}\\"
        out.append({k[len(prefix):]: v for k, v in section.items()
                    if k.startswith(prefix)})
    return out


def load_ini(path_or_text: str, is_text: bool = False) -> ChannelizerConfig:
    if is_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    ini = _parse_qsettings_ini(text)
    top = ini.get("General", ini.get("", {}))
    # QSettings puts top-level keys in "General"; accept either
    merged = {**ini.get("", {}), **ini.get("General", {})}

    fs = int(merged.get("sample_rate", 0))
    if fs not in VALID_SAMPLE_RATES:
        raise ValueError(f"unsupported sample_rate {fs} "
                         f"(valid: {VALID_SAMPLE_RATES})")
    cfg = ChannelizerConfig(
        sample_rate=fs,
        center_frequency=int(merged.get("center_frequency", 0)),
        zmq_address=merged.get("zmq_address", ""),
        correct_dc_bias=merged.get("correct_dc_bias", "0") == "1",
        mix_offset=int(merged.get("mix_offset", 0) or 0),
    )

    for m in _read_array(ini.get("main_vfos", {})):
        freq = int(m.get("frequency", 0))
        out_rate = int(m.get("out_rate", fs))
        ratio = fs // out_rate
        cfg.mains.append(MainVfoConfig(
            freq=freq,
            out_rate=out_rate,
            topic=m.get("zmq_topic", ""),
            zmq_address=m.get("zmq_address", ""),
            compress_scale=max(1, int(m.get("compress_scale", 0) or 0)),
            decim_count=0 if ratio == 1 else int(math.log2(ratio)),
        ))

    for v in _read_array(ini.get("vfos", {})):
        freq = int(v.get("frequency", 0)) + cfg.mix_offset
        data_rate = int(v.get("data_rate", 0) or 0)
        out_rate = int(v.get("out_rate", 0) or 0)
        if out_rate == 0 and data_rate > 0:
            out_rate = {600: 12000, 1200: 24000}.get(data_rate, 48000)

        # attach to the nearest main VFO (publisher.cpp:183-193);
        # -1 = no matching main, channelize directly from the wideband input
        main_idx, main_out = -1, fs
        for a, mv in enumerate(cfg.mains):
            if abs(mv.freq - freq) < mv.out_rate:
                main_idx, main_out = a, mv.out_rate
                break

        late = 0
        if main_out // 48000 == 5:
            late = 5
        elif main_out // 48000 == 6:
            late = 6
        if late:
            decim = int(math.log2(main_out // (late * out_rate)))
        else:
            decim = int(math.log2(fs // out_rate)) - int(math.log2(fs // main_out))

        cfg.subs.append(SubVfoConfig(
            topic=v.get("topic", ""),
            freq=freq,
            out_rate=out_rate,
            data_rate=data_rate,
            filter_bw=int(v.get("filter_bandwidth", 0) or 0),
            gain=float(v.get("gain", 1) or 1) / 100.0,
            main_idx=main_idx,
            decim_count=decim,
            late_decimate=late,
            burst=v.get("burst", "0") == "1",
        ))
    return cfg
