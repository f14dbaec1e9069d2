"""P-channel SU-type dispatch: routes signal units to reassembly/parsing and
pretty-prints system-table broadcasts.

Behavioral equivalent of the SU switch in AeroL::Decode
(ref: decode/aerol.cpp:1573-1956): message-type names from the AEROTypeP enum
(ref: decode/aerol.h:50-102), Psmc/Rsmc frequency decode (chan*0.0025+1510
MHz, aerol.cpp:1598-1647), satellite-identification broadcast
(aerol.cpp:1657-1723), P/R-channel control (aerol.cpp:1820-1897) and
C-channel assignments (rx 1510 / tx 1611.5 MHz bases, aerol.cpp:2053-2097).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from aero_tpu_torch.protocol.isu import ISUData, ACARSItem
from aero_tpu_torch.protocol.acars import ParserISU

P_MESSAGE_NAMES = {
    0x00: "Reserved_0",
    0x01: "Fill_in_signal_unit",
    0x05: "AES_system_table_broadcast_GES_Psmc_and_Rsmc_channels_COMPLETE",
    0x07: "AES_system_table_broadcast_GES_beam_support_COMPLETE",
    0x0A: "AES_system_table_broadcast_index",
    0x0C: "AES_system_table_broadcast_satellite_id_COMPLETE",
    0x10: "Log_on_request",
    0x11: "Log_on_confirm",
    0x12: "Log_control_P_channel_log_off_request",
    0x13: "Log_control_P_channel_log_on_reject",
    0x14: "Log_control_P_channel_log_on_interrogation",
    0x15: "Log_on_log_off_acknowledge_P_channel",
    0x16: "Log_control_P_channel_log_on_prompt",
    0x17: "Log_control_P_channel_data_channel_reassignment",
    0x18: "Reserved_18",
    0x19: "Reserved_19",
    0x26: "Reserved_26",
    0x21: "Call_announcement",
    0x28: "Data_EIRP_table_broadcast_complete_sequence",
    0x30: "Call_progress",
    0x31: "C_channel_assignment_distress",
    0x32: "C_channel_assignment_flight_safety",
    0x33: "C_channel_assignment_other_safety",
    0x34: "C_channel_assignment_non_safety",
    0x40: "P_R_channel_control_ISU",
    0x41: "T_channel_control_ISU",
    0x51: "T_channel_assignment",
    0x61: "Request_for_acknowledgement_RQA_P_channel",
    0x62: "Acknowledge_RACK_TACK_P_channel",
    0x71: "User_data_ISU_RLS_P_T_channel",
    0x74: "User_data_3_octet_LSDU_RLS_P_channel",
    0x76: "User_data_4_octet_LSDU_RLS_P_channel",
}

_P_BITRATES = {0: 600, 1: 1200, 2: 2400, 3: 4800, 4: 6000, 5: 5250,
               6: 10500, 7: 8400, 9: 21000}


@dataclass
class CChannelAssignment:
    AESID: int = 0
    GESID: int = 0
    receive_freq: float = 0.0
    transmit_freq: float = 0.0
    receive_spotbeam: bool = False
    transmit_spotbeam: bool = False
    type: int = 0


def create_c_assignment(su: bytes) -> CChannelAssignment:
    """ref: aerol.cpp:2053-2097."""
    item = CChannelAssignment(type=su[0])
    item.AESID = su[1] << 16 | su[2] << 8 | su[3]
    item.GESID = su[4]
    b7, b8, b9, b10 = su[6], su[7], su[8], su[9]
    item.receive_freq = (((b7 & 0x7F) << 8) | b8) * 0.0025 + 1510.0
    item.transmit_freq = (((b9 & 0x7F) << 8) | b10) * 0.0025 + 1611.5
    item.receive_spotbeam = bool(b7 & 0x80)
    item.transmit_spotbeam = bool(b9 & 0x80)
    return item


class PChannelSUDispatcher:
    """Consumes CRC-valid 12-byte SUs from decoded P-channel frames; routes
    user data into ISU reassembly -> ACARS parse, emits display lines and
    C-channel assignment events.
    """

    def __init__(self, on_acars: Callable | None = None,
                 on_fragment: Callable | None = None,
                 on_error: Callable | None = None,
                 on_c_assignment: Callable | None = None,
                 downlink: bool = False,
                 do_not_display: tuple = (),
                 db=None):
        self.isudata = ISUData()
        self.parser = ParserISU(on_acars, on_fragment, on_error, db=db)
        self.parser.downlink = downlink
        self.on_c_assignment = on_c_assignment or (lambda item: None)
        self.do_not_display = set(do_not_display)

    def reset(self):
        self.isudata.reset()

    def dispatch(self, su: bytes) -> str:
        """Process one 12-byte SU (CRC already verified); returns the display
        line ('' if suppressed)."""
        message = su[0]
        hexpart = " ".join(f"0x{b:02X}" for b in su[:10])
        name = P_MESSAGE_NAMES.get(message)
        extra = ""

        if message == 0x05:
            extra = self._psmc_rsmc(su)
        elif message == 0x0C:
            extra = self._satellite_id(su)
        elif message == 0x11:
            item = ACARSItem()
            item.isuitem.AESID = su[1] << 16 | su[2] << 8 | su[3]
            item.isuitem.GESID = su[4]
            item.hastext = item.downlink = item.nonacars = item.valid = True
            item.message = "Log on confirm"
            self.parser.on_acars(item)
        elif message in (0x31, 0x32, 0x33, 0x34):
            self.on_c_assignment(create_c_assignment(su))
            self._send_assignment_text(su, name)
        elif message == 0x21:
            self._send_assignment_text(su, name)
        elif message == 0x40:
            extra = self._pr_channel_control(su)
        elif message == 0x71:
            self.isudata.update(su[:10])
        elif name is None and (message & 0xC0) == 0xC0:
            name = "SSU"
            done = self.isudata.update(su[:10])
            if done is not None:
                self.parser.parse(done)
            elif self.isudata.missingssu:
                extra = " missing"

        if name is None:
            name = ""
        if ((message & 0xC0) == 0xC0 and 0xC0 in self.do_not_display) or \
                message in self.do_not_display:
            return ""
        return f"{hexpart} {name}{extra}"

    # ---- system table decoders ----

    def _psmc_rsmc(self, su: bytes) -> str:
        """ref: aerol.cpp:1585-1647."""
        b3, ges = su[2], su[3]
        ch = [su[4] << 8 | su[5], su[6] << 8 | su[7], su[8] << 8 | su[9]]
        freqs = [c * 0.0025 + 1510.0 for c in ch]
        seqno = (b3 >> 2) & 0x3F
        lsu = b3 & 0x03
        if lsu <= 1:
            return (f" Seq = {seqno} GES = {ges:02X} --> Psmc  = "
                    f"{freqs[0]:.4f}MHz (RX), Rsmc0 = {freqs[1] + 101.5:.4f}MHz"
                    f" (TX), Rsmc1 = {freqs[2] + 101.5:.4f}MHz (TX)")
        base = 2 if lsu == 2 else 5
        f = [x + 101.5 for x in freqs]
        return (f" Seq = {seqno} GES = {ges:02X} --> Rsmc{base} = "
                f"{f[0]:.4f}MHz (TX), Rsmc{base+1} = {f[1]:.4f}MHz (TX), "
                f"Rsmc{base+2} = {f[2]:.4f}MHz (TX)")

    def _satellite_id(self, su: bytes) -> str:
        """ref: aerol.cpp:1657-1723."""
        b3, b4 = su[2], su[3]
        longitude = su[5] * 1.5
        b7, b8, b9, b10 = su[6], su[7], su[8], su[9]
        ch1 = ((b7 & 0x7F) << 8) | b8
        ch2 = ((b9 & 0x7F) << 8) | b10
        f1 = ch1 * 0.0025 + 1510.0
        f2 = ch2 * 0.0025 + 1510.0
        sb1 = " (Spot beam)" if b7 & 0x80 else ""
        sb2 = " (Spot beam)" if b9 & 0x80 else ""
        seqno = (b3 >> 2) & 0x3F
        satid = ((b3 << 4) & 0x30) | ((b4 >> 4) & 0x0F)
        lon = (f"{360.0 - longitude:g}W" if longitude > 180.0
               else f"{longitude:g}E")
        if ch2 != 0:
            return (f" SATELLITE ID = {satid} (Long {lon}) Seq = {seqno} "
                    f"Psmc1 = {f1:.4f}MHz{sb1} Psmc2 = {f2:.4f}MHz{sb2}")
        return (f" SATELLITE ID = {satid} (Long {lon}) Seq = {seqno}  "
                f"Psmc1 = {f1:.4f}MHz{sb1}")

    def _pr_channel_control(self, su: bytes) -> str:
        """ref: aerol.cpp:1820-1897."""
        ges = su[4]
        b8, b9, b10 = su[7], su[8], su[9]
        channel = ((b9 & 0x7F) << 8) | b10
        freq = channel * 0.0025 + 1510.0
        bitrate = _P_BITRATES.get((b8 >> 4) & 0x0F, -1)
        spot = " (Spot beam)" if b9 & 0x80 else ""
        return f" GES = {ges:02X} Pd = {freq:.3f}MHz at {bitrate}bps{spot}"

    def _send_assignment_text(self, su: bytes, name: str):
        """ref SendCAssignment: aerol.cpp:2099-2128."""
        item = ACARSItem()
        item.isuitem.AESID = su[1] << 16 | su[2] << 8 | su[3]
        item.isuitem.GESID = su[4]
        item.hastext = item.downlink = item.nonacars = item.valid = True
        b7, b8, b9, b10 = su[6], su[7], su[8], su[9]
        rx = (((b7 & 0x7F) << 8) | b8) * 0.0025 + 1510.0
        tx = (((b9 & 0x7F) << 8) | b10) * 0.0025 + 1611.5
        beam = " Spot Beam " if b7 & 0x80 else " Global Beam "
        item.message = (f"Receive Freq: {rx:.4f}{beam}Transmit {tx:.4f}\r\n"
                        f"{name}")
        self.parser.on_acars(item)
