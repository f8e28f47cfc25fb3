"""device_idle_pct.encode: 100 x (1 - the union of the device operations'
intervals over the traced window).
"""
from port_bench import readers

UNIT = "%"
LAYER = "device"
MOVES = "encode_fps"


def read(rec: dict) -> float | None:
    return readers.idle_pct(rec, 'encode')
