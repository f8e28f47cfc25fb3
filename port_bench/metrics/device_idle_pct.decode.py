"""device_idle_pct.decode: 100 x (1 - the union of the device operations'
intervals over the traced window).
"""
from port_bench import readers

UNIT = "%"
LAYER = "device"
MOVES = "decode_fps"


def read(rec: dict) -> float | None:
    return readers.idle_pct(rec, 'decode')
