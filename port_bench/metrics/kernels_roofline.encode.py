"""kernels_roofline.encode: Summed least time (counts.py, from each
launch's arguments) over summed device time of the port's kernels K1-K6,
D1, D2 in the traced window.
"""
from port_bench import readers

UNIT = "%"
LAYER = "kernels"
MOVES = "encode_fps"


def read(rec: dict) -> float | None:
    return readers.roofline_pct(rec, 'encode')
