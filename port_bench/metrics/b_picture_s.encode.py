"""b_picture_s.encode: Mean host seconds a B picture takes in
EncLib.encode_b_frame, synchronised (benchmark-side wrapper).
"""
from port_bench import readers

UNIT = "s"
LAYER = "sequence"
MOVES = "encode_fps"


def read(rec: dict) -> float | None:
    return readers.mean_picture_s(rec, 'encode', 'B')
