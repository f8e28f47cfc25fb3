"""b_picture_s.decode: Mean host seconds a B slice takes in
DecLib._decode_b_mm, synchronised (benchmark-side wrapper).
"""
from port_bench import readers

UNIT = "s"
LAYER = "decoder"
MOVES = "decode_fps"


def read(rec: dict) -> float | None:
    return readers.mean_picture_s(rec, 'decode', 'B')
