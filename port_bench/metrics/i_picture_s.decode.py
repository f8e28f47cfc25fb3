"""i_picture_s.decode: Mean host seconds an I slice takes in
DecLib._decode_i, synchronised (benchmark-side wrapper).
"""
from port_bench import readers

UNIT = "s"
LAYER = "decoder"
MOVES = "decode_fps"


def read(rec: dict) -> float | None:
    return readers.mean_picture_s(rec, 'decode', 'I')
