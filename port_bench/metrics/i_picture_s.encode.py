"""i_picture_s.encode: Mean host seconds an I picture takes in
EncLib.encode_intra_frame, synchronised (benchmark-side wrapper).
"""
from port_bench import readers

UNIT = "s"
LAYER = "sequence"
MOVES = "encode_fps"


def read(rec: dict) -> float | None:
    return readers.mean_picture_s(rec, 'encode', 'I')
