"""device_ops_per_frame.decode: Device operations (kernels, copies,
memsets) in the traced window over the pictures decoded in it.
"""
from port_bench import readers

UNIT = "ops/frame"
LAYER = "device"
MOVES = "decode_fps"


def read(rec: dict) -> float | None:
    return readers.ops_per_frame(rec, 'decode')
