"""device_ops_per_frame.encode: Device operations (kernels, copies,
memsets) in the traced window over the pictures coded in it.
"""
from port_bench import readers

UNIT = "ops/frame"
LAYER = "device"
MOVES = "encode_fps"


def read(rec: dict) -> float | None:
    return readers.ops_per_frame(rec, 'encode')
