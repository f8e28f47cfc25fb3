"""host_waits_per_frame.encode: Times the host waited on the device inside
the program's spans in the traced unit (its `host_waits` counter, read
through PyTorch's sync debug mode), over the unit's pictures.
"""
from port_bench import spantable

UNIT = "waits/frame"
LAYER = "device"
MOVES = "encode_fps"


def read(rec: dict) -> float | None:
    return spantable.host_waits_per_frame(rec, 'encode')
