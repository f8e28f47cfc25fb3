"""select_pct.encode: Share of the stage seconds in the host selection
loops and their pulls: `*select*+pull`.
"""
from port_bench import readers

UNIT = "%"
LAYER = "host selection and entropy"
MOVES = "encode_fps"


def read(rec: dict) -> float | None:
    return readers.stage_pct(rec, lambda k: 'select' in k)
