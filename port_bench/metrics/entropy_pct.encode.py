"""entropy_pct.encode: Share of the stage seconds in the slice writers:
`entropy`.
"""
from port_bench import readers

UNIT = "%"
LAYER = "host selection and entropy"
MOVES = "encode_fps"


def read(rec: dict) -> float | None:
    return readers.stage_pct(rec, lambda k: k == 'entropy')
