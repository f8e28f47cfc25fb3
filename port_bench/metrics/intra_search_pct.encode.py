"""intra_search_pct.encode: Share of the port's stage seconds
(utils/profiling.py, each stage synchronised) in `intra_search`: the
wavefront of the I picture.
"""
from port_bench import readers

UNIT = "%"
LAYER = "I picture"
MOVES = "encode_fps"


def read(rec: dict) -> float | None:
    return readers.stage_pct(rec, lambda k: k == 'intra_search')
