"""mm_search_pct.encode: Share of the stage seconds in the multi-model
search and finish: `mm_search`, `mm_search_b`, `mm_finish`,
`mm_finish_b`.
"""
from port_bench import readers

UNIT = "%"
LAYER = "MM search"
MOVES = "encode_fps"


def read(rec: dict) -> float | None:
    return readers.stage_pct(rec, lambda k: k.startswith(('mm_search', 'mm_finish')))
