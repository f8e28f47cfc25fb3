"""parse_pct.decode: Share of the decoder's stage seconds (utils/profiling.py's
`parse`, `recon`, `filters`, `hash`, each synchronised) in `parse`:
the CABAC parse and the host grid work up to the upload.
"""
from port_bench import spantable

UNIT = "%"
LAYER = "decoder"
MOVES = "decode_fps"


def read(rec: dict) -> float | None:
    return spantable.decode_stage_pct(rec, 'parse')
