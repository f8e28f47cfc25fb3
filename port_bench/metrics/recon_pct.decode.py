"""recon_pct.decode: Share of the decoder's stage seconds (utils/profiling.py's
`parse`, `recon`, `filters`, `hash`, each synchronised) in `recon`:
the upload, prediction, residual and boundary strengths.
"""
from port_bench import spantable

UNIT = "%"
LAYER = "decoder"
MOVES = "decode_fps"


def read(rec: dict) -> float | None:
    return spantable.decode_stage_pct(rec, 'recon')
