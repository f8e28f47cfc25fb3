"""The least time of a launch of the port's hand-written kernels.

Frozen from `chip_smoke.py` (`bound_ms`, `mc_bound`, `search_bound`,
`dq_bound`, `sphere_bound`, the L1 elementwise bound of
`libm_timed_cases`, `SPHERE_OPS`, `LIBM_F64_OPS`) and PERF.md's kernel
table: each input word the launch needs
and each output word once over the memory rate, against its operations
over the rate of the unit that runs them; the larger bounds.  The counts
follow the work the arguments ask for, whatever computes it.  Rates:
NVIDIA's H100 SXM data sheet (3.35 TB/s, 67 TFLOP/s float32 outside the
tensor cores, 34 TFLOP/s float64) and 33.5 T int32 multiply-adds a second (132 SMs x 64 IMAD
a clock x 1.98 GHz x 2 operations, the CUDA C++ Programming Guide's
throughput table for compute capability 9.0).  The card's power limit is
printed beside every reading (`run.py`).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
I32_OPS_PER_S = 33.5e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
NTAPS_LUMA, NTAPS_CHROMA = 8, 4

# L1: float64 operations an element of the elementwise entries on their
# common path (|x| < 120; an FMA two operations; atan2f is float32
# throughout), and the sphere kernel's operations a position, counted in
# csrc/sphere_positions.cu on the common path: (its own float32
# operations, glibc atan2f calls, tanf calls, sinf / cosf calls), by
# (kernel, model family) and form.  An atan2f call takes at least
# ATAN2F_F32 float32 operations, a tanf TANF_F32 and LIBM_F64_OPS["tanf"]
# float64 ones, a sinf or cosf LIBM_F64_OPS["sinf"] float64 ones.
LIBM_F64_OPS = {"sinf": 13, "cosf": 13, "tanf": 4, "atan2f": 0}
ATAN2F_F32, TANF_F32 = 25, 32
SPHERE_OPS = {("sphere_positions", "mpa"): {None: (46, 4, 0, 4),
                                             "merged": (54, 4, 0, 4),
                                             "search": (54, 4, 0, 4)},
              ("sphere_positions", "rot"): {None: (99, 4, 0, 20),
                                             "merged": (111, 4, 0, 12),
                                             "search": (129, 4, 0, 16)},
              ("sphere_centers", "mpa"): {None: (71, 6, 1, 10),
                                           "search": (80, 6, 1, 10)},
              ("sphere_centers", "rot"): {None: (95, 4, 0, 20),
                                           "search": (120, 4, 0, 16)}}
SPHERE_FORMS = {0: None, 1: "merged", 2: "search"}   # the kernel's `form`
RSQRT_TABLE_BYTES = 2048 * 8

# kernel family -> the name its device operations carry in a trace
FAMILY_OF = {"mc_luma_positions": "mc_positions_kernel",
             "mc_chroma_positions": "mc_positions_kernel",
             "sad_block_positions": "band_positions_kernel",
             "mc_block_positions": "band_positions_kernel",
             "sad_luma_positions": "sad_luma",
             "sad_bilinear_positions": "sad_bilinear_positions_kernel",
             "quantize_dep": "quantize_dep_kernel",
             "dequantize_dep": "dequantize_dep_kernel",
             "sinf": "libm_kernel", "cosf": "libm_kernel",
             "tanf": "libm_kernel", "atan2f": "libm_kernel",
             "sphere_positions": "sphere_positions_kernel",
             "sphere_centers": "sphere_centers_kernel"}


def least_s(n_words: int, ops: int, ops_per_s: float = I32_OPS_PER_S
            ) -> float:
    """The larger of 4-byte words over the memory rate and `ops` over
    `ops_per_s`."""
    return max(4 * n_words / HBM_BYTES_PER_S, ops / ops_per_s)


def mc_words_macs(covered_words: int, nsy: int, nsx: int, s: int
                  ) -> tuple[int, int]:
    """K1 (s = 4, 8 taps) and K2 (s = 2, 4 taps): the reference words the
    windows cover (their union), the positions and the output; the
    separable filter's multiply-adds a subblock."""
    taps = NTAPS_LUMA if s == 4 else NTAPS_CHROMA
    n = s + taps - 1
    return (covered_words + 2 * nsy * nsx + nsy * nsx * s * s,
            nsy * nsx * (n * s * taps + s * s * taps))


def mc_least_s(ref, positions, margin: int, s: int) -> float:
    """K1/K2 on one launch's tensors: the union of the windows is
    counted on the tensors' device, as the plain versions place them."""
    import torch
    nsy, nsx, _ = positions.shape
    taps = NTAPS_LUMA if s == 4 else NTAPS_CHROMA
    n = s + taps - 1
    shift = 4 if s == 4 else 5           # luma 1/16 pel, chroma 1/32 pel
    pos = positions.reshape(-1, 2)
    xi = torch.clamp((pos[:, 0] >> shift) + margin - (taps // 2 - 1), 0,
                     ref.shape[1] - n)
    yi = torch.clamp((pos[:, 1] >> shift) + margin - (taps // 2 - 1), 0,
                     ref.shape[0] - n)
    covered = torch.zeros(ref.shape, dtype=torch.bool, device=ref.device)
    cols = xi[:, None] + torch.arange(n, device=ref.device)
    for dy in range(n):
        covered[(yi + dy)[:, None], cols] = True
    words, macs = mc_words_macs(int(covered.sum()), nsy, nsx, s)
    return least_s(words, 2 * macs)


def search_words_macs(name: str, ref_words: int, pos_shape: tuple,
                      orig_words: int, s: int | None) -> tuple[int, int]:
    """K3-K6: the padded reference, the positions, the original band or
    plane and the output; multiply-adds a (candidate, block) 11*s*8 +
    4*s*8 (K3, K4), a subblock 480 (K5) or 72 (K6)."""
    k, ny, nx, _ = pos_shape
    words = ref_words + k * ny * nx * 2 + orig_words
    if name == "sad_luma_positions":
        return words + k * ny * nx, 480 * k * ny * nx
    if name == "sad_bilinear_positions":
        return words + k * ny * nx, 72 * k * ny * nx
    out = k * ny * nx if name == "sad_block_positions" else k * ny * 4 * nx * s
    return words + out, k * ny * nx * (11 * s * 8 + 4 * s * 8)


def search_least_s(name: str, ref_words: int, pos_shape: tuple,
                   orig_words: int, s: int | None) -> float:
    words, macs = search_words_macs(name, ref_words, pos_shape, orig_words,
                                    s)
    return least_s(words, 2 * macs)


def dq_least_s(name: str, b: int, n: int) -> float:
    """D1 (`quantize_dep`): the blocks in, the levels out and the coding
    order, against 66 float32 operations a coefficient; D2
    (`dequantize_dep`): the same words against 12 integer operations a
    coefficient.  D1's rate table is left out of its words (its length
    follows the data): the least time is low by those few words."""
    words = 2 * b * n + n
    if name == "quantize_dep":
        return least_s(words, 66 * b * n, F32_OPS_PER_S)
    return least_s(words, 12 * b * n)


def libm_least_s(name: str, n: int) -> float:
    """L1's elementwise entry `name` over n elements: its inputs and
    output once over the memory rate, against its float64 operations over
    the float64 rate."""
    words = (2 if name == "atan2f" else 1) * n + n
    return max(4 * words / HBM_BYTES_PER_S,
               LIBM_F64_OPS[name] * n / F64_OPS_PER_S)


def sphere_work(name: str, codes: list[int], form: str | None,
                per_slot: list[int], blocks: int, indexed: bool
                ) -> tuple[int, int, int]:
    """L1's sphere kernel: (bytes, float32 operations, float64
    operations) of a launch that computes per_slot[i] positions (or block
    centres) of the model coded codes[i] over `blocks` (field, block)
    pairs: each block's MV (and model index), each position's grid
    constant (MPA's perspective cache 9 bytes, ROT's folded point 12 in
    the merged form), the rsqrt table where a fused form reads it, and 8
    bytes of output a position.  MPA is codes 1-3, ROT 6; CLASSIC and the
    models left to the chain (negative codes) count no operations."""
    n_bytes = blocks * (8 + (4 if indexed else 0)) + 8 * sum(per_slot)
    f32 = f64 = 0
    for code, n in zip(codes, per_slot):
        fam = "mpa" if code in (1, 2, 3) else "rot" if code == 6 else None
        if fam is None:
            continue
        own, atan2s, tans, sincos = SPHERE_OPS[(name, fam)][form]
        f64 += n * (sincos * LIBM_F64_OPS["sinf"]
                    + tans * LIBM_F64_OPS["tanf"])
        f32 += n * (own + atan2s * ATAN2F_F32 + tans * TANF_F32)
        if name == "sphere_positions":
            n_bytes += n * (9 if fam == "mpa" else
                            12 if form == "merged" else 0)
    if form is not None:
        n_bytes += RSQRT_TABLE_BYTES
    return n_bytes, f32, f64


def sphere_least_s(name: str, codes: list[int], form: str | None,
                   model_idx, k: int, nby: int, nbx: int, block_size: int,
                   row_step: int = 1, col_step: int = 1) -> float:
    """One launch of the sphere kernel from its arguments: model_idx
    (K, nby, nbx) slots or None (slot 0 throughout); positions keep every
    row_step-th subblock row and col_step-th column of blocks of
    block_size // 4 subblocks a side, centres one a block."""
    import torch
    if model_idx is None:
        slots = torch.zeros((k, nby, nbx), dtype=torch.int64)
    else:
        slots = model_idx.to(torch.int64)
    if name == "sphere_positions":
        rep = block_size // 4
        slots = slots.repeat_interleave(rep, 1).repeat_interleave(rep, 2)[
            :, ::row_step, ::col_step]
    per_slot = torch.bincount(slots.reshape(-1),
                              minlength=len(codes)).tolist()
    n_bytes, f32, f64 = sphere_work(name, codes, form, per_slot,
                                    k * nby * nbx, model_idx is not None)
    return max(n_bytes / HBM_BYTES_PER_S, f32 / F32_OPS_PER_S,
               f64 / F64_OPS_PER_S)
