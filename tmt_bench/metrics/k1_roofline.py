"""K1 ``fused_cascade``'s share of its roofline: the least time its bytes
take at the card's HBM bandwidth over its profiled device time, in %.

Bytes of one launch over the whole batch of B boards of R x C cells and A
actions: each input byte read once (colour int32[B, R, C], sub-keys
int64[B, 2]) and each output byte written once (colour int32[B, R, C],
eliminations and trips int32[B], truncated bool[B], mask bool[B, A]).  Its
integer work is far below the card's rate, so bytes bound it."""

from tmt_bench.peaks import peak

KERNEL = "cascade_kernel"  # K1's device name; K2's is cascade_sp_kernel


def k1_bytes(B: int, R: int, C: int, A: int) -> int:
    return B * (4 * R * C + 8 * 2 + 4 * R * C + 4 + 4 + 1 + A)


def read(run):
    prof = run["profile"]
    bw = peak(run["device_kind"], "hbm_bytes_per_s")
    if not prof or bw is None:
        return None
    k1 = [e - s for n, s, e in prof["ops"] if KERNEL in n]
    if not k1:
        return None
    cfg = run["config"]
    R, C = cfg["num_rows"], cfg["num_cols"]
    bound_s = len(k1) * k1_bytes(run["traffic"]["batch"], R, C, 2 * R * C - R - C) / bw
    return 100.0 * bound_s / (sum(k1) / 1e6)
