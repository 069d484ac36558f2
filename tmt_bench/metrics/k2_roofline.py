"""K2 ``cascade_sp_chunk``'s share of its roofline: the least time its bytes
take at the card's HBM bandwidth over its profiled device time, in %.

Bytes of one launch on B boards of R x C cells: each input byte read once
(colour and kind int32[B, R, C], sub-keys int64[B, 2], trips, elim and
frozen int32[B]) and each output byte written once (colour and kind
int32[B, R, C], trips, elim, new, act, frozen and reasons int32[B], active
bool[B]).  B is each launch's own: the ``boards`` of the program's
``cascade_sp_chunk`` spans, one a wrapper call, summed over the episode, so
no launch is matched to its kernel.  Its integer work is far below the
card's rate, so bytes bound it."""

from tmt_bench.peaks import peak
from tmt_bench.spans import named

KERNEL = "cascade_sp_kernel"  # K2's device name


def k2_bytes(B: int, R: int, C: int) -> int:
    return B * (4 * R * C * 2 + 8 * 2 + 4 * 3 + 4 * R * C * 2 + 4 * 6 + 1)


def read(run):
    prof = run["profile"]
    bw = peak(run["device_kind"], "hbm_bytes_per_s")
    if not prof or bw is None:
        return None
    k2 = [e - s for n, s, e in prof["ops"] if KERNEL in n]
    spans = named(run, "cascade_sp_chunk")
    if not k2 or spans is None:
        return None
    cfg = run["config"]
    R, C = cfg["num_rows"], cfg["num_cols"]
    bound_s = sum(k2_bytes(s.attrs["boards"], R, C) for s in spans) / bw
    return 100.0 * bound_s / (sum(k2) / 1e6)
