"""Dense combination-matrix (W) fast path.

Every output symbol of the codec is a LINEAR COMBINATION of the payload
rows: the intermediates are C = A^-1 D, and an output set G (LT rows of the
requested ISIs) gives symbols S = G C = (G A^-1) D = W D.  The reference
necessarily replays its recorded row-op schedule against D per block
(lib/precode.c:23-32, 379-389: apply_sched + decode_row); on a wide device
the far better mapping for small/mid K' is to fold the entire solve into W on
the host ONCE and make the device work a single GF(2)/GF(256) matmul — no
sequential trisolve chain, no gather stages, and a per-loss-pattern
upload of packed W bits (tens of KB) instead of schedule index tensors.

W is built from the existing factorization artifacts (precode.solver
SolveState + native/solver.cc nrq_wsolve) by transposed substitution:

    W A = G,  A = [[T, U], [B, V]] (pivot basis)  =>
    a  = g1 T^-1;  t2 = g2 ^ a U;  w2 = t2 S^-1;  w1 = (g1 ^ w2 B) T^-1

with S = V ^ B T^-1 U the Schur pivot block whose inverse the solver
already produced.  Host cost is O((nnz + u^2) * nrhs) byte-SIMD work —
per decode pattern that is milliseconds up to K' ~ 10k.

The structured replay (ops/replay.py) remains the scalable path for large
K', where W @ D's O(K'^2 t) FLOPs lose to the O(nnz t) replay.
"""

from functools import partial

import jax
import numpy as np

from nanorq_tpu.precode.device_schedule import _pad_rows
from nanorq_tpu.precode.matrix import CSRRows, hdpc_full_rows
from nanorq_tpu.precode.solver import SolveState


def _pattern_edges(st: SolveState, out_rows: CSRRows):
    """Shared rhs/edge extraction for both W builders: output-row entries in
    the pivot basis plus the binary sel-row dep edges."""
    nrhs = len(out_rows)
    kk, cols = out_rows.select_flat(np.arange(nrhs))
    pos = st.pivpos_of_col[cols]
    uc = st.ucol_of[cols]

    order_sel = st.order[st.i : st.i + st.u]
    bin_slots = np.nonzero(order_sel < st.NB)[0]
    rc = st.rows_cols if isinstance(st.rows_cols, CSRRows) else CSRRows.from_list(st.rows_cols)
    skk, scols = rc.select_flat(order_sel[bin_slots])
    spos = st.pivpos_of_col[scols]
    sm = spos >= 0
    bs_sel = np.ascontiguousarray(bin_slots[skk[sm]], np.int32)
    bs_pos = np.ascontiguousarray(spos[sm], np.int32)
    return nrhs, kk, pos, uc, order_sel, bin_slots, bs_sel, bs_pos


def w_rows(st: SolveState, out_rows: CSRRows, n_cols: int | None = None) -> tuple[np.ndarray, bool]:
    """Combination rows W [nout, n_cols] with (W A)[r] = out row r.

    out_rows: binary column sets (over A's L columns) of the requested
    outputs — LT rows of the output ISIs.  Columns of W index the solver's
    system rows == the payload matrix D's rows (constraint rows get the
    zero coefficients their zero payloads imply).  Returns (W, binary):
    binary is True iff every coefficient is 0/1 (no HDPC pivots were used),
    enabling the 8x cheaper GF(2) device matmul.

    Requires the native solver's factorization artifacts (st.vinv,
    st.tri_edges, st.ut_edges); raises RuntimeError otherwise.
    """
    from nanorq_tpu.native import get_lib

    lib = get_lib()
    if lib is None or getattr(st, "vinv", None) is None or getattr(st, "tri_edges", None) is None:
        raise RuntimeError("w_rows requires the native solver factorization")
    import ctypes

    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if not hasattr(lib, "_wsolve_bound"):
        lib.nrq_wsolve.restype = None
        lib.nrq_wsolve.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, i32p, i32p, ctypes.c_int64, i32p, i32p,
            ctypes.c_int64, i32p, i32p, u8p, i32p, u8p, u8p, u8p, u8p, u8p,
        ]
        lib.nrq_wscatter.restype = None
        lib.nrq_wscatter.argtypes = [ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int32, u8p, u8p]
        lib._wsolve_bound = True

    P = st.P
    i, u = st.i, st.u
    NB = st.NB
    nrhs, kk, pos, uc, order_sel, bin_slots, bs_sel, bs_pos = _pattern_edges(st, out_rows)

    # rhs in the pivot basis: g1 [i, nrhs] (pivot positions), g2 [u, nrhs]
    g1 = np.zeros((max(i, 1), nrhs), np.uint8)
    g2 = np.zeros((max(u, 1), nrhs), np.uint8)
    m = pos >= 0
    g1[pos[m], kk[m]] = 1
    m = uc >= 0
    g2[uc[m], kk[m]] = 1

    hd_cols = np.zeros(0, np.uint8)
    hd_sel = np.full(max(u, 1), -1, np.int32)
    if st.hdpc_used:
        hd_full = hdpc_full_rows(P)
        hd_cols = np.ascontiguousarray(hd_full[:, st.piv_cols]) if i else np.zeros((P.H, 0), np.uint8)
        hs = np.nonzero(order_sel >= NB)[0]
        hd_sel[hs] = (order_sel[hs] - NB).astype(np.int32)

    tri_ek, tri_ep = st.tri_edges
    ut_ek, ut_uc = st.ut_edges
    w1 = np.empty((max(i, 1), nrhs), np.uint8)
    w2 = np.empty((max(u, 1), nrhs), np.uint8)
    vinv = np.ascontiguousarray(st.vinv if u else np.zeros((0, 0), np.uint8))

    def p32(a):
        return np.ascontiguousarray(a, np.int32).ctypes.data_as(i32p)

    def p8(a):
        return a.ctypes.data_as(u8p)

    lib.nrq_wsolve(
        nrhs, i, u, P.H, int(st.hdpc_used),
        tri_ek.size, p32(tri_ek), p32(tri_ep),
        ut_ek.size, p32(ut_ek), p32(ut_uc),
        bs_sel.size, p32(bs_sel), p32(bs_pos),
        p8(hd_cols) if hd_cols.size else None, p32(hd_sel), p8(vinv) if u else None,
        p8(g1), p8(g2), p8(w1), p8(w2),
    )

    n_cols = n_cols or _pad_rows(st.M + 1)
    W = np.zeros((nrhs, n_cols), np.uint8)
    if i:
        lib.nrq_wscatter(nrhs, i, p32(st.piv_rows), n_cols, p8(np.ascontiguousarray(w1[:i])), p8(W))
    if bin_slots.size:
        w2b = np.ascontiguousarray(w2[bin_slots])
        lib.nrq_wscatter(nrhs, bin_slots.size, p32(order_sel[bin_slots]), n_cols, p8(w2b), p8(W))
    binary = not st.hdpc_used
    return W, binary


def _pack_rhs(idx_r, idx_c, n, RW8):
    """[n, RW8] uint8 little-bit-packed rhs from scatter indices (entries are
    unique per row, so or-accumulation is exact; packing directly avoids
    materializing the [n, 8*RW8] unpacked array — 157 MB at K'=50511)."""
    u = np.zeros((n, RW8), np.uint8)
    np.bitwise_or.at(u, (idx_r, idx_c >> 3), (np.uint8(1) << (idx_c & 7).astype(np.uint8)))
    return u


def w_rows_gf2(st: SolveState, out_rows: CSRRows, zero_row: int):
    """Binary-system W in gathered form: (Wbits, rows).

    Wbits: uint8 [nrhs, kq/8], little-endian packed coefficients over the
    GATHERED payload rows D[rows] (rows int32 [kq], padded with `zero_row`)
    — the device applies  out = unpack(Wbits) (x)GF(2) D[rows].  Keeping the
    rhs bit-packed end to end (packed transposed solve + 64x64 bit
    transpose) makes host W prep ~10x cheaper than the byte-scatter
    formulation (nrq_wsolve / nrq_wscatter) that the GF(256) branch uses.

    Only valid when st.hdpc_used is False (all coefficients 0/1).
    """
    from nanorq_tpu.native import get_lib

    lib = get_lib()
    if lib is None or st.hdpc_used or getattr(st, "vinv", None) is None or getattr(st, "tri_edges", None) is None:
        raise RuntimeError("w_rows_gf2 requires a native binary factorization")
    import ctypes

    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    if not hasattr(lib, "_wgf2_bound"):
        lib.nrq_wsolve_gf2.restype = None
        lib.nrq_wsolve_gf2.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, i32p, i32p, ctypes.c_int64, i32p, i32p,
            ctypes.c_int64, i32p, i32p, u8p, u64p, u64p, u64p, u64p,
        ]
        lib.nrq_bit_transpose.restype = None
        lib.nrq_bit_transpose.argtypes = [ctypes.c_int32, ctypes.c_int32, u64p, u64p]
        lib._wgf2_bound = True

    i, u = st.i, st.u
    nrhs, kk, pos, uc, order_sel, bin_slots, bs_sel, bs_pos = _pattern_edges(st, out_rows)
    RW = -(-nrhs // 64)
    RW8 = RW * 8

    m = pos >= 0
    g1 = _pack_rhs(pos[m], kk[m], max(i, 1), RW8)
    m = uc >= 0
    g2 = _pack_rhs(uc[m], kk[m], max(u, 1), RW8)

    tri_ek, tri_ep = st.tri_edges
    ut_ek, ut_uc = st.ut_edges
    w1 = np.empty((max(i, 1), RW8), np.uint8)
    w2 = np.empty((max(u, 1), RW8), np.uint8)
    vinv = np.ascontiguousarray(st.vinv if u else np.zeros((0, 0), np.uint8))

    def p(a, tp):
        return a.ctypes.data_as(tp)

    def pc32(a):
        return np.ascontiguousarray(a, np.int32).ctypes.data_as(i32p)

    lib.nrq_wsolve_gf2(
        RW, i, u,
        tri_ek.size, pc32(tri_ek), pc32(tri_ep),
        ut_ek.size, pc32(ut_ek), pc32(ut_uc),
        bs_sel.size, p(bs_sel, i32p), p(bs_pos, i32p),
        p(vinv, u8p) if u else None,
        p(g1, u64p), p(g2, u64p), p(w1, u64p), p(w2, u64p),
    )

    # gathered layout: positions then binary sel rows, zero-row padded
    n = i + bin_slots.size
    kq = max(64, _quant_k(n))
    src = np.empty((n, RW8), np.uint8)
    src[:i] = w1[:i]
    src[i:] = w2[bin_slots]
    NW = -(-n // 64)
    Wt = np.zeros((nrhs, NW * 8), np.uint8)
    lib.nrq_bit_transpose(n, nrhs, p(src, u64p), p(Wt, u64p))
    Wbits = np.zeros((nrhs, kq // 8), np.uint8)
    Wbits[:, : min(NW * 8, kq // 8)] = Wt[:, : kq // 8]
    rows = np.full(kq, zero_row, np.int32)
    rows[:i] = st.piv_rows
    rows[i:n] = order_sel[bin_slots].astype(np.int32)
    return Wbits, rows


def _quant_k(n: int) -> int:
    """Gathered-row-count grid: multiples of 512 (shape reuse across the
    slightly varying i + nbin of one K's loss patterns)."""
    return -(-n // 512) * 512


def stage_w_gf2(Wbits: np.ndarray, rows: np.ndarray):
    """Upload a gathered-form binary W: packed bits + the D-row gather."""
    import jax.numpy as jnp

    return {"bits": jnp.asarray(Wbits), "rows": jnp.asarray(rows)}


def w_matmul_gf2(staged: dict, D):
    """out [m, t] = unpack(Wbits) (x)GF(2) D[rows]  (async dispatch)."""
    return _w_gf2_jit(staged["bits"], staged["rows"], D)


@jax.jit
def _w_gf2_jit(bits, rows, D):
    import jax.numpy as jnp

    from nanorq_tpu.ops import gfmat
    from nanorq_tpu.ops.replay import _unpack_bits

    return gfmat.gf2_matmul(_unpack_bits(bits), jnp.take(D, rows, axis=0))


# ---------------------------------------------------------------------------
# Batched multi-block execution: nb same-K' patterns in ONE dispatch.
#
# A fresh-pattern decode at small K' is dominated by per-block host/launch
# overhead (~2 ms/dispatch through the runtime), not device math — the
# reference's per-block repair at K=100 is ~0.2 ms of C.  Stacking the
# per-pattern W matrices (padded to the batch max; zero pads are exact
# no-ops over GF arithmetic) turns nb uploads + nb dispatches + nb syncs
# into one of each.  The batch dimension is also the mesh-sharding axis:
# callers pass sharded stacked inputs and the same jit runs SPMD over
# blocks (SURVEY.md §2 parallelism checklist, per-SBN independence of
# reference lib/nanorq.c:57).
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=())
def _w_gf2_batch_jit(bits, rows, D):
    """bits [nb, m, kq/8], rows [nb, kq] int32, D [nb, M_pad, t] ->
    [nb, m, t] (per-block m/kq are batch-max padded by the caller)."""
    import jax.numpy as jnp

    from nanorq_tpu.ops import gfmat
    from nanorq_tpu.ops.replay import _unpack_bits

    def one(b, r, d):
        y = jnp.take(d, r, axis=0)  # [kq, t]
        return gfmat.gf2_matmul(_unpack_bits(b), y)

    return jax.vmap(one)(bits, rows, D)


@jax.jit
def _w_gf256_batch_jit(W, D):
    """W [nb, m, k] GF(256) coefficients, D [nb, M_pad, t] -> [nb, m, t]
    (k = D-row prefix length).  The companion bit-planes are built on the
    device (_companion_dev): the upload is the raw bytes, 8x less than the
    packed planes, and the host does no per-block expansion."""
    from nanorq_tpu.ops import gfmat

    def one(w, d):
        return gfmat.gf256_matmul_bits(_companion_dev(w), d[: w.shape[1]])

    return jax.vmap(one)(W, D)


def w_stack_gf2(plans: list) -> tuple[np.ndarray, np.ndarray]:
    """Stack gathered-form GF(2) WSchedules: (bits [nb, m, kq/8],
    rows [nb, kq]).  m/kq pad to the batch max (both come from quantized
    grids, so the max is shape-stable across batches of one K')."""
    m = max(p.Wbits.shape[0] for p in plans)
    kq = max(p.rows.size for p in plans)
    nb = len(plans)
    bits = np.zeros((nb, m, kq // 8), np.uint8)
    rows = np.full((nb, kq), plans[0].M_pad - 1, np.int32)
    for j, p in enumerate(plans):
        bits[j, : p.Wbits.shape[0], : p.Wbits.shape[1]] = p.Wbits
        rows[j, : p.rows.size] = p.rows
    return bits, rows


def w_stack_gf256(plans: list) -> np.ndarray:
    """Stack byte-W WSchedules as W [nb, m, k] (k = M_pad; rows pad to the
    batch max with zeros, exact no-ops over GF arithmetic)."""
    m = max(p.W.shape[0] for p in plans)
    k = plans[0].M_pad
    W = np.zeros((len(plans), m, k), np.uint8)
    for j, p in enumerate(plans):
        W[j, : p.W.shape[0]] = p.W[:, :k]
    return W


# ---------------------------------------------------------------------------
# Residual decode arm: X = R (y ^ W D0), one fused batched dispatch.
#
# W [nb, nr, k] holds per-block CANONICAL repair-ISI combination rows
# (cache.res_wrows) over the source-region payload columns, D0 [nb, k, T]
# the received payloads (gap rows zero), y [nb, nr, T] the received repair
# payloads, and R [nb, g, nr] the host-computed tiny left inverses
# (native res_rinv).  Both products are GF(256): the companion bit-planes
# are built ON DEVICE from the raw byte matrices (an 8x upload saving —
# the xtime chain and bit unpack are a few cheap elementwise ops), then run
# as the same bit-plane matmuls the stacked W path uses.  Zero-padded rows/
# blocks are exact no-ops over GF arithmetic.
# ---------------------------------------------------------------------------


def _companion_dev(W):
    """Device companion bits: W [m, k] uint8 -> [8m, 8k] uint8 0/1 with
    comp[8r+o, 8c+b] = bit_o(W[r,c] (x) alpha^b)  (bitplane.companion_bits
    layout, built via the GF(256) xtime chain instead of a table gather)."""
    import jax.numpy as jnp

    prods = [W]
    for _ in range(7):
        a = prods[-1]
        nxt = (a << 1) ^ jnp.where((a & 0x80) != 0, jnp.uint8(0x1D), jnp.uint8(0))
        prods.append(nxt.astype(jnp.uint8))
    prod = jnp.stack(prods, axis=-1)  # [m, k, b]
    bits = (prod[..., None] >> jnp.arange(8, dtype=jnp.uint8)) & jnp.uint8(1)  # [m,k,b,o]
    m, k = W.shape
    return bits.transpose(0, 3, 1, 2).reshape(8 * m, 8 * k)


@jax.jit
def _res_batch_jit(W, D0, R, y):
    """W [nb, nr, k], D0 [nb, k, T], R [nb, g, nr], y [nb, nr, T] ->
    X [nb, g, T]: rows [:g_b] of block b are its recovered gap payloads."""
    from nanorq_tpu.ops import gfmat

    def one(w, d, r, yy):
        yhat = gfmat.gf256_matmul_bits(_companion_dev(w), d)
        return gfmat.gf256_matmul_bits(_companion_dev(r), yhat ^ yy)

    return jax.vmap(one)(W, D0, R, y)


# ---------------------------------------------------------------------------
# Device execution: out = W (x) D, one matmul
# ---------------------------------------------------------------------------


def stage_w(W: np.ndarray, binary: bool):
    """Upload W for repeated application: packed GF(2) bits, or packed
    companion bits for GF(256) coefficients.  Returns the device pytree
    w_matmul consumes."""
    import jax.numpy as jnp

    from nanorq_tpu.gf256.bitplane import companion_bits

    k = W.shape[1]
    packed = np.packbits(W if binary else companion_bits(W), axis=-1, bitorder="little")
    return {"bits": jnp.asarray(packed), "binary": binary, "k": k}


def w_matmul(staged: dict, D):
    """out [m, t] = W (x) D[:k] on device (async dispatch)."""
    return _w_matmul_jit(staged["bits"], D, staged["binary"], staged["k"])


@partial(jax.jit, static_argnames=("binary", "k"))
def _w_matmul_jit(bits, D, binary: bool, k: int):
    from nanorq_tpu.ops import gfmat
    from nanorq_tpu.ops.replay import _unpack_bits

    if binary:
        return gfmat.gf2_matmul(_unpack_bits(bits)[:, :k], D[:k])
    return gfmat.gf256_matmul_bits(_unpack_bits(bits), D[:k])
