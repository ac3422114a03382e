"""Device executor for the structured precode replay program.

Runs the 6-stage program from precode.device_schedule on a payload matrix
D [M_pad, t] (uint8, rows beyond the logical system zeroed), producing the
intermediate symbols C [L, t].  The payload axis t is the batching axis: the
codec lays out B independent blocks side by side (t = B*T), so every stage
is a wide op and the ~2*Lpad/CB-step sequential chain amortizes across the
whole batch.

The program is deliberately scatter-free: all sparse structure is expressed
as row-aligned gather-XOR passes, one-hot GF(2) matmuls, and static slice
updates.  The GF matmuls go through ops/gfmat.py, which picks the fused GPU
kernel or the plain XLA formulation per shape; gathers are plain XLA.

jit-compiled per DeviceSchedule *shape* signature: canonical padding in the
compiler makes decode schedules for one K' share a compiled program.
"""

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_static
@dataclass(frozen=True)
class _Static:
    """Static pytree node: carries Python structure (e.g. range bounds)
    through a jitted pytree argument as part of the compile key, not data."""

    value: tuple

from nanorq_tpu.gf256.bitplane import companion_bits
from nanorq_tpu.ops import gfmat
from nanorq_tpu.precode.device_schedule import DeviceSchedule, GatherPlan


def _j_idx(x) -> jnp.ndarray:
    """Upload an index array; uint16 arrays (half the upload bytes) are cast
    to int32 on device — the gather kernels index with int32."""
    a = jnp.asarray(x)
    return a.astype(jnp.int32) if a.dtype == jnp.uint16 else a


def _plan_arrays(plan: GatherPlan) -> tuple:
    return (
        tuple(_j_idx(p) for p in plan.passes),
        tuple((_j_idx(ix), _j_idx(oh)) for ix, oh in plan.overflow),
    )


def _put_bits(x: np.ndarray) -> jnp.ndarray:
    """Upload a 0/1 uint8 matrix bit-packed (8x less host->device traffic).
    Unpacked lazily *inside* the replay program so no extra kernels are
    compiled."""
    assert x.shape[-1] % 8 == 0
    packed = np.packbits(np.ascontiguousarray(x, np.uint8), axis=-1, bitorder="little")
    return jnp.asarray(packed)


def _unpack_bits(p: jnp.ndarray) -> jnp.ndarray:
    bits = (p[..., :, None] >> jnp.arange(8, dtype=jnp.uint8)) & jnp.uint8(1)
    return bits.reshape(*p.shape[:-1], p.shape[-1] * 8)


def device_arrays(ds: DeviceSchedule) -> dict:
    """Convert a DeviceSchedule into the jnp pytree the executor consumes.

    Cached on the schedule object: repeat codec calls must not re-upload
    (the index/bit tensors reach ~30 MB packed at K'=56403).
    """
    cached = getattr(ds, "_dev_arrays", None)
    if cached is not None:
        return cached
    j = _j_idx
    arr = {
        "piv_rows": j(ds.piv_rows),
        "tri": tuple(
            {
                "tinv": jnp.asarray(seg.tinv),  # pre-packed bits
                "bounds": _Static(tuple((a, b) for a, b, _ in seg.ranges)),
                "ridx": tuple(j(ix) for _, _, ix in seg.ranges),
            }
            for seg in ds.tri  # segment q0 is implied by cumulative lengths
        ),
        "sel_rows": j(ds.sel_rows),
        "bsel": _plan_arrays(ds.bsel),
        "hd_sel": None if ds.mhd is None else j(ds.hd_sel),
        "mhd_bits": None if ds.mhd is None else _put_bits(companion_bits(ds.mhd)),
        "vinv_bits": _put_bits(companion_bits(ds.vinv)),
        "wut_bits": jnp.asarray(ds.wut),  # pre-packed [Lpad, u_pad/8]
        "out_sel": j(ds.out_sel),
    }
    ds._dev_arrays = arr
    _count_signature(arr)
    return arr


def _select_rows(red: jnp.ndarray, sel: jnp.ndarray) -> jnp.ndarray:
    """red_ext[sel] with sentinel -> zero row (width-1 gather placement)."""
    red_ext = jnp.concatenate([red, jnp.zeros((1, red.shape[1]), jnp.uint8)], axis=0)
    return jnp.take(red_ext, sel, axis=0)


def _apply_plan(src_ext: jnp.ndarray, plan, base: jnp.ndarray) -> jnp.ndarray:
    """base ^= XOR-gathers of src_ext per GatherPlan (row-aligned, no scatters)."""
    passes, overflow = plan
    out = base
    for p in passes:
        out = out ^ gfmat.xor_reduce_gather(src_ext, p)
    for idx, sel in overflow:
        out = out ^ _select_rows(gfmat.xor_reduce_gather(src_ext, idx), sel)
    return out


_SCAN_THRESHOLD = 12  # unroll short segments; scan longer ones


def _trisolve(arr: dict, y: jnp.ndarray) -> jnp.ndarray:
    """y [Lpad, t] -> z [Lpad+1, t] = T^-1 y (last row zero sentinel).

    Triangle chunks run segment by segment; each segment's chunk loop is a
    lax.scan over uniform per-chunk arrays (compile time O(#segments)).
    """
    Lpad = arr["piv_rows"].shape[0]
    t = y.shape[1]
    z = jnp.zeros((Lpad + 1, t), jnp.uint8)

    q0 = 0
    for seg in arr["tri"]:
        tinv = _unpack_bits(seg["tinv"])
        nq, CB, _ = tinv.shape
        bounds = seg["bounds"].value  # static prefix ranges (chunk rows degree-sorted)

        def chunk_step(z, yq, tinv_q, ridx_q, q, bounds=bounds):
            acc = yq
            for (a, b), ix in zip(bounds, ridx_q):
                acc = acc.at[a:b].set(acc[a:b] ^ gfmat.xor_reduce_gather(z, ix))
            zq = gfmat.gf2_matmul(tinv_q, acc)
            return jax.lax.dynamic_update_slice_in_dim(z, zq, q * CB, 0)

        if nq <= _SCAN_THRESHOLD:
            for qi in range(nq):
                q = q0 + qi
                ridx_q = tuple(ix[qi] for ix in seg["ridx"])
                z = chunk_step(z, y[q * CB : (q + 1) * CB], tinv[qi], ridx_q, q)
        else:

            def body(z, xs, q0=q0, CB=CB):
                qi, tinv_q, ridx_q = xs
                q = q0 + qi
                yq = jax.lax.dynamic_slice_in_dim(y, q * CB, CB, 0)
                return chunk_step(z, yq, tinv_q, ridx_q, q), None

            qs = jnp.arange(nq)
            z, _ = jax.lax.scan(body, z, (qs, tinv, seg["ridx"]))
        q0 += nq
    return z


_seen_signatures: set = set()


def _count_signature(arr: dict) -> None:
    """Track distinct compile signatures (shape grid + static bounds): decode
    schedules of one K' should hit an already-compiled program almost always
    (ADVICE r2 #5) — the bench reports replay_compile_new vs replay_compile_hit.
    Called once per schedule from device_arrays (the payload width t is not
    part of the signature there; within one codec run t is constant), keeping
    the per-dispatch path free of tuple-building overhead."""
    from nanorq_tpu.utils import stats

    sig = (
        arr["piv_rows"].shape[0],
        tuple((s["tinv"].shape, s["bounds"].value, tuple(ix.shape for ix in s["ridx"])) for s in arr["tri"]),
        tuple(p.shape for p in arr["bsel"][0]),
        # overflow (ix, sel) shapes are data-dependent in warm-up plans and
        # are jit pytree leaves — omitting them over-reported program reuse
        tuple((ix.shape, sel.shape) for ix, sel in arr["bsel"][1]),
        arr["wut_bits"].shape,
        None if arr["mhd_bits"] is None else arr["mhd_bits"].shape,
        arr["vinv_bits"].shape,
        arr["out_sel"].shape,
    )
    if sig in _seen_signatures:
        stats.count("replay_compile_hit")
    else:
        _seen_signatures.add(sig)
        stats.count("replay_compile_new")


def replay_device(arr: dict, D: jnp.ndarray) -> jnp.ndarray:
    """Structured replay: D [M_pad, t] -> C [L, t]."""
    return _replay_jit(arr, D)


@jax.jit
def _replay_jit(arr: dict, D: jnp.ndarray) -> jnp.ndarray:
    Lpad = arr["piv_rows"].shape[0]

    y = jnp.take(D, arr["piv_rows"], axis=0)  # [Lpad, t]
    z = _trisolve(arr, y)  # stage 1: t1 = T^-1 y

    # stage 2: zsel = y_sel ^ B_sel t1  (+ HDPC dense part)
    zsel = _apply_plan(z, arr["bsel"], jnp.take(D, arr["sel_rows"], axis=0))
    if arr["mhd_bits"] is not None:
        hvals = gfmat.gf256_matmul_bits(_unpack_bits(arr["mhd_bits"]), z[:Lpad])  # [H_pad, t]
        zsel = zsel ^ _select_rows(hvals, arr["hd_sel"])

    # stage 3: x_u = Vinv zsel
    xu = gfmat.gf256_matmul_bits(_unpack_bits(arr["vinv_bits"]), zsel)  # [u_pad, t]

    # stage 4: x_a = t1 ^ Wut x_u — the host-precomputed Wut = T^-1 U_t
    # replaces the former U_t gather + second trisolve with one GF(2) matmul
    xa = z[:Lpad] ^ gfmat.gf2_matmul(_unpack_bits(arr["wut_bits"]), xu)

    # stage 5: output gather
    allrows = jnp.concatenate([xa, xu], axis=0)
    return jnp.take(allrows, arr["out_sel"], axis=0)
