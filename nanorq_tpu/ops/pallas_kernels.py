"""Fused GF(2) bit-plane matmul for NVIDIA GPUs (Pallas, Triton route).

The plain XLA formulation (ops/gfmat.py) writes three intermediates to device
memory: 8 int8 bit planes per input byte, an int32 accumulator 8x as wide as
the payload, and a masked copy before repacking.  This kernel keeps
unpack -> int8 tensor-core dot -> mod 2 -> repack in registers: it reads the
coefficient bits and the payload bytes once and writes the result bytes.

Each program owns an (MB x TW) tile of output bytes and loops over the
contraction axis in KB-row steps.  Per step the uint8 payload tile is split
into 0/1 int8 planes in registers and one [MB, KB] x [KB, 8TW] int8 dot
accumulates into int32 (plane-major columns: acc_b += A . plane_b).

All arithmetic is on 0/1 values with integer accumulation, so the result is
exact whatever the tile order.  `kernel_applies` is the one place that decides
whether a product takes this kernel or the plain path.  GF(256) products
always take the plain path: a GF(256) mode of this kernel lost to XLA's
int8 GEMM at the Vinv and HDPC shapes and won at no shape the codec sends.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Block sizes (MB output rows, TW byte columns = 8*TW plane columns, KB
# contraction rows, num_warps, num_stages), swept on an H100 with
# tools/gf_matmul_ab.py --sweep.
GF2_CFG = (128, 32, 64, 8, 3)


def _shrink(blk: int, n: int) -> int | None:
    """Largest power of two <= blk dividing n, at least 16 (dot operand floor)."""
    while blk >= 16 and n % blk:
        blk //= 2
    return blk if blk >= 16 else None


def kernel_applies(m: int, k: int, t: int, platform: str | None = None) -> bool:
    """True iff the GF(2) [m, k] x [k, t] product runs the Triton kernel: the
    platform is a GPU and k and t tile exactly (the output-row axis is padded
    by the wrapper)."""
    platform = platform or jax.default_backend()
    return platform == "gpu" and not k % 32 and not t % 16


def _kernel(a_ref, x_ref, o_ref, *, k: int, MB: int, KB: int, TW: int):
    r0 = pl.program_id(0) * MB
    j0 = pl.program_id(1) * TW
    sh8 = jax.lax.broadcasted_iota(jnp.int32, (8,), 0).astype(jnp.uint8)

    def step(kk, acc):
        c0 = pl.multiple_of(kk * KB, KB)
        x = x_ref[pl.ds(c0, KB), pl.ds(j0, TW)]
        planes = ((x[:, None, :] >> sh8[None, :, None]) & 1).astype(jnp.int8).reshape(KB, 8 * TW)
        a = a_ref[pl.ds(r0, MB), pl.ds(c0, KB)].astype(jnp.int8)
        return acc + pl.dot(a, planes)

    acc = jax.lax.fori_loop(0, k // KB, step, jnp.zeros((MB, 8 * TW), jnp.int32))
    bits = (acc.reshape(MB, 8, TW) & 1) << sh8.astype(jnp.int32)[None, :, None]
    o_ref[...] = jnp.sum(bits, axis=1).astype(jnp.uint8)


def _gf2_matmul(A: jnp.ndarray, X: jnp.ndarray, cfg: tuple, interpret: bool) -> jnp.ndarray:
    MB, TW, KB, warps, stages = cfg
    (m, _), (k, t) = A.shape, X.shape
    KB, TW = _shrink(KB, k), _shrink(TW, t)
    assert KB is not None and TW is not None, f"untileable GF matmul k={k} t={t}"
    MB = min(MB, max(16, 1 << (m - 1).bit_length()))
    mp = -(-m // MB) * MB
    if mp != m:  # pad the (small) coefficient operand, never the payload
        A = jnp.pad(A, ((0, mp - m), (0, 0)))
    out = pl.pallas_call(
        partial(_kernel, k=k, MB=MB, KB=KB, TW=TW),
        grid=(mp // MB, t // TW),
        out_specs=pl.BlockSpec((MB, TW), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((mp, t), jnp.uint8),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps, num_stages=stages),
        interpret=interpret,
        name="gf2_matmul",
    )(A, X)
    return out if mp == m else out[:m]


@partial(jax.jit, static_argnames=("interpret",))
def gf2_matmul_triton(A: jnp.ndarray, X: jnp.ndarray, interpret: bool = False) -> jnp.ndarray:
    """GF(2) product of A [m, k] (0/1) with byte rows X [k, t] -> [m, t]
    uint8.  k and t must tile (kernel_applies); m is padded to the row block
    here."""
    return _gf2_matmul(A, X, GF2_CFG, interpret)
