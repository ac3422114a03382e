"""jnp GF arithmetic primitives for the device compute path.

GF(2)/GF(256) matrix products over byte payloads run as bit-plane integer
matmuls (see gf256/bitplane.py for the math); sparse XOR combinations run as
gather + XOR-reduce.  gf2_matmul takes the fused GPU kernel
(ops/pallas_kernels.py) where pallas_kernels.kernel_applies says so, and the
plain XLA formulation (gf2_matmul_xla, also the reference the kernel is tested
against) everywhere else.  GF(256) products are plain XLA.  All functions are
shape-polymorphic jnp code, jit-compiled per shape by the callers.
"""

import jax
import jax.numpy as jnp
import numpy as np

from nanorq_tpu.ops import pallas_kernels


def unpack_planes(X: jnp.ndarray) -> jnp.ndarray:
    """[n, t] uint8 -> [n, 8, t] int8 bit planes (plane b = bit b)."""
    shifts = jnp.arange(8, dtype=jnp.uint8)[None, :, None]
    return ((X[:, None, :] >> shifts) & 1).astype(jnp.int8)


def pack_planes(P8: jnp.ndarray) -> jnp.ndarray:
    """[n, 8, t] 0/1 -> [n, t] uint8."""
    w = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))[None, :, None]
    return jnp.sum(P8.astype(jnp.uint8) * w, axis=1, dtype=jnp.uint8)


def gf2_matmul_xla(bits: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """out[r] = XOR_{c: bits[r,c]=1} X[c];  bits [m,n] 0/1, X [n,t] uint8.

    One int8 matmul over the 8 stacked bit planes, reduced mod 2.
    """
    n, t = X.shape
    planes = unpack_planes(X).reshape(n, 8 * t)  # [n, 8t]
    acc = jax.lax.dot_general(
        bits.astype(jnp.int8), planes,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    out = (acc & 1).astype(jnp.uint8).reshape(bits.shape[0], 8, t)
    return pack_planes(out)


def gf256_matmul_bits(Mbits: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """GF(256) matmul via companion bits: Mbits [8m, 8n], X [n, t] uint8."""
    n, t = X.shape
    xb = unpack_planes(X).reshape(8 * n, t).astype(jnp.int8)  # row 8k+b = bit b
    acc = jax.lax.dot_general(
        Mbits.astype(jnp.int8), xb,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    ob = (acc & 1).astype(jnp.uint8)  # [8m, t]
    m8 = Mbits.shape[0]
    return pack_planes(ob.reshape(m8 // 8, 8, t))


def gf2_matmul(bits: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """GF(2) product (gf2_matmul_xla semantics) on the best path for the shape."""
    if pallas_kernels.kernel_applies(bits.shape[0], *X.shape):
        return pallas_kernels.gf2_matmul_triton(bits, X)
    return gf2_matmul_xla(bits, X)


def xor_reduce_gather(src: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """XOR-reduce src[idx] over the width axis: src [n, t], idx [r, w] -> [r, t]."""
    g = jnp.take(src, idx, axis=0)  # [r, w, t]
    return jax.lax.reduce(g, np.uint8(0), jax.lax.bitwise_xor, (1,))
