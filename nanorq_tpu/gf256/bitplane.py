"""Bit-plane / companion-matrix helpers for GF arithmetic as integer matmuls.

A GF(2) combination of byte rows (out[r] = XOR of selected rows) cannot be a
plain integer matmul (carries mix bit lanes), but it *is* one per bit plane:
unpack bytes into 8 0/1 planes, integer-matmul, reduce mod 2, repack.  A
GF(256) matrix multiply additionally expands each scalar into its 8x8 GF(2)
companion block (multiplication by a constant is linear over bits):

    M_bits[8r+o, 8k+b] = bit_o( M[r,k] (x) alpha^b )

These NumPy versions are the host/test mirror of the jnp kernels in
nanorq_tpu.ops.gfmat.
"""

import numpy as np

from nanorq_tpu.gf256.tables import GF_MUL, OCT_EXP


def companion_bits(M: np.ndarray) -> np.ndarray:
    """GF(256) matrix [m, n] -> GF(2) companion matrix [8m, 8n] (uint8 0/1)."""
    m, n = M.shape
    prod = GF_MUL[M[:, :, None], OCT_EXP[:8][None, None, :]]  # [m, n, b]
    bits = (prod[:, :, :, None] >> np.arange(8)[None, None, None, :]) & 1  # [m,n,b,o]
    return bits.transpose(0, 3, 1, 2).reshape(8 * m, 8 * n).astype(np.uint8)


def unpack_bits(X: np.ndarray) -> np.ndarray:
    """Byte rows [n, t] -> bit-plane rows [8n, t], row 8k+b = bit b of X[k]."""
    n, t = X.shape
    planes = (X[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1
    return planes.reshape(8 * n, t)


def pack_bits(planes: np.ndarray) -> np.ndarray:
    """Inverse of unpack_bits: [8n, t] 0/1 -> [n, t] uint8."""
    n8, t = planes.shape
    p = planes.reshape(n8 // 8, 8, t).astype(np.uint16)
    return (p << np.arange(8, dtype=np.uint16)[None, :, None]).sum(1).astype(np.uint8)


def _count_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Integer product of 0/1 matrices via float32 BLAS: every count is at
    most the contraction length, exact in float32 below 2^24."""
    assert A.shape[1] < (1 << 24)
    return (A.astype(np.float32) @ B.astype(np.float32)).astype(np.int64)


def gf2_matmul_bytes(bits: np.ndarray, X: np.ndarray) -> np.ndarray:
    """out[r] = XOR_{c: bits[r,c]=1} X[c] for byte rows X (NumPy mirror)."""
    out = np.zeros((bits.shape[0], X.shape[1]), np.uint8)
    for b in range(8):
        ob = _count_matmul(bits, (X >> b) & 1) & 1
        out |= (ob << b).astype(np.uint8)
    return out


def gf256_matmul_bytes(M: np.ndarray, X: np.ndarray) -> np.ndarray:
    """GF(256) matmul M [m,k] (x) X [k,t] via companion bits (NumPy mirror)."""
    Ob = _count_matmul(companion_bits(M), unpack_bits(X)) & 1  # [8m, t]
    return pack_bits(Ob.astype(np.uint8))
