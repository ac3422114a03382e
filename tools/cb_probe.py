"""Sweep the trisolve chunk size CB of the encoder replay on the device.

    python tools/cb_probe.py K CB [CB ...]     e.g.  python tools/cb_probe.py 50000 128 256 512

For each CB: compiles the structured replay for K's encoder schedule, times N
chained replays over B blocks side by side (closed by block_until_ready) and
prints the per-replay time and rate, with the compile time.
"""

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from nanorq_tpu.native import solve_native
from nanorq_tpu.ops.replay import _replay_jit, device_arrays
from nanorq_tpu.precode.device_schedule import compile_device
from nanorq_tpu.precode.matrix import binary_rows
from nanorq_tpu.rfc.params import params_init
from nanorq_tpu.utils.jax_cache import enable_compile_cache

enable_compile_cache()
K = int(sys.argv[1])
CBs = [int(x) for x in sys.argv[2:]]
T, B, N = 1280, (32 if K <= 2000 else (16 if K <= 20000 else 4)), 8
P = params_init(K)
st = solve_native(P, binary_rows(P))
rng = np.random.default_rng(0)
print(jax.devices()[0].device_kind)
for CB in CBs:
    ds = compile_device(st, CB=CB)
    arr = device_arrays(ds)
    t = B * T
    Dn = np.zeros((ds.M_pad, t), np.uint8)
    Dn[:K] = rng.integers(0, 256, (K, t), dtype=np.uint8)
    Dj = jnp.asarray(Dn)

    @jax.jit
    def loop(Dx, arr=arr):
        return jax.lax.fori_loop(0, N, lambda i, Dc: Dc.at[: P.L].set(_replay_jit(arr, Dc)), Dx)

    t0 = time.perf_counter()
    jax.block_until_ready(loop(Dj))
    c = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(loop(Dj))
    per = (time.perf_counter() - t0) / N
    print(f"CB={CB}: segs={[[(a, b, ix.shape[2]) for a, b, ix in s.ranges] for s in ds.tri]}")
    print(f"CB={CB}: replay {1e3 * per:.3f} ms -> {8 * K * T * B / per / 1e9:.2f} Gbps (compile {c:.1f} s)")
