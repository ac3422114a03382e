"""A/B of the fused GF(2) matmul kernel against the plain XLA formulation.

For each shape: checks the kernel bit-exact against gfmat's XLA path (and the
NumPy oracle where it is cheap), then times both on the device.  Then times the
end-to-end device-arm decode (Decoder.repair_all(backend="device")) at 5%
overhead (GF(2) W) and at overhead 1-2 (HDPC pivots: GF(256) W, always plain
XLA), and the batched encode (codec.batch.generate + repair_symbols) at K=1000
with the kernel switched on and off, in the order off, on, on, off, and prints
the products each arm sent to the kernel.  Finally writes the
optimized HLO of the replay gather (gfmat.xor_reduce_gather) to
<out>/gather_hlo.txt so the fusion can be read; the timings go to
<out>/gf_matmul_ab.json (--out, default build/gf_matmul_ab).

    python tools/gf_matmul_ab.py            # all phases (needs a GPU)
    python tools/gf_matmul_ab.py --quick    # compile + parity only
    python tools/gf_matmul_ab.py --sweep --no-e2e   # block-size sweep
    python tools/gf_matmul_ab.py --no-kernels       # end-to-end A/B only
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nanorq_tpu.utils.jax_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nanorq_tpu.gf256.bitplane import gf2_matmul_bytes  # noqa: E402
from nanorq_tpu.ops import gfmat, pallas_kernels  # noqa: E402

# (name, nb, m, k, t): the GF(2) shapes the codec's device paths run
SHAPES = [
    ("trisolve_chunk_CB256_t40960", 0, 256, 256, 40960),
    ("w_gf2_batch_nb64_kq1024", 64, 64, 1024, 1280),
    ("w_gf2_batch_nb64_kq4096", 64, 64, 4096, 1280),
    ("wut_K50000_t5120", 0, 51456, 512, 5120),
]


# block-size candidates (MB, TW, KB, num_warps, num_stages) for --sweep
SWEEP = [(64, 32, 64, 4, 2), (128, 32, 64, 8, 3), (64, 64, 64, 8, 2), (128, 16, 64, 4, 2),
         (256, 32, 32, 8, 2), (128, 32, 128, 8, 2)]


def _fn(nb, kernel, cfg=pallas_kernels.GF2_CFG):
    if kernel:
        one = lambda A, X: pallas_kernels._gf2_matmul(A, X, cfg, interpret=False)  # noqa: E731
    else:
        one = gfmat.gf2_matmul_xla
    return jax.jit(jax.vmap(one) if nb else one)


def _inputs(rng, nb, m, k, t):
    lead = (nb,) if nb else ()
    return rng.integers(0, 2, lead + (m, k), dtype=np.uint8), rng.integers(0, 256, lead + (k, t), dtype=np.uint8)


def _time(f, args, reps):
    out = f(*args)
    out.block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = f(*args)
        out.block_until_ready()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def kernel_phase(quick, results, sweep=False):
    rng = np.random.default_rng(0)
    for name, nb, m, k, t in SHAPES:
        A, X = _inputs(rng, nb, m, k, t)
        Aj, Xj = jnp.asarray(A), jnp.asarray(X)
        t0 = time.perf_counter()
        got = np.asarray(_fn(nb, True)(Aj, Xj))
        compile_s = time.perf_counter() - t0
        ref = np.asarray(_fn(nb, False)(Aj, Xj))
        exact = bool(np.array_equal(got, ref))
        if not nb and m * k * t <= (1 << 31):  # NumPy oracle where it is cheap
            exact = exact and bool(np.array_equal(got, gf2_matmul_bytes(A, X)))
        r = {"exact": exact, "kernel_first_call_s": round(compile_s, 3)}
        if not quick:
            r["kernel_ms"] = 1e3 * _time(_fn(nb, True), (Aj, Xj), 20)
            r["xla_ms"] = 1e3 * _time(_fn(nb, False), (Aj, Xj), 20)
        if sweep:
            for cfg in SWEEP:
                f = _fn(nb, True, cfg)
                ok = bool(np.array_equal(np.asarray(f(Aj, Xj)), ref))
                r[str(cfg)] = 1e3 * _time(f, (Aj, Xj), 20) if ok else "MISMATCH"
        results[name] = r
        print(name, json.dumps(r), flush=True)
        assert exact, f"{name}: kernel result differs from the XLA path"


def _e2e_setup(K, nblocks, T=1280, overhead=None):
    """Encoded blocks with 6% loss; overhead(sbn) repair symbols beyond the
    gaps (default 5% of K)."""
    from nanorq_tpu.codec.api import Encoder
    from nanorq_tpu.io.ioctx import MemoryIO

    rng = np.random.default_rng(7)
    F = K * T * nblocks
    data = rng.integers(0, 256, F, dtype=np.uint8)
    enc = Encoder(F, T, Al=8, Z=nblocks)
    src = MemoryIO(data)
    blocks = []
    for sbn in range(nblocks):
        gaps = np.nonzero(rng.random(K) < 0.06)[0]
        nrep = gaps.size + (max(1, int(0.05 * K)) if overhead is None else overhead(sbn))
        rep = np.arange(K, K + nrep)
        blocks.append((np.setdiff1d(np.arange(K), gaps), rep, enc.encode_batch(sbn, rep, src)))
    return data, enc, blocks


def _decode_once(data, enc, blocks, K, T=1280, warm=False):
    from nanorq_tpu.codec import cache as cc
    from nanorq_tpu.codec.api import Decoder
    from nanorq_tpu.codec.oti import make_tag
    from nanorq_tpu.io.ioctx import MemoryIO

    payloads = data.reshape(-1, T)
    out = np.zeros_like(data)
    io = MemoryIO(out)
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific())
    for sbn, (keep, rep, rep_pl) in enumerate(blocks):
        dec.add_symbols(payloads[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
        dec.add_symbols(rep_pl, [make_tag(sbn, int(e)) for e in rep], io)
    if not warm:
        cc.clear_decoder_cache()
    t0 = time.perf_counter()
    ok = dec.repair_all(io, backend="device")
    dt = time.perf_counter() - t0
    assert ok and np.array_equal(out, data), "device-arm decode not byte-exact"
    return dt


def _encode_once(data, K, nblocks, T=1280):
    from nanorq_tpu.codec.api import Encoder
    from nanorq_tpu.codec.batch import generate, load_object, repair_symbols
    from nanorq_tpu.io.ioctx import MemoryIO

    enc = Encoder(data.size, T, Al=8, Z=nblocks)
    t0 = time.perf_counter()
    batch = load_object(enc, MemoryIO(data))
    generate(batch)
    rep = repair_symbols(batch, 64)
    np.asarray(rep[0])
    return time.perf_counter() - t0


def _replay_once(batch):
    from nanorq_tpu.codec.batch import generate

    t0 = time.perf_counter()
    generate(batch)
    batch.C.block_until_ready()
    return time.perf_counter() - t0


def e2e_phase(results, K=1000, nblocks=64, reps=3):
    """Interleaved off/on/on/off A/B through the public entry points:
    device-arm decode with cold plans (solve included) and warm plans at 5%
    overhead (GF(2) W) and at overhead 1-2 (GF(256) W), the batched encode
    at K, and the object-level replay of a 256 MiB object at T=1280 (16
    blocks of K'=13143, structured path)."""
    from nanorq_tpu.codec.api import Encoder
    from nanorq_tpu.codec.batch import load_object
    from nanorq_tpu.io.ioctx import MemoryIO

    data, enc, blocks = _e2e_setup(K, nblocks)
    data256, enc256, blocks256 = _e2e_setup(K, nblocks, overhead=lambda sbn: 1 + sbn % 2)
    big = np.random.default_rng(3).integers(0, 256, 256 << 20, dtype=np.uint8)
    big_batch = load_object(Encoder(big.size, 1280, Al=8), MemoryIO(big))
    real_applies = pallas_kernels.kernel_applies
    keys = ("decode_cold_s", "decode_warm_s", "decode_gf256_cold_s", "decode_gf256_warm_s", "encode_s",
            "replay_256MiB_s")
    times = {arm: {k: [] for k in keys + ("replay_256MiB_first_s",)} for arm in ("xla", "kernel")}
    for arm in ("xla", "kernel", "kernel", "xla"):
        chosen = set()

        def applies(m, k, t, platform=None, arm=arm):
            use = arm == "kernel" and real_applies(m, k, t, platform)
            chosen.add((m, k, t, use))
            return use

        pallas_kernels.kernel_applies = applies
        jax.clear_caches()
        _decode_once(data, enc, blocks, K)  # compiles
        _decode_once(data256, enc256, blocks256, K)
        _encode_once(data, K, nblocks)
        times[arm]["replay_256MiB_first_s"].append(_replay_once(big_batch))
        row = {
            "decode_cold_s": [_decode_once(data, enc, blocks, K) for _ in range(reps)],
            "decode_warm_s": [_decode_once(data, enc, blocks, K, warm=True) for _ in range(reps)],
            "decode_gf256_cold_s": [_decode_once(data256, enc256, blocks256, K) for _ in range(reps)],
            "decode_gf256_warm_s": [_decode_once(data256, enc256, blocks256, K, warm=True) for _ in range(reps)],
            "encode_s": [_encode_once(data, K, nblocks) for _ in range(reps)],
            "replay_256MiB_s": [_replay_once(big_batch) for _ in range(reps)],
        }
        for k in keys:
            times[arm][k].append(statistics.median(row[k]))
        print(f"e2e {arm}: " + ", ".join(f"{k} {statistics.median(row[k]) * 1e3:.3f} ms" for k in keys)
              + f", replay_256MiB_first {times[arm]['replay_256MiB_first_s'][-1]:.1f} s", flush=True)
        print(f"e2e {arm}: GF(2) products (m, k, t, kernel): {sorted(chosen)}", flush=True)
    pallas_kernels.kernel_applies = real_applies
    jax.clear_caches()
    results[f"e2e_K{K}_nb{nblocks}"] = times


def hlo_phase(out):
    src = jnp.zeros((51457, 5120), jnp.uint8)
    idx = jnp.zeros((256, 8), jnp.int32)
    txt = jax.jit(gfmat.xor_reduce_gather).lower(src, idx).compile().as_text()
    with open(os.path.join(out, "gather_hlo.txt"), "w") as f:
        f.write(txt)
    fusions = [ln.strip()[:160] for ln in txt.splitlines() if "fusion" in ln and "=" in ln and "ROOT" not in ln]
    print("gather HLO fusions:", *fusions[:12], sep="\n  ")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="compile + parity only")
    ap.add_argument("--sweep", action="store_true", help="also time block-size candidates")
    ap.add_argument("--no-e2e", action="store_true", help="skip the end-to-end A/B")
    ap.add_argument("--no-kernels", action="store_true", help="skip the per-shape kernel timings")
    ap.add_argument("--out", default=os.path.join("build", "gf_matmul_ab"), help="directory for the outputs")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("no GPU visible to JAX")
    print("device:", jax.devices()[0].device_kind, "jax", jax.__version__, flush=True)
    os.system("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader")
    os.makedirs(args.out, exist_ok=True)
    results = {}
    if not args.no_kernels:
        kernel_phase(args.quick, results, args.sweep)
    if not (args.quick or args.no_e2e):
        hlo_phase(args.out)
        e2e_phase(results)
    with open(os.path.join(args.out, "gf_matmul_ab.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
