#!/usr/bin/env python3
"""On-card smoke test of the codec's main path (one NVIDIA GPU, or four).

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: only the sharded path

Phases on one card, each checked byte-exact:

1. device      the first JAX device must be a GPU (else exit 1, no result)
2. kernels     the fused GF(2) matmul kernel (ops/pallas_kernels.py) against
               the plain XLA path (ops/gfmat.py) and the NumPy oracles at real
               widths; the plain GF(256) W batch and the replay/LT gather
               against their NumPy oracles
3. large       a 256 MiB object at T=1280 in 4 blocks (K'~52k: structured
               replay), 6% loss + 5% overhead, Decoder.repair_all on the
               device arm and then on the default adaptive arm
4. mid         K=1000 x 32 blocks: stacked GF(2) W (5% overhead), GF(256) W
               with HDPC pivots (overhead 1-2), and the residual "res" arm;
               prints which GF(2) products each case sent to the kernel
5. cli         nanorq_tpu.cli.encode / decode in-process on a 64 MiB file

With --cards 4 only the mesh path runs: Encoder.encode_batch(mesh=),
codec.batch.generate(mesh=) and Decoder.repair_all(mesh=) over
parallel.mesh.auto_mesh(), each compared with the one-card result and the
source, and each checked to have placed work on all four devices.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
T = 1280


def log(msg: str) -> None:
    print(msg, flush=True)


class CompileClock:
    """Sums XLA backend compile seconds reported by jax.monitoring."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.total += duration


def exact(name: str, got, want) -> None:
    ok = np.array_equal(np.asarray(got), np.asarray(want))
    log(f"  {name}: {'byte-exact' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: result differs from the reference")


# --------------------------------------------------------------------- phase 2


def phase_kernels(rng) -> None:
    import jax
    import jax.numpy as jnp

    from nanorq_tpu.gf256.bitplane import gf2_matmul_bytes, gf256_matmul_bytes
    from nanorq_tpu.ops import gfmat, pallas_kernels
    from nanorq_tpu.ops.wpath import _w_gf256_batch_jit

    log("phase kernels: fused GF(2) matmul vs plain XLA vs NumPy oracle")
    t = 32 * T
    # trisolve chunk inverse: CB=256 over the replay width
    A = rng.integers(0, 2, (256, 256), dtype=np.uint8)
    X = rng.integers(0, 256, (256, t), dtype=np.uint8)
    assert pallas_kernels.kernel_applies(256, 256, t)
    got = gfmat.gf2_matmul(jnp.asarray(A), jnp.asarray(X))
    exact("gf2 chunk 256x256 t=40960 kernel vs xla", got, gfmat.gf2_matmul_xla(jnp.asarray(A), jnp.asarray(X)))
    exact("gf2 chunk 256x256 t=40960 kernel vs numpy", got, gf2_matmul_bytes(A, X))

    # Wut stage: tall coefficient matrix at K'~50k
    A = rng.integers(0, 2, (51456, 512), dtype=np.uint8)
    X = rng.integers(0, 256, (512, 4 * T), dtype=np.uint8)
    got = gfmat.gf2_matmul(jnp.asarray(A), jnp.asarray(X))
    exact("gf2 Wut 51456x512 t=5120 kernel vs xla", got, gfmat.gf2_matmul_xla(jnp.asarray(A), jnp.asarray(X)))
    exact("gf2 Wut rows 0:2048 kernel vs numpy", np.asarray(got)[:2048], gf2_matmul_bytes(A[:2048], X))

    # stacked W batches, as Decoder.repair_all's device arm runs them
    nb = 64
    for kq in (1024, 4096):
        A = rng.integers(0, 2, (nb, 64, kq), dtype=np.uint8)
        X = rng.integers(0, 256, (nb, kq, T), dtype=np.uint8)
        got = jax.jit(jax.vmap(gfmat.gf2_matmul))(A, X)
        exact(f"gf2 W batch nb={nb} kq={kq} kernel vs xla", got, jax.jit(jax.vmap(gfmat.gf2_matmul_xla))(A, X))
        exact(f"gf2 W batch nb={nb} kq={kq} blocks 0:4 vs numpy", np.asarray(got)[:4],
              np.stack([gf2_matmul_bytes(A[j], X[j]) for j in range(4)]))
    # GF(256) W batch (plain XLA) at the shape K=1000 with HDPC pivots sends
    W = rng.integers(0, 256, (nb, 64, 2048), dtype=np.uint8)
    X = rng.integers(0, 256, (nb, 2048, T), dtype=np.uint8)
    got = _w_gf256_batch_jit(W, X)
    exact("gf256 W batch nb=64 m=64 k=2048 blocks 0:2 vs numpy", np.asarray(got)[:2],
          np.stack([gf256_matmul_bytes(W[j], X[j]) for j in range(2)]))

    # LT / replay row gather-XOR at the replay width (plain XLA, no kernel)
    src = rng.integers(0, 256, (1072, t), dtype=np.uint8)
    idx = rng.integers(0, 1072, (1024, 8), dtype=np.int32)
    got = gfmat.xor_reduce_gather(jnp.asarray(src), jnp.asarray(idx))
    exact("gather-xor 1024x8 t=40960 vs numpy", got, np.bitwise_xor.reduce(src[idx], axis=1))


# --------------------------------------------------------------- phases 3 to 5


def _encode_received(enc, src_io, rng, loss=0.06, overhead=None, mesh=None):
    """Per block: (keep ESIs, repair ESIs, repair payloads) with a fresh loss
    pattern; overhead defaults to 5% of K."""
    blocks = []
    for sbn in range(enc.num_blocks):
        K = enc.block_symbols(sbn)
        gaps = np.nonzero(rng.random(K) < loss)[0]
        ov = max(1, int(0.05 * K)) if overhead is None else overhead(sbn)
        rep = np.arange(K, K + gaps.size + ov)
        blocks.append((np.setdiff1d(np.arange(K), gaps), rep, enc.encode_batch(sbn, rep, src_io, mesh=mesh)))
    return blocks


def _decoder(enc, blocks, read_src, out):
    from nanorq_tpu.codec.api import Decoder
    from nanorq_tpu.codec.oti import make_tag
    from nanorq_tpu.io.ioctx import MemoryIO

    io = MemoryIO(out)
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific())
    for sbn, (keep, rep, rep_pl) in enumerate(blocks):
        dec.add_symbols(read_src(sbn, keep), [make_tag(sbn, int(e)) for e in keep], io)
        dec.add_symbols(rep_pl, [make_tag(sbn, int(e)) for e in rep], io)
    return dec, io


def _src_reader(enc, src_io):
    def read(sbn, keep):
        K = enc.block_symbols(sbn)
        return np.stack([enc._read_symbol(src_io, sbn, int(e), K) for e in keep])

    return read


def _plan_kinds(dec) -> set:
    from nanorq_tpu.codec import cache as cc
    from nanorq_tpu.precode.device_schedule import DeviceSchedule

    kinds = set()
    for sbn in range(dec.num_blocks):
        prep = dec._repair_prepare(sbn)
        if isinstance(prep, bool):
            continue
        plan = cc.decoder_plan(dec.P, prep[1], prep[2])
        if isinstance(plan, DeviceSchedule):
            kinds.add("structured")
        elif plan is not None:
            kinds.add("W-gf2" if plan.Wbits is not None else "W-gf256")
    return kinds  # (solving here caches the plans the repair then uses)


class KernelChoices:
    """Records the GF(2) products traced while active and whether
    pallas_kernels.kernel_applies sent each to the kernel."""

    def __enter__(self):
        from nanorq_tpu.ops import pallas_kernels

        self.mod, self.real, self.seen = pallas_kernels, pallas_kernels.kernel_applies, set()

        def applies(m, k, t, platform=None):
            use = self.real(m, k, t, platform)
            self.seen.add((m, k, t, use))
            return use

        self.mod.kernel_applies = applies
        return self

    def __exit__(self, *exc):
        self.mod.kernel_applies = self.real

    def summary(self) -> str:
        if not self.seen:
            return "no GF(2) product traced (GF(256) is plain XLA; GF(2) programs traced earlier)"
        return ", ".join(f"{m}x{k} t={t} -> {'kernel' if use else 'xla'}" for m, k, t, use in sorted(self.seen))


def _repair(dec, io, backend=None, mesh=None) -> float:
    t0 = time.perf_counter()
    ok = dec.repair_all(io, backend=backend, mesh=mesh)
    assert ok, f"repair_all(backend={backend}) did not recover every block"
    return time.perf_counter() - t0


def phase_large(rng, clock, F: int = 256 << 20, Z: int = 4) -> None:
    from nanorq_tpu.codec import cache as cc
    from nanorq_tpu.codec.api import Encoder
    from nanorq_tpu.io.ioctx import MemoryIO

    log(f"phase large: {F >> 20} MiB object, T={T}, Al=8, Z={Z}")
    data = rng.integers(0, 256, F, dtype=np.uint8)
    # Z=4 puts K near 52k (K' > 16384: structured replay); the default
    # partition of this object is 16 blocks of K'=13143 (dense-W decode)
    enc = Encoder(F, T, Al=8, Z=Z)
    src = MemoryIO(data)
    log(f"  blocks={enc.num_blocks} K={[enc.block_symbols(s) for s in range(enc.num_blocks)]} K'={enc.P.Kp}")
    c0, t0 = clock.total, time.perf_counter()
    blocks = _encode_received(enc, src, rng)
    log(f"  encode_s {time.perf_counter() - t0:.3f} (compile_s {clock.total - c0:.3f})")

    out = np.zeros(F, np.uint8)
    dec, io = _decoder(enc, blocks, _src_reader(enc, src), out)
    c0 = clock.total
    dt = _repair(dec, io, backend="device")
    log(f"  decode_device_s {dt:.3f} (compile_s {clock.total - c0:.3f})")
    exact("large object repair_all(backend='device')", out, data)

    cc.clear_decoder_cache()
    out[:] = 0
    dec, io = _decoder(enc, blocks, _src_reader(enc, src), out)
    c0 = clock.total
    dt = _repair(dec, io)
    log(f"  decode_auto_s {dt:.3f} (compile_s {clock.total - c0:.3f})")
    exact("large object repair_all(backend=auto)", out, data)


def phase_mid(rng, K: int = 1000, Z: int = 32) -> None:
    from nanorq_tpu.codec.api import Encoder
    from nanorq_tpu.io.ioctx import MemoryIO

    log(f"phase mid: K={K} x {Z} blocks, T={T}")
    data = rng.integers(0, 256, K * T * Z, dtype=np.uint8)
    enc = Encoder(data.size, T, Al=8, Z=Z)
    src = MemoryIO(data)
    read = _src_reader(enc, src)
    cases = [
        ("W GF(2), 5% overhead", None, "device", {"W-gf2"}),
        ("W GF(256), overhead 1-2", lambda s: 1 + s % 2, "device", {"W-gf256"}),
        ("res arm, 5% overhead", None, "res", None),
    ]
    for label, ov, backend, want_kinds in cases:
        blocks = _encode_received(enc, src, rng, overhead=ov)
        out = np.zeros_like(data)
        dec, io = _decoder(enc, blocks, read, out)
        if want_kinds is not None:
            kinds = _plan_kinds(dec)
            assert kinds == want_kinds, f"{label}: planner chose {kinds}"
        with KernelChoices() as choices:
            dt = _repair(dec, io, backend=backend)
        log(f"  {label}: repair_all(backend={backend!r}) {dt:.3f} s")
        log(f"  {label}: {choices.summary()}")
        exact(f"mid {label}", out, data)


def phase_cli(rng, workdir, size: int = 64 << 20) -> None:
    from nanorq_tpu.cli import decode as cli_decode
    from nanorq_tpu.cli import encode as cli_encode

    log(f"phase cli: {size >> 20} MiB file through nanorq-encode / nanorq-decode in-process")
    path = os.path.join(workdir, "object.bin")
    data = rng.integers(0, 256, size, dtype=np.uint8)
    data.tofile(path)
    rq, back = os.path.join(workdir, "data.rq"), os.path.join(workdir, "object.out")
    t0 = time.perf_counter()
    assert cli_encode.main([path, str(T), "-o", rq, "--seed", "1"]) == 0
    assert cli_decode.main([back, "-i", rq]) == 0
    log(f"  cli round trip {time.perf_counter() - t0:.3f} s")
    exact("cli round trip", np.fromfile(back, np.uint8), data)


# --------------------------------------------------------------------- 4 cards


def phase_mesh(rng, n_dev: int, F: int = 32 << 20, K: int = 1000, Z: int = 32) -> None:
    import jax

    from nanorq_tpu.codec import api
    from nanorq_tpu.codec.api import Encoder
    from nanorq_tpu.codec.batch import generate, load_object
    from nanorq_tpu.io.ioctx import MemoryIO
    from nanorq_tpu.parallel.mesh import auto_mesh

    mesh = auto_mesh()
    assert mesh is not None and mesh.devices.size == n_dev, f"auto_mesh() gave {mesh}"
    log(f"phase mesh: auto_mesh() over {mesh.devices.size} devices {mesh.shape}")

    def spread(x, what):
        n = len(x.sharding.device_set)
        log(f"  {what}: on {n} devices")
        assert n == n_dev, f"{what} ran on {n} of {n_dev} devices"

    # object-level replay of 4 blocks side by side, sharded vs one card
    data = rng.integers(0, 256, F, dtype=np.uint8)
    enc = Encoder(F, T, Al=8, Z=4)
    src = MemoryIO(data)
    one = load_object(enc, src)
    generate(one)
    sharded = load_object(enc, src)
    generate(sharded, mesh=mesh)
    spread(sharded.C, "codec.batch.generate(mesh=) intermediates")
    exact("generate(mesh=) vs one card", np.asarray(sharded.C)[:, : one.C.shape[1]], one.C)

    # encode_batch(mesh=) vs one card, then repair_all(mesh=) on cold patterns
    data = rng.integers(0, 256, K * T * Z, dtype=np.uint8)
    src = MemoryIO(data)
    enc_m, enc_1 = Encoder(data.size, T, Al=8, Z=Z), Encoder(data.size, T, Al=8, Z=Z)
    seed = int(rng.integers(1 << 31))
    blocks_m = _encode_received(enc_m, src, np.random.default_rng(seed), mesh=mesh)
    blocks_1 = _encode_received(enc_1, src, np.random.default_rng(seed))
    for (_, _, pm), (_, _, p1) in zip(blocks_m, blocks_1):
        assert np.array_equal(pm, p1), "encode_batch(mesh=) differs from one card"
    log("  encode_batch(mesh=) vs one card: byte-exact")
    spread(enc_m._blocks[0].C, "encode_batch(mesh=) intermediates")

    placed = []
    orig = api._BatchResult.__init__

    def record(self, dev):
        placed.append(len(dev.sharding.device_set))
        orig(self, dev)

    api._BatchResult.__init__ = record
    try:
        out_m = np.zeros_like(data)
        dec, io = _decoder(enc_m, blocks_m, _src_reader(enc_m, src), out_m)
        dt = _repair(dec, io, mesh=mesh)
    finally:
        api._BatchResult.__init__ = orig
    log(f"  repair_all(mesh=) {dt:.3f} s, stacked batches on devices: {placed}")
    assert placed and all(n == n_dev for n in placed), "repair batches not spread over the mesh"
    out_1 = np.zeros_like(data)
    dec, io = _decoder(enc_1, blocks_1, _src_reader(enc_1, src), out_1)
    _repair(dec, io, backend="device")
    exact("repair_all(mesh=) vs one card", out_m, out_1)
    exact("repair_all(mesh=) vs source", out_m, data)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded path over four cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "nanorq_tpu")):
        print("chip_smoke.py must run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from nanorq_tpu.utils.jax_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU visible to JAX (platform {devs[0].platform!r})", file=sys.stderr)
        return 1
    if len(devs) < args.cards:
        print(f"--cards {args.cards} needs {args.cards} GPUs, JAX sees {len(devs)}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"jax {jax.__version__}, device_kind {devs[0].device_kind!r}, {len(devs)} device(s)")

    rng = np.random.default_rng(args.seed)
    t_all = time.perf_counter()
    if args.cards == 4:
        phase_mesh(rng, 4)
    else:
        clock = CompileClock()
        phase_kernels(rng)
        phase_large(rng, clock)
        phase_mid(rng)
        workdir = tempfile.mkdtemp(prefix="nanorq_smoke_")
        try:
            phase_cli(rng, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"compile_s total {clock.total:.3f}")
    count = len(devs)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
