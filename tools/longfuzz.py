#!/usr/bin/env python3
"""Long-running end-to-end fuzz (CPU): randomized configs well beyond the
pytest grid (tests/test_fuzz.py), meant for soak runs on a spare CPU
or overnight.

    python tools/longfuzz.py [minutes] [base_seed]

Each trial randomizes size/T/Al/Z/N, delivery order, ingestion style
(per-symbol vs batched, with duplicates and malformed packets mixed in),
the IO backend (memory / file / mmap), the plan path (dense-W vs structured
via the NANORQ_WPATH_MAX_KP knob), and repair entry point (repair_block vs
repair_all).  Every trial must end with byte-exact recovery; any failure
prints the full config for replay.
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_trial(seed: int) -> dict:
    from nanorq_tpu.codec import cache as cc
    from nanorq_tpu.codec.api import SYM_ERR, Decoder, Encoder
    from nanorq_tpu.codec.oti import make_tag
    from nanorq_tpu.io.ioctx import FileIO, MemoryIO, MmapIO

    rng = np.random.default_rng(seed)
    size = int(rng.integers(1, 120_000))
    T = int(rng.choice([8, 17, 64, 100, 256, 512, 1280, 2048]))
    Al = int(rng.choice([1, 2, 4, 8]))
    Z = int(rng.choice([0, 1, 2, 3, 5]))
    N = int(rng.choice([1, 1, 1, 2, 4]))
    N = max(1, min(N, T // Al))  # sub-blocking needs N sub-symbols per symbol
    loss = float(rng.uniform(0, 0.45))
    overhead = int(rng.integers(0, 9))
    batched = bool(rng.random() < 0.5)
    shuffle = bool(rng.random() < 0.5)
    dup_rate = float(rng.uniform(0, 0.15))
    backend = str(rng.choice(["mem", "file", "mmap"]))
    force_structured = bool(rng.random() < 0.3)
    use_repair_all = bool(rng.random() < 0.4)
    cfg = dict(seed=seed, size=size, T=T, Al=Al, Z=Z, N=N, loss=round(loss, 3),
               overhead=overhead, batched=batched, shuffle=shuffle,
               dup_rate=round(dup_rate, 3), backend=backend,
               force_structured=force_structured, use_repair_all=use_repair_all)

    old_env = os.environ.get("NANORQ_WPATH_MAX_KP")
    if force_structured:
        os.environ["NANORQ_WPATH_MAX_KP"] = "0"
    # the knobs are read at import; patch the module values directly too.
    # Both W gates must drop for hdpc-pivot patterns to take the canonical
    # structured path this mode exists to exercise.
    cc.WPATH_MAX_KP = 0 if force_structured else 16384
    old_gf256 = cc.WPATH_GF256_MAX_KP
    if force_structured:
        cc.WPATH_GF256_MAX_KP = 0

    tmp = None
    try:
        data = rng.integers(0, 256, size, dtype=np.uint8)
        enc = Encoder(size, T, Al=Al, Z=Z, N=N)
        dec = Decoder(enc.oti_common(), enc.oti_scheme_specific())
        # tiny blocks + heavy loss/overhead/retries can push repair ESIs
        # past the default max_esi = 2*K' (which the reference also
        # rejects, nanorq.c:374); raise it like a real receiver would
        assert dec.set_max_esi(min((1 << 24) - 1, 8 * dec.P.Kp + 256))
        io_in = MemoryIO(data)
        if backend == "mem":
            out = np.zeros(size, np.uint8)
            io_out = MemoryIO(out)
        else:
            tmp = tempfile.NamedTemporaryFile(delete=False)
            tmp.close()
            io_out = (FileIO(tmp.name, write=True, create_size=size) if backend == "file"
                      else MmapIO(tmp.name, write=True, create_size=size))

        # per-block packet plan
        packets = []  # (tag, payload)
        drops = {}
        for sbn in range(enc.num_blocks):
            K = enc.block_symbols(sbn)
            kept = [e for e in range(K) if rng.random() >= loss]
            dropped = K - len(kept)
            esis = kept + list(range(K, K + dropped + overhead))
            pl = enc.encode_batch(sbn, np.array(esis), io_in)
            for esi, p in zip(esis, pl):
                packets.append((make_tag(sbn, esi), p))
                if rng.random() < dup_rate:
                    packets.append((make_tag(sbn, esi), p))  # duplicate
            drops[sbn] = (dropped, dropped + overhead)
        if shuffle:
            order = rng.permutation(len(packets))
            packets = [packets[i] for i in order]
        # a few malformed packets (wrong length / bad sbn) — must be rejected
        bad = [(make_tag(enc.num_blocks + 3, 0), packets[0][1]),
               (packets[0][0], packets[0][1][: max(1, T // 2)])]

        if batched:
            tags = np.array([t for t, _ in packets], np.int64)
            pls = np.stack([p for _, p in packets])
            sts = dec.add_symbols(pls, tags, io_out)
            assert all(s != SYM_ERR for s in sts), "valid packet rejected"
            for t, p in bad:
                assert dec.add_symbol(np.ascontiguousarray(p), t, io_out) == SYM_ERR
        else:
            for t, p in packets:
                assert dec.add_symbol(p.tobytes(), t, io_out) != SYM_ERR
            for t, p in bad:
                assert dec.add_symbol(p.tobytes(), t, io_out) == SYM_ERR

        def feed_more(sbn, start, n):
            esis = list(range(start, start + n))
            pl = enc.encode_batch(sbn, np.array(esis), io_in)
            for esi, p in zip(esis, pl):
                dec.add_symbol(p.tobytes(), make_tag(sbn, esi), io_out)

        if use_repair_all:
            ok = dec.repair_all(io_out)
            tries = 0
            while not ok and tries < 5:
                for sbn in range(enc.num_blocks):
                    if dec.num_missing(sbn):
                        K = enc.block_symbols(sbn)
                        start = K + drops[sbn][1] + 4 * tries
                        feed_more(sbn, start, 4)
                ok = dec.repair_all(io_out)
                tries += 1
            assert ok, "repair_all unrecoverable"
        else:
            for sbn in range(enc.num_blocks):
                ok = dec.repair_block(io_out, sbn)
                tries = 0
                while not ok and tries < 5:
                    K = enc.block_symbols(sbn)
                    feed_more(sbn, K + drops[sbn][1] + 4 * tries, 4)
                    ok = dec.repair_block(io_out, sbn)
                    tries += 1
                assert ok, f"sbn={sbn} unrecoverable"

        if backend == "mem":
            got = out
        else:
            io_out.close()
            got = np.fromfile(tmp.name, np.uint8)
        assert got.size == size and np.array_equal(got, data), "byte mismatch"
        return cfg
    finally:
        if old_env is None:
            os.environ.pop("NANORQ_WPATH_MAX_KP", None)
        else:
            os.environ["NANORQ_WPATH_MAX_KP"] = old_env
        cc.WPATH_MAX_KP = int(os.environ.get("NANORQ_WPATH_MAX_KP", 16384))
        cc.WPATH_GF256_MAX_KP = old_gf256
        if tmp is not None:
            os.unlink(tmp.name)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    minutes = float(sys.argv[1]) if len(sys.argv) > 1 else 30.0
    base = int(sys.argv[2]) if len(sys.argv) > 2 else 7_000_000
    t_end = time.time() + minutes * 60
    n = 0
    while time.time() < t_end:
        seed = base + n
        try:
            cfg = run_trial(seed)
        except Exception as e:
            print(f"FUZZ FAILURE at seed={seed}: {e!r}")
            print(f"  replay: run_trial({seed})")
            raise
        n += 1
        if n % 25 == 0:
            print(f"[longfuzz] {n} trials ok, last cfg {cfg}", flush=True)
    print(f"[longfuzz] DONE: {n} trials, all byte-exact")


if __name__ == "__main__":
    main()
