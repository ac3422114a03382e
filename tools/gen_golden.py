#!/usr/bin/env python3
"""Regenerate the golden regression corpus (tests/golden/).

Pins encoded-payload bytes against silent regressions: for each config a
deterministic payload is encoded through the CLI wire format
(reference encode.c:87-94) with a seeded loss pattern, and the manifest
records SHA256 of (a) the data.rq stream and (b) the repair-symbol payloads
alone.  tests/test_golden.py decodes every committed file bit-exact and
re-encodes the repair symbols byte-identically — any change to the RFC 6330
math, the solver, or the device kernels that alters a single payload byte
turns the suite red.

Bit-exactness is backend-independent (all codec arithmetic is exact GF(2)/
GF(256)); generation forces the CPU backend so regen never needs a GPU.
The configs cover multi-block objects, N>1 sub-blocking, short final
symbols (F not a multiple of T), odd alignments, heavy loss, and the
HDPC-pivot regime (small K with overhead < H).

    python tools/gen_golden.py          # rewrites tests/golden/*
"""

import hashlib
import json
import os
import struct
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "tests", "golden")

# (name, F, T, Al, Z, loss_pct, overhead, seed)
CONFIGS = [
    ("k1_t16", 16, 16, 1, 1, 0.0, 2, 1),            # K=1 degenerate
    ("small_hdpc", 640, 16, 1, 1, 30.0, 1, 2),      # K=40, overhead < H -> HDPC pivots
    ("k100", 12800, 128, 4, 1, 6.0, 5, 3),          # the reference bench shape, scaled
    ("short_final", 12345, 128, 1, 1, 6.0, 5, 4),   # F % T != 0: zero-padded final symbol
    ("multiblock", 9000, 48, 1, 4, 10.0, 3, 5),     # Z=4 blocks, distinct patterns
    ("subblock_n", 16384, 256, 8, 2, 6.0, 4, 6),    # N>1 sub-block interleaving
    ("heavy_loss", 25600, 64, 1, 2, 40.0, 8, 7),    # 40% loss
    ("t1280", 64000, 1280, 8, 1, 6.0, 5, 8),        # reference packet size
    ("odd_al", 7777, 24, 8, 1, 6.0, 3, 9),          # T forced to Al multiple
    ("k500", 48000, 96, 4, 2, 6.0, 5, 10),          # K=500-ish, two blocks
]


def gen_one(name, F, T, Al, Z, loss, overhead, seed):
    import random

    from nanorq_tpu.codec.api import Encoder
    from nanorq_tpu.codec.batch import generate, load_object, repair_symbols, source_symbol
    from nanorq_tpu.codec.oti import make_tag
    from nanorq_tpu.io.ioctx import MemoryIO

    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, F, dtype=np.uint8)
    enc = Encoder(F, T, Al=Al, Z=Z)
    batch = load_object(enc, MemoryIO(data))
    generate(batch)

    pr = random.Random(seed)
    drops = []
    for sbn in range(enc.num_blocks):
        num_esi = enc.block_symbols(sbn)
        kept = [e for e in range(num_esi) if pr.random() * 100.0 >= loss]
        drops.append((kept, num_esi - len(kept)))
    max_rep = max(d for _, d in drops) + overhead
    rep = repair_symbols(batch, max_rep)

    rq = bytearray()
    rq += struct.pack("<QI", enc.oti_common(), enc.oti_scheme_specific())
    rep_sha = hashlib.sha256()
    for b, sbn in enumerate(batch.sbns):
        num_esi = enc.block_symbols(sbn)
        kept, dropped = drops[b]
        for esi in kept:
            rq += struct.pack("<I", make_tag(sbn, esi))
            rq += source_symbol(batch, b, esi).tobytes()
        for ri in range(dropped + overhead):
            payload = rep[b][ri].tobytes()
            rq += struct.pack("<I", make_tag(sbn, num_esi + ri))
            rq += payload
            rep_sha.update(payload)
    return bytes(rq), {
        "F": F, "T": T, "Al": Al, "Z": Z, "loss": loss, "overhead": overhead,
        "seed": seed,
        "sha256_rq": hashlib.sha256(bytes(rq)).hexdigest(),
        "sha256_repair": rep_sha.hexdigest(),
        "sha256_data": hashlib.sha256(data.tobytes()).hexdigest(),
    }


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    manifest = {}
    for cfg in CONFIGS:
        name = cfg[0]
        rq, meta = gen_one(*cfg)
        with open(os.path.join(GOLDEN_DIR, name + ".rq"), "wb") as f:
            f.write(rq)
        manifest[name] = meta
        print(f"{name}: {len(rq)} bytes rq, repair sha {meta['sha256_repair'][:16]}")
    manifest["_validation"] = (
        "sha256_data is cross-implementation conformance-validated: every "
        ".rq stream here decodes bit-exact under the REFERENCE C binary "
        "(built with tests/interop/oblas_shim; gate: tests/test_interop.py"
        "::test_golden_corpus_reference_decodes), not just re-decoded by "
        "the implementation that produced it."
    )
    with open(os.path.join(GOLDEN_DIR, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"wrote {len(manifest)} golden files to {GOLDEN_DIR}")


if __name__ == "__main__":
    main()
