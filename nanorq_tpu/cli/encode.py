"""CLI encoder: file -> data.rq packet stream (reference encode.c parity).

Wire format (encode.c:87-94): little-endian u64 oti_common, u32 oti_scheme,
then (u32 tag, T-byte payload) records.  Simulates 6% random source-packet
drop and emits dropped+5 repair symbols per block, like the reference
(encode.c:28-44).
"""

import argparse
import os
import random
import struct
import sys

from nanorq_tpu.codec.api import Encoder
from nanorq_tpu.codec.oti import make_tag
from nanorq_tpu.io.ioctx import FileIO
from nanorq_tpu.utils.jax_cache import enable_compile_cache


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nanorq-encode")
    ap.add_argument("filename")
    ap.add_argument("packet_size", type=int)
    ap.add_argument("-o", "--output", default="data.rq")
    ap.add_argument("--loss", type=float, default=6.0, help="simulated drop %%")
    ap.add_argument("--overhead", type=int, default=5, help="extra repair per block")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument(
        "--schedule-cache",
        default=None,
        metavar="DIR",
        help="persist the per-K' encoder schedule to disk (the reference's "
        "nanorq_precalculate across processes: a warm start skips the "
        "schedule solve entirely)",
    )
    ap.add_argument(
        "--mesh",
        choices=("auto", "off"),
        default="off",
        help="'auto' shards the object-level replay + LT combine over a 1-D "
        "mesh of all local devices (blocks side by side on the width axis, "
        "zero-collective SPMD); single-device hosts fall back to 'off'",
    )
    args = ap.parse_args(argv)
    # persistent XLA cache: repeat CLI invocations skip device recompiles
    enable_compile_cache()
    mesh = None
    if args.mesh == "auto":
        from nanorq_tpu.parallel.mesh import auto_mesh

        mesh = auto_mesh()

    rng = random.Random(args.seed)
    with FileIO(args.filename) as io:
        filesize = io.size()
        enc = Encoder(filesize, args.packet_size, Al=8)
        if args.schedule_cache:
            from nanorq_tpu.codec.cache import warm_encoder_cache

            warm_encoder_cache(enc.P.Kp, args.schedule_cache)
        # object-level batched path: one device replay for all blocks, one
        # LT combine per K group (codec/batch.py)
        from nanorq_tpu.codec.batch import generate, load_object, repair_symbols, source_symbol

        batch = load_object(enc, io)
        generate(batch, mesh=mesh)
        drops = []
        for sbn in range(enc.num_blocks):
            num_esi = enc.block_symbols(sbn)
            kept = [e for e in range(num_esi) if rng.random() * 100.0 >= args.loss]
            drops.append((kept, num_esi - len(kept)))
        max_rep = max(d for _, d in drops) + args.overhead if drops else 0
        rep = repair_symbols(batch, max_rep, mesh=mesh) if max_rep else {}
        with open(args.output, "wb") as oh:
            oh.write(struct.pack("<QI", enc.oti_common(), enc.oti_scheme_specific()))
            for b, sbn in enumerate(batch.sbns):
                num_esi = enc.block_symbols(sbn)
                kept, dropped = drops[b]
                for esi in kept:
                    oh.write(struct.pack("<I", make_tag(sbn, esi)))
                    oh.write(source_symbol(batch, b, esi).tobytes())
                n_rep = dropped + args.overhead
                for ri in range(n_rep):
                    oh.write(struct.pack("<I", make_tag(sbn, num_esi + ri)))
                    oh.write(rep[b][ri].tobytes())
                print(
                    f"block {sbn} is {num_esi} packets, dropped {dropped}, "
                    f"created {n_rep} repair",
                    file=sys.stdout,
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
