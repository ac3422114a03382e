"""CLI decoder: data.rq -> output file (reference decode.c parity)."""

import argparse
import os
import struct
import sys

from nanorq_tpu.codec.api import SYM_ERR, Decoder
from nanorq_tpu.io.ioctx import FileIO
from nanorq_tpu.utils.jax_cache import enable_compile_cache


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nanorq-decode")
    ap.add_argument("filename", help="output file to reconstruct into")
    ap.add_argument("-i", "--input", default="data.rq")
    ap.add_argument(
        "--layout-cache",
        default=None,
        metavar="DIR",
        help="persist the per-K' frozen decode layouts across invocations "
        "(the decoder-side analog of the reference's nanorq_precalculate: "
        "a warm layout means loss patterns reuse already-compiled replay "
        "programs instead of re-walking the freeze warm-up)",
    )
    ap.add_argument(
        "--mesh",
        choices=("auto", "off"),
        default="off",
        help="'auto' shards the stacked per-block repair batches over a 1-D "
        "mesh of all local devices (per-SBN independence, zero-collective "
        "SPMD); single-device hosts fall back to 'off'",
    )
    args = ap.parse_args(argv)
    # persistent XLA cache: repeat CLI invocations skip device recompiles
    enable_compile_cache()
    mesh = None
    if args.mesh == "auto":
        from nanorq_tpu.parallel.mesh import auto_mesh

        mesh = auto_mesh()

    lay_path = None
    if args.layout_cache:
        from nanorq_tpu.precode.device_schedule import load_layout_cache

        os.makedirs(args.layout_cache, exist_ok=True)
        lay_path = os.path.join(args.layout_cache, "decode_layouts.bin")
        if os.path.exists(lay_path):
            n = load_layout_cache(lay_path)
            print(f"loaded {n} frozen decode layout(s) from {lay_path}", file=sys.stderr)

    with open(args.input, "rb") as ih:
        oti_common, oti_scheme = struct.unpack("<QI", ih.read(12))
        dec = Decoder(oti_common, oti_scheme)
        T = dec.symbol_size
        with FileIO(args.filename, write=True, create_size=dec.transfer_length) as io:
            while True:
                hdr = ih.read(4)
                if len(hdr) < 4:
                    break
                (tag,) = struct.unpack("<I", hdr)
                packet = ih.read(T)
                if dec.add_symbol(packet, tag, io) == SYM_ERR:
                    print(f"adding symbol {tag} failed.", file=sys.stderr)
                    return 1
            for sbn in range(dec.num_blocks):
                print(
                    f"block {sbn} is {dec.block_symbols(sbn)} packets, "
                    f"lost {dec.num_missing(sbn)}, have {dec.num_repair(sbn)} repair"
                )
            # pipelined multi-block repair: host pattern-solves run in a
            # thread pool, overlapped with device replays (api.repair_all).
            # --layout-cache forces the device arm: the persisted layouts
            # only exist for device plans, so the adaptive host arm would
            # leave nothing to save.
            backend = "device" if lay_path is not None else None
            ok = dec.repair_all(io, mesh=mesh, backend=backend)
            if not ok:
                for sbn in range(dec.num_blocks):
                    if dec.num_missing(sbn):
                        print(f"decode of sbn {sbn} failed.", file=sys.stderr)
            for sbn in range(dec.num_blocks):
                dec.cleanup(sbn)
    if lay_path is not None:
        from nanorq_tpu.precode.device_schedule import save_layout_cache

        save_layout_cache(lay_path)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
