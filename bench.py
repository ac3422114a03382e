#!/usr/bin/env python3
"""Benchmark harness, mirroring the reference's benchmark.c semantics.

Reference harness (benchmark.c): in-memory random object of K*T bytes, four
configs — encode (fresh schedule), precalc encode (schedule reused), decode
at 0% loss, decode at 6% loss + 5% repair overhead — each normalized to
256 MiB processed, reported in Mb/s.  Reference numbers: BASELINE.md.

Device mapping: the schedule solve runs on host once per (K', pattern) and
is cached (our design makes every encode a "precalc" encode; the fresh-solve
latency is reported separately as solve_ms).  Payload math runs on the GPU;
throughput is measured with batched steps chained inside one jit, each timed
region closed by block_until_ready.  Batch = B independent blocks laid side
by side.  The run needs a GPU: with none visible it exits non-zero.

Configs reported per K:
- encode      = replay + LT emission of all K' symbols (the honest analog of
                the reference's timed encode region; headline)
- encode_replay = intermediate-symbol generation only (precode replay)
- decode0     = 0% loss: pure batched ingestion + no-op repair through the
                public Decoder API (host path, reference benchmark.c:118-160)
- decode      = 6% loss + 5% overhead, warm plan: device replay throughput
                of one pattern's compiled plan (sustained device ceiling)
- decode_e2e  = 6% loss + 5% overhead, FRESH pattern per block: per-pattern
                host solves + schedule uploads + replays all inside the
                timed region (the honest analog of the reference's
                decode-oh5 column, benchmark.c:143-151 — invert included);
                vs_ref and the headline aggregate use this

Prints one JSON line:
  {"metric": ..., "value": N, "unit": "Gbps", "vs_baseline": N, ...}
Headline: encode+decode aggregate at K=1000, T=1280 on one GPU vs the
reference's same aggregate on its i5-8400 core (precalc 7.9 + decode-oh5
6.6 Gb/s harmonic => 3.60 Gbps).  Per-K detail includes vs_ref ratios.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# heartbeat for the mid-run stall watchdog (see main): long measurements
# touch this so a single slow-but-alive cell is not mistaken for a hang
_BEAT = [time.time()]


def beat():
    _BEAT[0] = time.time()

# persistent XLA compilation cache: repeat invocations skip the first
# compile of the replay programs
from nanorq_tpu.utils.jax_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

REF_BASELINE = {  # Mb/s from BASELINE.md (graph.png)
    100: {"encode": 5450, "precalc": 10200, "decode": 5600, "decode_oh5": 5800},
    500: {"encode": 4750, "precalc": 8200, "decode": 4800, "decode_oh5": 6750},
    1000: {"encode": 4700, "precalc": 7900, "decode": 4850, "decode_oh5": 6600},
    5000: {"encode": 3750, "precalc": 5900, "decode": 3900, "decode_oh5": 5000},
    10000: {"encode": 2900, "precalc": 4050, "decode": 3000, "decode_oh5": 3550},
    50000: {"encode": 1500, "precalc": 2100, "decode": 1550, "decode_oh5": 1950},
}

# blocks per batch per K (not yet swept on the GPU; other K take 8)
DEFAULT_B = {100: 32, 500: 32, 1000: 32, 5000: 8, 10000: 8, 50000: 1}
# a warm decode rate above the H100's HBM bandwidth (3.35 TB/s, NVIDIA data
# sheet) means the timed region degenerated
HBM_GBPS = 8 * 3350

# decode_e2e block counts: enough distinct-pattern blocks that the timed
# region (solves + uploads + replays) dominates fixed per-call cost even at
# small K, bounded by Z_max = 256 and staging cost at large K
E2E_BLOCKS = {100: 128, 500: 64, 1000: 64, 5000: 16, 10000: 8, 50000: 8}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def bench_decode0(K, T, blocks, iters):
    """0%-loss decode: batched ingestion + no-op repair via the public API."""
    from nanorq_tpu.codec.api import SYM_ADDED, Decoder, Encoder
    from nanorq_tpu.codec.oti import make_tag
    from nanorq_tpu.io.ioctx import MemoryIO

    rng = np.random.default_rng(1)
    F = K * T * blocks
    data = rng.integers(0, 256, F, dtype=np.uint8)
    enc = Encoder(F, T, Al=8, Z=blocks)
    payloads = data.reshape(blocks * K, T)
    tags = np.array([make_tag(sbn, e) for sbn in range(blocks) for e in range(K)], np.int64)
    # output buffer allocated once, like the reference's run loop
    # (benchmark.c:172-217) — fresh pages would otherwise put ~20 ms of
    # page faults inside the timed region at 40 MB batches
    out = np.zeros(F, np.uint8)
    io = MemoryIO(out)
    best = float("inf")
    for _ in range(max(3, iters)):
        dec = Decoder(enc.oti_common(), enc.oti_scheme_specific())
        out[:] = 0
        t0 = time.time()
        sts = dec.add_symbols(payloads, tags, io)  # whole burst, all blocks
        assert sts[0] == SYM_ADDED
        for sbn in range(blocks):
            assert dec.repair_block(io, sbn)
        best = min(best, time.time() - t0)
        assert np.array_equal(out, data), "decode0 verification FAILED"
        beat()
    return 8 * F / best / 1e9


def bench_decode_e2e(K, T, nblocks, iters, arms=("auto",)):
    """Honest end-to-end fresh-pattern decode through the PRODUCTION path.

    nblocks blocks with DISTINCT ~6% loss patterns + 5% overhead, repaired
    by ONE Decoder.repair_all call — the timed region is exactly repair_all
    (per-pattern prep + solves + recovery + write-through), matching the
    reference's per-run nanorq_repair_block timing (benchmark.c:143-151,
    invert included), with add_symbol ingestion outside the region just as
    the reference keeps it.  All per-pattern decoder caches are cleared
    every iteration so each pattern pays its real work; the adaptive
    runtime picks its arms exactly as production would ("auto": cold
    patterns on the native host arm, warm plans on device).  Returns
    {arm: Gbps}.
    """
    from nanorq_tpu.codec import cache as cc
    from nanorq_tpu.codec.api import Decoder, Encoder
    from nanorq_tpu.codec.oti import make_tag
    from nanorq_tpu.io.ioctx import MemoryIO

    rng = np.random.default_rng(7)
    F = K * T * nblocks
    data = rng.integers(0, 256, F, dtype=np.uint8)
    payloads = data.reshape(nblocks * K, T)
    enc = Encoder(F, T, Al=8, Z=nblocks)
    src = MemoryIO(data)
    per_block = []
    for sbn in range(nblocks):
        gaps = np.nonzero(rng.random(K) < 0.06)[0]
        nrep = gaps.size + max(1, int(0.05 * K))
        rep_esis = np.arange(K, K + nrep)
        keep = np.setdiff1d(np.arange(K), gaps)
        per_block.append((keep, rep_esis, enc.encode_batch(sbn, rep_esis, src)))

    out = np.zeros(F, np.uint8)  # one buffer, like the reference's run loop

    def fresh_decoder():
        dec = Decoder(enc.oti_common(), enc.oti_scheme_specific())
        out[:] = 0
        io = MemoryIO(out)
        for sbn, (keep, rep_esis, rep_pl) in enumerate(per_block):
            dec.add_symbols(payloads[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
            dec.add_symbols(rep_pl, [make_tag(sbn, int(e)) for e in rep_esis], io)
        return dec, io

    res = {}
    # Arms are interleaved ROUND-ROBIN (iteration-major), not measured in
    # per-arm blocks: on a shared/rescaled host, CPU-speed drift between an
    # early arm's block and a later one showed up as a phantom 10-15%
    # auto-vs-host gap at K=50000 (identical code paths).  Interleaving puts
    # every arm in every drift window, so per-arm minima stay comparable.
    best = {arm: float("inf") for arm in arms}
    for _ in range(max(2, iters)):
        for arm in arms:
            dec, io = fresh_decoder()
            cc.clear_decoder_cache()
            t0 = time.time()
            ok = dec.repair_all(io, backend=None if arm == "auto" else arm)
            dt = time.time() - t0
            assert ok, f"decode_e2e repair failed ({arm})"
            assert np.array_equal(out, data), f"decode_e2e verification FAILED ({arm})"
            best[arm] = min(best[arm], dt)
            beat()
    for arm in arms:
        res[arm] = 8 * F / best[arm] / 1e9
    return res


def bench_K(K, T, blocks, iters, rng, dec_blocks=0):
    import jax
    import jax.numpy as jnp

    from nanorq_tpu.codec.cache import decoder_schedule, encoder_schedule
    from nanorq_tpu.ops.lt import lt_combine, lt_plan
    from nanorq_tpu.ops.replay import _replay_jit, device_arrays
    from nanorq_tpu.precode.matrix import binary_rows
    from nanorq_tpu.precode.solver import solve_state
    from nanorq_tpu.rfc.params import params_init

    from nanorq_tpu.precode.device_schedule import compile_device

    P = params_init(K)
    t = blocks * T
    payload = K * T * blocks

    # host fresh-schedule latency: rows + solve + device-schedule compile
    # (the reference's fresh-encode extra cost, benchmark.c:82-116)
    t0 = time.time()
    st = solve_state(P, binary_rows(P))
    solve_ms = 1e3 * (time.time() - t0)
    t0 = time.time()
    compile_device(st)
    fresh_ms = solve_ms + 1e3 * (time.time() - t0)
    ds = encoder_schedule(P.Kp)
    arr = device_arrays(ds)

    D = np.zeros((ds.M_pad, t), np.uint8)
    D[:K] = rng.integers(0, 256, (K, t), dtype=np.uint8)
    Dj = jnp.asarray(D)

    def timed_loop(body, x0, n):
        """Seconds per body step: n steps chained in one jit, best of 3."""

        @jax.jit
        def run(x):
            return jax.lax.fori_loop(0, n, body, x)

        xc = jax.block_until_ready(run(x0))  # compile + warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            xc = jax.block_until_ready(run(xc))
            best = min(best, time.perf_counter() - t0)
            beat()
        return best / n

    # --- encode_replay: intermediate-symbol generation, reference's timed
    # region in nanorq_generate_symbols ---
    enc_per = timed_loop(lambda i, Dc: Dc.at[: P.L].set(_replay_jit(arr, Dc)), Dj, iters)

    # --- encode (headline): replay + LT of all K' systematic symbols ---
    plan_all = lt_plan(np.arange(P.Kp, dtype=np.uint32), P)

    def enc_full(i, Dc):
        C = _replay_jit(arr, Dc)
        s = lt_combine(C, plan_all)
        return Dc.at[:K].set(s[:K])

    encfull_per = timed_loop(enc_full, Dj, iters)

    # --- decode at ~6% loss + 5% overhead: patched solve (host, cached) +
    # the production device path (reference nanorq_repair_block's timed
    # region).  decoder_plan picks the dense combination matmul (WSchedule,
    # ops/wpath.py) at small/mid K' and the structured replay + gap LT
    # above the cutover; the bench measures whichever production uses. ---
    from nanorq_tpu.codec.cache import decoder_plan, WSchedule

    loss = rng.random(K) < 0.06
    gaps = np.nonzero(loss)[0]
    ov = max(1, int(0.05 * K))
    nrep = gaps.size + ov
    isis = np.arange(P.Kp + ov, dtype=np.uint32)
    rep_isis = (np.arange(K, K + nrep) + (P.Kp - K)).astype(np.uint32)
    isis[gaps] = rep_isis[: gaps.size]
    isis[P.Kp :] = rep_isis[gaps.size :]
    # steady-state decode: walk enough distinct patterns first that the
    # per-K' canonical layout freezes (device_schedule._FREEZE_AFTER), so
    # the measured pattern runs the SHARED frozen-layout program a
    # production stream settles into — not a warm-up plan.  The same loop
    # yields the marginal per-pattern host prep (min over fresh patterns,
    # warm per-K' caches).
    from nanorq_tpu.precode.device_schedule import _FREEZE_AFTER

    from nanorq_tpu.utils import stats

    lay0 = stats.snapshot()["counters"]
    dec_solve_ms = float("inf")
    for s in range(_FREEZE_AFTER + 1):
        rng2 = np.random.default_rng(1000 + s)
        g2 = np.nonzero(rng2.random(K) < 0.06)[0]
        i2 = np.arange(P.Kp + ov, dtype=np.uint32)
        r2 = (np.arange(K, K + g2.size + ov) + (P.Kp - K)).astype(np.uint32)
        i2[g2] = r2[: g2.size]
        i2[P.Kp :] = r2[g2.size :]
        t0 = time.time()
        assert decoder_plan(P, i2, ov) is not None
        dec_solve_ms = min(dec_solve_ms, 1e3 * (time.time() - t0))
    t0 = time.time()
    plan_dec = decoder_plan(P, isis, ov)
    dec_solve_ms = min(dec_solve_ms, 1e3 * (time.time() - t0))
    assert plan_dec is not None
    wpath = isinstance(plan_dec, WSchedule)
    # canonical-layout reuse over the pattern walk: hits = patterns served
    # by an already-compiled per-K' frozen program (structured path only)
    lay1 = stats.snapshot()["counters"]
    layout = {
        k.removeprefix("replay_layout_"): lay1.get(k, 0) - lay0.get(k, 0)
        for k in ("replay_layout_hit", "replay_layout_grown", "replay_layout_frozen", "replay_layout_warmup")
        if lay1.get(k, 0) - lay0.get(k, 0)
    }

    # true decode payload: received sources + real repair symbols in the gap
    # and overhead slots (generated from the encoder intermediates).
    # dec_blocks decouples the decode batch from the encode one: the dense-W
    # path has no trisolve chain, so its best B can differ (--dec-blocks)
    dec_blocks = dec_blocks or blocks
    t_dec = dec_blocks * T
    payload_dec = K * T * dec_blocks
    if dec_blocks == blocks:
        Dsrc, Dj_src = D, Dj
    else:
        Dsrc = np.zeros((ds.M_pad, t_dec), np.uint8)
        Dsrc[:K] = rng.integers(0, 256, (K, t_dec), dtype=np.uint8)
        Dj_src = jnp.asarray(Dsrc)
    C_enc = _replay_jit(arr, Dj_src)
    plan_rep = lt_plan(rep_isis, P)
    rep_payloads = np.asarray(lt_combine(C_enc, plan_rep))[: rep_isis.size]
    Dd = np.zeros((plan_dec.M_pad, t_dec), np.uint8)
    Dd[:K] = Dsrc[:K]
    Dd[gaps] = rep_payloads[: gaps.size]
    Dd[P.Kp : P.Kp + ov] = rep_payloads[gaps.size :]
    Dd[K : P.Kp] = 0  # padding symbols
    Ddj = jnp.asarray(Dd)

    if wpath:

        def dec_recover(Dc):
            return plan_dec.apply(Dc)

    else:
        arr_d = device_arrays(plan_dec)
        plan_gaps = lt_plan(gaps.astype(np.uint32), P) if gaps.size else None

        def dec_recover(Dc):
            C = _replay_jit(arr_d, Dc)
            return lt_combine(C, plan_gaps) if plan_gaps is not None else C

    # byte-equality gate (reference benchmark.c:233-235): recovered gap
    # symbols must equal the dropped source symbols
    if gaps.size:
        rec = np.asarray(dec_recover(Ddj))[: gaps.size]
        assert np.array_equal(rec, Dsrc[gaps]), "decode verification FAILED"
        log(f"K={K}: decode byte-equality verified over {gaps.size} recovered symbols"
            + (" (dense-W path)" if wpath else " (structured replay)"))

    def dec_body(i, Dc):
        s = dec_recover(Dc)
        ng = min(int(s.shape[0]), max(gaps.size, 1))
        return Dc.at[:ng].set(s[:ng])

    dec_per = timed_loop(dec_body, Ddj, iters)

    dec0_gbps = bench_decode0(K, T, blocks, iters)

    # fresh encode: a cold encoder pays the schedule solve+compile once,
    # then streams batches; normalize to the reference's 256 MiB object
    # (benchmark.c:11).  The reference's encode column re-solves per block;
    # ours solves per K' by design — this is that design's honest number.
    bytes256 = 256 << 20
    fresh_s = fresh_ms / 1e3 + (bytes256 / payload) * encfull_per

    gbps = lambda per: 8 * payload / per / 1e9
    # per-byte harmonic aggregate (reduces to the old formula at equal batch)
    agg = 8 / (encfull_per / payload + dec_per / payload_dec) / 1e9
    dec_gbps = 8 * payload_dec / dec_per / 1e9
    # publish guard: a rate above the HBM bandwidth means the timed region
    # degenerated — null the cell rather than publish fiction
    dec_suspect = dec_gbps > HBM_GBPS
    if dec_suspect:
        log(f"K={K}: warm decode cell degenerate ({dec_gbps:.0f} Gbps) — dropped")
    return {
        "encode": gbps(encfull_per),
        "encode_fresh": 8 * bytes256 / fresh_s / 1e9,
        "encode_replay": gbps(enc_per),
        "decode0": dec0_gbps,
        "decode": None if dec_suspect else dec_gbps,
        "agg": None if dec_suspect else agg,
        "solve_ms": solve_ms,
        "fresh_ms": fresh_ms,
        "dec_solve_ms": dec_solve_ms,
        "dec_plan": "W" if wpath else "structured",
        **({"dec_layout": layout} if layout else {}),
        "batch_MB": payload / 1e6,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=1280)
    ap.add_argument("--blocks", type=int, default=0, help="0 = per-K tuned default")
    ap.add_argument(
        "--dec-blocks", type=int, default=0,
        help="decode batch override (0 = same as --blocks); the dense-W path "
        "has no trisolve carry so its best B can differ",
    )
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument(
        "--ks", type=int, nargs="*", default=[100, 500, 1000, 5000, 10000, 50000],
        help="default: the reference Makefile's full 6-K grid",
    )
    ap.add_argument("--full", action="store_true", help="(redundant) reference 6-K grid")
    ap.add_argument("--pipe", action="store_true", help="(redundant) decode_e2e runs at every K")
    ap.add_argument(
        "--no-pipe", action="store_true",
        help="skip the fresh-pattern decode_e2e measurement (vs_ref then "
        "falls back to the warm-plan decode column)",
    )
    ap.add_argument(
        "--arms", action="store_true",
        help="also measure decode_e2e per execution arm (host / device) "
        "alongside the production auto policy",
    )
    ap.add_argument("--profile", default=None, help="capture a jax profiler trace to this dir")
    args = ap.parse_args()
    ks = [100, 500, 1000, 5000, 10000, 50000] if args.full else args.ks

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"FATAL: no GPU visible to JAX (platform {dev.platform!r}); nothing measured")
        sys.exit(2)

    state = {"results": {}, "done": False, "error": None}

    def grid():
        try:
            run_grid(args, ks, state["results"])
        except BaseException as e:  # noqa: BLE001 — report, then partial-emit
            import traceback

            traceback.print_exc(file=sys.stderr)
            state["error"] = repr(e)
        state["done"] = True

    # mid-run stall watchdog: a hung device op would block forever; emit
    # whatever completed, flagged partial, and fail the run
    import threading

    beat()
    th = threading.Thread(target=grid, daemon=True)
    th.start()
    stall_s = float(os.environ.get("NANORQ_BENCH_STALL", 2400))
    while th.is_alive():
        th.join(timeout=15)
        if th.is_alive() and time.time() - _BEAT[0] > stall_s:
            log(f"FATAL: no measurement progress for {stall_s:.0f}s — emitting partial capture")
            if state["results"]:
                emit(state["results"], ks, partial=True)
            os._exit(3)
    if state["error"] and not state["results"]:
        log(f"FATAL: grid failed before any K completed: {state['error']}")
        os._exit(3)
    emit(state["results"], ks, partial=bool(state["error"]))
    if state["error"]:
        sys.exit(3)


def run_grid(args, ks, results):
    rng = np.random.default_rng(0)
    prof = None
    if args.profile:
        import jax

        prof = jax.profiler.trace(args.profile)
        prof.__enter__()
    fmt = lambda v: "n/a" if v is None else f"{v:.2f}"
    for K in ks:
        blocks = args.blocks or DEFAULT_B.get(K, 8)
        cap = max(1, (256 << 20) // (K * args.T))
        blocks = min(blocks, cap)
        while blocks & (blocks - 1):  # power-of-two batches measured fastest
            blocks -= 1
        iters = args.iters if K <= 5000 else max(4, args.iters // 4)
        dec_blocks = min(args.dec_blocks, max(1, (256 << 20) // (K * args.T))) if args.dec_blocks else 0
        r = bench_K(K, args.T, blocks, iters, rng, dec_blocks=dec_blocks)
        if not args.no_pipe:
            # decode_e2e: fresh-pattern decode through the production
            # repair_all (adaptive arms), per-pattern work fully inside the
            # timed region, for EVERY K.  Per-arm numbers are captured by
            # default at K in {1000, 50000} so every driver run carries
            # host-vs-device routing evidence (--arms extends to every K).
            nb = E2E_BLOCKS.get(K) or max(4, min(128, (64 << 20) // (K * args.T)))
            if args.arms or K in (1000, 50000):
                # forced-res at huge K' would pay a multi-second GE
                arms = ("auto", "res", "host", "device") if K <= 16384 else ("auto", "host", "device")
            else:
                arms = ("auto",)
            e2e = bench_decode_e2e(K, args.T, nb, 3, arms=arms)
            r["decode_e2e"] = e2e["auto"]
            if len(arms) > 1:
                if "res" in e2e:
                    r["e2e_res"] = e2e["res"]
                r["e2e_host"], r["e2e_device"] = e2e["host"], e2e["device"]
                # routing sanity: the auto policy should be within 10% of the
                # best forced arm (VERDICT r4 #2); a miss is logged evidence
                # that the host-calibrated thresholds are wrong on this chip
                best_arm = max(e2e, key=lambda a: e2e[a])
                r["e2e_auto_ok"] = bool(e2e["auto"] >= 0.9 * e2e[best_arm])
                if not r["e2e_auto_ok"]:
                    log(f"WARN K={K}: auto arm {e2e['auto']:.2f} Gbps < 0.9x best "
                        f"forced arm '{best_arm}' {e2e[best_arm]:.2f} — recalibrate routing")
            r["agg_e2e"] = 1.0 / (1.0 / r["encode"] + 1.0 / r["decode_e2e"])
        base = REF_BASELINE.get(K)
        if base:
            # vs_ref from the HONEST decode number: fresh-pattern e2e when
            # measured (reference decode-oh5 times the per-run invert too)
            dec_ref = r.get("decode_e2e") or r["decode"]
            if dec_ref:
                r["vs_ref"] = round(
                    (8e9 / (8e9 / max(r["encode"], 1e-9) + 8e9 / max(dec_ref, 1e-9)))
                    / (1.0 / (1e3 / base["precalc"] + 1e3 / base["decode_oh5"])),
                    3,
                )
            r["fresh_vs_ref"] = round(r["encode_fresh"] / (base["encode"] / 1e3), 3)
        results[K] = r
        log(
            f"K={K} B={blocks}: encode {r['encode']:.2f} Gbps (ref precalc "
            f"{(base or {}).get('precalc', 0)/1e3:.2f}), fresh {r['encode_fresh']:.2f} "
            f"(ref {(base or {}).get('encode', 0)/1e3:.2f}), replay {r['encode_replay']:.2f}, "
            f"decode0 {r['decode0']:.2f} (ref {(base or {}).get('decode', 0)/1e3:.2f}), "
            f"decode {fmt(r['decode'])}, e2e {r.get('decode_e2e', 0):.2f} "
            f"(ref {(base or {}).get('decode_oh5', 0)/1e3:.2f}), "
            f"agg {fmt(r['agg'])}/e2e {r.get('agg_e2e', 0):.2f} Gbps ({r.get('vs_ref', 0):.2f}x), "
            f"solve {r['solve_ms']:.0f}/{r['fresh_ms']:.0f}/{r['dec_solve_ms']:.0f}ms"
            + (
                f", arms res {fmt(r.get('e2e_res'))} / host {r['e2e_host']:.2f}"
                f" / device {r['e2e_device']:.2f}"
                if "e2e_host" in r
                else ""
            )
        )

    if prof is not None:
        prof.__exit__(None, None, None)
        log(f"profiler trace written to {args.profile}")


def emit(results, ks, partial=False):
    if not results:
        log("FATAL: nothing measured")
        os._exit(3)
    K0 = 1000 if 1000 in results else next(iter(results))
    base = REF_BASELINE.get(K0, {"precalc": 7900, "decode_oh5": 6600})
    ref_agg = 1.0 / (1e3 / base["precalc"] + 1e3 / base["decode_oh5"])
    value = results[K0].get("agg_e2e") or results[K0]["agg"] or results[K0]["encode"]
    vs_all = [r["vs_ref"] for r in results.values() if "vs_ref" in r]
    e2e = "agg_e2e" in results[K0]
    import jax

    devs = jax.devices()
    print(
        json.dumps(
            {
                "metric": f"encode+decode aggregate Gbps, K={K0} T=1280, 1 GPU"
                + (" (fresh-pattern solves included)" if e2e else " (device-side sustained)")
                + (" [PARTIAL]" if partial else ""),
                "value": round(value, 3),
                "unit": "Gbps",
                "vs_baseline": round(value / ref_agg, 3),
                "vs_baseline_min_over_grid": round(min(vs_all), 3) if vs_all else None,
                **({"partial": True} if partial else {}),
                "device": {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)},
                "detail": {
                    str(k): {m: round(v, 3) if isinstance(v, float) else v for m, v in r.items()}
                    for k, r in results.items()
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
