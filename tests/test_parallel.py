"""Sharded replay/LT over the 8-device virtual CPU mesh."""

import numpy as np
import pytest


def test_sharded_codec_step_matches_single_device():
    import jax
    import jax.numpy as jnp

    from nanorq_tpu.ops.lt import lt_combine, lt_plan
    from nanorq_tpu.ops.replay import device_arrays, replay_device
    from nanorq_tpu.parallel.mesh import codec_step_sharded, make_mesh, shard_width
    from nanorq_tpu.precode.device_schedule import compile_device
    from nanorq_tpu.precode.matrix import binary_rows
    from nanorq_tpu.precode.solver import _solve_core
    from nanorq_tpu.rfc.params import params_init

    assert len(jax.devices()) == 8, "conftest should provide 8 virtual devices"
    K, T, B = 100, 64, 16  # 16 blocks over 8 devices
    P = params_init(K)
    st = _solve_core(P, binary_rows(P), 0)
    ds = compile_device(st, CB=64)
    arr = device_arrays(ds)
    rng = np.random.default_rng(0)
    D = np.zeros((ds.M_pad, B * T), np.uint8)
    D[:K] = rng.integers(0, 256, (K, B * T), dtype=np.uint8)

    mesh = make_mesh()
    plan = lt_plan(np.arange(P.Kp, dtype=np.uint32), P)
    Dsh = shard_width(D, mesh)
    C_sh, sym_sh = codec_step_sharded(arr, plan, Dsh, mesh)

    C_ref = replay_device(arr, jnp.asarray(D))
    sym_ref = lt_combine(C_ref, plan)
    assert np.array_equal(np.asarray(C_sh), np.asarray(C_ref))
    assert np.array_equal(np.asarray(sym_sh), np.asarray(sym_ref))
    # systematic check through the sharded path
    assert np.array_equal(np.asarray(sym_sh)[:K], D[:K])


def test_sharded_w_step_matches_single_device():
    """Dense-W decode under shard_map == single-device w_matmul_gf2."""
    import jax
    import jax.numpy as jnp

    from nanorq_tpu.codec.cache import WSchedule, decoder_plan
    from nanorq_tpu.ops.wpath import w_matmul_gf2
    from nanorq_tpu.parallel.mesh import make_mesh, shard_width, w_step_sharded
    from nanorq_tpu.rfc.params import params_init

    assert len(jax.devices()) == 8
    K, T, B = 100, 64, 16
    P = params_init(K)
    rng = np.random.default_rng(3)
    gaps = np.sort(rng.choice(K, size=6, replace=False))
    ov = P.H + 4
    isis = np.arange(P.Kp + ov, dtype=np.uint32)
    rep = (P.Kp + np.arange(gaps.size + ov)).astype(np.uint32)
    isis[gaps] = rep[: gaps.size]
    isis[P.Kp :] = rep[gaps.size :]
    plan = decoder_plan(P, isis, ov)
    assert isinstance(plan, WSchedule)
    D = np.zeros((plan.M_pad, B * T), np.uint8)
    D[: P.Kp + ov] = rng.integers(0, 256, (P.Kp + ov, B * T), dtype=np.uint8)

    mesh = make_mesh()
    got = np.asarray(w_step_sharded(plan.staged(), shard_width(D, mesh), mesh))
    want = np.asarray(w_matmul_gf2(plan.staged(), jnp.asarray(D)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n_devices", [2, 4])  # 4: the four-GPU host's mesh
def test_dryrun_multichip_self_provisions(n_devices):
    """The driver gate: dryrun_multichip must provision its own virtual mesh
    (fresh interpreter, forced-CPU env) regardless of this process's backend."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(n_devices)


def _pattern_roundtrip(K, Z, T, mesh, seed=0, backend="device"):
    """Public-API round trip: Z blocks, DISTINCT loss per block, repaired by
    ONE repair_all call (stacked W batches, optionally mesh-sharded).
    backend="device" by default — these tests pin the device dispatch
    paths; the adaptive default would route cold patterns to the host arm."""
    from nanorq_tpu.codec.api import Decoder, Encoder
    from nanorq_tpu.codec.oti import make_tag
    from nanorq_tpu.io.ioctx import MemoryIO

    rng = np.random.default_rng(seed)
    F = K * T * Z
    data = rng.integers(0, 256, F, dtype=np.uint8)
    enc = Encoder(F, T, Al=1, Z=Z)
    src = MemoryIO(data)
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific())
    out = np.zeros(F, np.uint8)
    io = MemoryIO(out)
    payloads = data.reshape(Z * K, T)
    for sbn in range(Z):
        gaps = np.sort(rng.choice(K, size=3 + (sbn % 3), replace=False))
        keep = np.setdiff1d(np.arange(K), gaps)
        rep_esis = np.arange(K, K + gaps.size + 2 + (sbn % 2))
        rep_pl = enc.encode_batch(sbn, rep_esis, src)
        dec.add_symbols(payloads[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
        dec.add_symbols(rep_pl, [make_tag(sbn, int(e)) for e in rep_esis], io)
    assert dec.repair_all(io, mesh=mesh, backend=backend)
    assert np.array_equal(out, data)


def test_repair_all_batched_single_device():
    """Stacked W-batch dispatch (mesh=None) is bit-exact across blocks with
    distinct loss patterns, and actually takes the batch path."""
    from nanorq_tpu.utils import stats

    c0 = stats.snapshot()["counters"].get("repair_batch_blocks", 0)
    _pattern_roundtrip(K=64, Z=6, T=48, mesh=None, seed=1)
    c1 = stats.snapshot()["counters"].get("repair_batch_blocks", 0)
    assert c1 - c0 >= 6


def test_repair_all_mesh_sharded():
    """repair_all(mesh=...) shards the stacked block batches over the
    8-device mesh — the production multi-chip decode path, bit-exact."""
    import jax

    from nanorq_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) == 8
    _pattern_roundtrip(K=64, Z=8, T=48, mesh=make_mesh(), seed=2)


def test_repair_all_mesh_nonpow2_devices():
    """repair_all(mesh=...) on a NON-power-of-two device count (3 of the 8
    virtual devices): the stacked batch pad must round up to a multiple of
    the mesh size or jax.device_put rejects the sharding (advisor r4,
    medium).  4 blocks on 3 devices is exactly the failing shape."""
    import jax

    from nanorq_tpu.parallel.mesh import make_mesh

    mesh3 = make_mesh(jax.devices()[:3])
    _pattern_roundtrip(K=64, Z=4, T=48, mesh=mesh3, seed=3)


def test_encoder_mesh_sharded():
    """Encoder.generate_symbols/encode_batch(mesh=...) shard the payload
    width over the 8-device mesh and stay bit-exact vs the single-device
    path (T=100 is NOT divisible by 8: exercises the zero-pad shard)."""
    import jax

    from nanorq_tpu.codec.api import Encoder
    from nanorq_tpu.io.ioctx import MemoryIO
    from nanorq_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) == 8
    K, T = 40, 100
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, K * T, dtype=np.uint8)
    io = MemoryIO(data)
    esis = np.r_[np.arange(0, K, 3), np.arange(K, K + 9)]
    ref = Encoder(data.size, T, Al=1).encode_batch(0, esis, io)
    got = Encoder(data.size, T, Al=1).encode_batch(0, esis, io, mesh=make_mesh())
    assert np.array_equal(ref, got)
