"""Object-level batched encoding: every source block in one device batch.

RaptorQ blocks of one object share the precode system (params derive from
block 0's K, reference nanorq.c:289, and all blocks pad to the same K'), so
the whole object encodes as ONE structured replay over a payload matrix
[M_pad, Z*T] with blocks laid side by side, followed by grouped LT combines
(long/short blocks differ in the repair ISI shift K'-K, so repair plans are
built per K group).  This is the production streaming path; the per-block
Encoder API remains for incremental use.
"""

from dataclasses import dataclass

import numpy as np

from nanorq_tpu.codec import cache as _cache
from nanorq_tpu.codec.api import Encoder
from nanorq_tpu.io.ioctx import IOContext


@dataclass
class ObjectBatch:
    enc: Encoder
    sbns: list[int]
    Ks: np.ndarray  # per-block source symbol counts
    D: np.ndarray  # [M_pad, Z*T] host payload matrix
    C: object = None  # device intermediates [L, Z*T]


def load_object(enc: Encoder, io: IOContext, sbns=None) -> ObjectBatch:
    """Read all source symbols of the given blocks into one payload matrix."""
    sbns = list(range(enc.num_blocks)) if sbns is None else list(sbns)
    T = enc.symbol_size
    ds = _cache.encoder_schedule(enc.P.Kp)
    D = np.zeros((ds.M_pad, len(sbns) * T), np.uint8)
    Ks = np.zeros(len(sbns), np.int64)
    for b, sbn in enumerate(sbns):
        K = enc.block_symbols(sbn)
        Ks[b] = K
        for esi in range(K):
            D[esi, b * T : (b + 1) * T] = enc._read_symbol(io, sbn, esi, K)
    return ObjectBatch(enc=enc, sbns=sbns, Ks=Ks, D=D)


def generate(batch: ObjectBatch, mesh=None):
    """One structured replay for the whole object (optionally mesh-sharded)."""
    import jax.numpy as jnp

    from nanorq_tpu.ops.replay import device_arrays, replay_device

    ds = _cache.encoder_schedule(batch.enc.P.Kp)
    arr = device_arrays(ds)
    if mesh is not None:
        from nanorq_tpu.parallel.mesh import pad_width, replay_sharded, shard_width

        Dp = pad_width(batch.D, int(np.prod(mesh.devices.shape)))
        batch.C = replay_sharded(arr, shard_width(Dp, mesh), mesh)
    else:
        batch.C = replay_device(arr, jnp.asarray(batch.D))
    return batch.C


def source_symbol(batch: ObjectBatch, b: int, esi: int) -> np.ndarray:
    T = batch.enc.symbol_size
    return batch.D[esi, b * T : (b + 1) * T]


def repair_symbols(batch: ObjectBatch, n_repair: int, mesh=None) -> dict[int, np.ndarray]:
    """Repair payloads for every block: {batch index b: [n_repair, T]}.

    Repair ISIs are K-independent — arange(K, K+n) + (K'-K) == arange(K', K'+n)
    for every block length — so one LT plan and one batched combine cover the
    whole object.  With `mesh`, the combine runs sharded on the block/width
    axis (same layout as generate(mesh=...)).
    """
    from nanorq_tpu.ops.lt import lt_combine, lt_plan

    if batch.C is None:
        generate(batch, mesh=mesh)
    T = batch.enc.symbol_size
    P = batch.enc.P
    isis = np.arange(P.Kp, P.Kp + n_repair, dtype=np.uint32)
    plan = lt_plan(isis, P)
    if mesh is not None and batch.C.shape[1] % int(np.prod(mesh.devices.shape)) == 0:
        from nanorq_tpu.parallel.mesh import lt_sharded

        sym = np.asarray(lt_sharded(batch.C, plan, mesh))[:n_repair]
    else:
        sym = np.asarray(lt_combine(batch.C, plan))[:n_repair]
    return {b: sym[:, b * T : (b + 1) * T] for b in range(len(batch.sbns))}
