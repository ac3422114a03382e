"""Multi-chip scaling: blocks sharded across a device mesh.

RaptorQ source blocks are fully independent (the reference exposes this as
the per-SBN encoder array, lib/nanorq.c:57, but never exploits it — it is
single threaded).  On the device the batch axis is the payload width
(blocks laid side by side, t = B*T), so multi-device scaling is one
shard_map over a 1-D 'blocks' mesh: every device runs the identical
structured replay / LT program on its own slice of blocks; schedule arrays
are replicated (they are small index/bit tensors shared by all blocks of a
K').  No collectives are needed on the hot path — this is pure SPMD data
parallelism, the optimal layout for this workload.
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def make_mesh(devices=None, axis: str = "blocks") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def auto_mesh() -> Mesh | None:
    """The production default: a 1-D mesh over all local devices, or None
    when only one device is visible (single-chip dispatch needs no
    shard_map).  This is what the CLIs' --mesh auto resolves to."""
    devs = jax.devices()
    return make_mesh(devs) if len(devs) > 1 else None


def pad_width(D: np.ndarray, n_dev: int) -> np.ndarray:
    """Zero-pad the width (payload) axis up to a multiple of n_dev so it can
    shard evenly; zero columns are exact no-ops under every GF kernel."""
    t = D.shape[1]
    tp = -(-t // n_dev) * n_dev
    if tp == t:
        return D
    out = np.zeros((D.shape[0], tp), D.dtype)
    out[:, :t] = D
    return out


def replay_sharded(arr: dict, D: jnp.ndarray, mesh: Mesh):
    """Sharded structured replay: D [M_pad, n_dev*B*T] split on width."""
    from nanorq_tpu.ops.replay import _replay_jit

    f = shard_map(
        _replay_jit,
        mesh=mesh,
        in_specs=(P(), P(None, "blocks")),
        out_specs=P(None, "blocks"),
        check_vma=False,
    )
    return jax.jit(f)(arr, D)


def lt_sharded(C: jnp.ndarray, plan, mesh: Mesh):
    """Sharded LT combine: C [L, n_dev*B*T] split on width."""
    from nanorq_tpu.ops.lt import lt_apply_local, plan_tree

    tree, is_sorted = plan_tree(plan)

    def local(parr, C_local):
        C_ext = jnp.concatenate([C_local, jnp.zeros((1, C_local.shape[1]), jnp.uint8)], axis=0)
        return lt_apply_local(parr, is_sorted, C_ext, plan.n_pad)

    f = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(None, "blocks")),
        out_specs=P(None, "blocks"),
        check_vma=False,
    )
    return jax.jit(f)(tree, C)


def codec_step_sharded(arr: dict, plan, D: jnp.ndarray, mesh: Mesh):
    """Full device step (replay + LT) under one jitted shard_map."""
    from nanorq_tpu.ops.lt import lt_apply_local, plan_tree
    from nanorq_tpu.ops.replay import _replay_jit

    tree, is_sorted = plan_tree(plan)

    def local(a_, parr, D_local):
        C = _replay_jit(a_, D_local)
        C_ext = jnp.concatenate([C, jnp.zeros((1, C.shape[1]), jnp.uint8)], axis=0)
        return C, lt_apply_local(parr, is_sorted, C_ext, plan.n_pad)

    f = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P(None, "blocks")),
        out_specs=(P(None, "blocks"), P(None, "blocks")),
        check_vma=False,
    )
    return jax.jit(f)(arr, tree, D)


def w_step_sharded(staged: dict, D: jnp.ndarray, mesh: Mesh):
    """Sharded dense-W decode (ops/wpath.py): W bits replicated, payload
    width sharded — the matmul is elementwise in the t axis, so this is the
    same zero-collective SPMD layout as the replay path."""
    from nanorq_tpu.ops.wpath import _w_gf2_jit

    f = shard_map(
        _w_gf2_jit,
        mesh=mesh,
        in_specs=(P(), P(), P(None, "blocks")),
        out_specs=P(None, "blocks"),
        check_vma=False,
    )
    return jax.jit(f)(staged["bits"], staged["rows"], D)


def shard_width(D: np.ndarray, mesh: Mesh):
    """Place a host payload matrix with its width axis sharded over the mesh."""
    sh = NamedSharding(mesh, P(None, "blocks"))
    return jax.device_put(D, sh)
