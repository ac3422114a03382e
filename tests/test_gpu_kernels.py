"""Fused GF(2) matmul kernel (ops/pallas_kernels.py), its dispatch, the
plain GF(256) product, and the compile-cache helper.

The CPU cases run the Triton kernel in Pallas interpret mode against the
plain XLA path (ops/gfmat.py) and the NumPy oracles.  The `gpu`-marked cases
compile it for the card at real widths; they skip off the card and run with
`make test-gpu` (NANORQ_TEST_GPU=1, one process), as does chip_smoke.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from nanorq_tpu.gf256.bitplane import companion_bits, gf2_matmul_bytes, gf256_matmul_bytes
from nanorq_tpu.gf256.numpy_ops import gf_matmul
from nanorq_tpu.ops import gfmat, pallas_kernels
from nanorq_tpu.utils import jax_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (m, k, t): odd row counts (padded by the wrapper), k and t that are not
# multiples of the default blocks (the wrapper shrinks them), one-row outputs
SHAPES = [(8, 64, 96), (40, 96, 160), (130, 64, 64), (1, 32, 32), (300, 160, 48), (17, 224, 800)]


def _kernel(A, X):
    return np.asarray(pallas_kernels.gf2_matmul_triton(A, X, interpret=True))


@pytest.mark.parametrize("m,k,t", SHAPES)
def test_gf2_kernel_interpret_matches_xla_and_numpy(m, k, t):
    rng = np.random.default_rng(m * 7 + k + t)
    A = rng.integers(0, 2, (m, k), dtype=np.uint8)
    X = rng.integers(0, 256, (k, t), dtype=np.uint8)
    got = _kernel(A, X)
    assert np.array_equal(got, gf2_matmul_bytes(A, X))
    assert np.array_equal(got, np.asarray(gfmat.gf2_matmul_xla(A, X)))


@pytest.mark.parametrize("m,k,t", SHAPES)
def test_gf256_matmul_bits_matches_numpy(m, k, t):
    """GF(256) products are plain XLA on every platform."""
    rng = np.random.default_rng(m * 11 + k + t)
    M = rng.integers(0, 256, (m, k), dtype=np.uint8)
    X = rng.integers(0, 256, (k, t), dtype=np.uint8)
    got = np.asarray(gfmat.gf256_matmul_bits(companion_bits(M), X))
    assert np.array_equal(got, gf_matmul(M, X))
    assert np.array_equal(got, gf256_matmul_bytes(M, X))


@pytest.mark.parametrize("gf256", [False, True])
def test_kernel_under_vmap(gf256):
    """The stacked W / residual batch jits vmap the product over blocks: the
    GF(2) kernel, and the GF(256) product with its device-built operand."""
    import jax

    from nanorq_tpu.ops.wpath import _companion_dev

    rng = np.random.default_rng(5)
    nb, m, k, t = 3, 24, 64, 96
    X = rng.integers(0, 256, (nb, k, t), dtype=np.uint8)
    if gf256:
        A = rng.integers(0, 256, (nb, m, k), dtype=np.uint8)
        want = np.stack([gf_matmul(A[j], X[j]) for j in range(nb)])
        f = jax.vmap(lambda w, x: gfmat.gf256_matmul_bits(_companion_dev(w), x))
    else:
        A = rng.integers(0, 2, (nb, m, k), dtype=np.uint8)
        want = np.stack([gf2_matmul_bytes(A[j], X[j]) for j in range(nb)])
        f = jax.vmap(lambda a, x: pallas_kernels.gf2_matmul_triton(a, x, interpret=True))
    assert np.array_equal(np.asarray(f(A, X)), want)


@pytest.mark.parametrize("cfg", [(64, 32, 64, 4, 2), (16, 16, 32, 4, 2), (256, 64, 128, 8, 2), (32, 128, 16, 4, 3)])
def test_kernel_block_overrides(cfg):
    """Other block sizes (tools/gf_matmul_ab.py --sweep) stay exact."""
    rng = np.random.default_rng(9)
    m, k, t = 36, 128, 128
    X = rng.integers(0, 256, (k, t), dtype=np.uint8)
    A = rng.integers(0, 2, (m, k), dtype=np.uint8)
    got = pallas_kernels._gf2_matmul(A, X, cfg, interpret=True)
    assert np.array_equal(np.asarray(got), gf2_matmul_bytes(A, X))


def test_companion_dev_matches_companion_bits():
    from nanorq_tpu.ops.wpath import _companion_dev

    M = np.random.default_rng(2).integers(0, 256, (5, 7), dtype=np.uint8)
    assert np.array_equal(np.asarray(_companion_dev(M)), companion_bits(M))


@pytest.mark.parametrize("m,k,t,platform,want", [
    (256, 256, 40960, "cpu", False),  # off the card: plain XLA
    (256, 256, 40960, "gpu", True),  # trisolve chunk inverse
    (64, 4096, 1280, "gpu", True),  # stacked GF(2) W batch
    (51456, 512, 5120, "gpu", True),  # Wut at K'~50k
    (1, 32, 32, "gpu", True),  # one output row: padded by the wrapper
    (64, 16, 1280, "gpu", False),  # contraction below the int8 dot floor
    (64, 100, 1280, "gpu", False),  # contraction not a multiple of 32
    (64, 256, 100, "gpu", False),  # payload width not a multiple of 16
    (64, 1024, 1280, "rocm", False),  # any other platform: plain XLA
    (64, 1024, 1288, "gpu", False),  # payload width 8 mod 16
])
def test_kernel_applies(m, k, t, platform, want):
    assert pallas_kernels.kernel_applies(m, k, t, platform=platform) is want


def test_kernel_applies_defaults_to_jax_platform():
    assert pallas_kernels.kernel_applies(256, 256, 40960) is False  # the suite runs on CPU


@pytest.mark.parametrize("gf256", [False, True])
def test_gfmat_dispatch_routes_by_kernel_applies(monkeypatch, gf256):
    """The GF(2) product takes the kernel exactly when kernel_applies says so,
    with the right operands, and otherwise the plain path; the GF(256)
    product never takes it."""
    rng = np.random.default_rng(3)
    m, k, t = 20, 64, 96
    X = rng.integers(0, 256, (k, t), dtype=np.uint8)
    M = rng.integers(0, 256, (m, k), dtype=np.uint8) if gf256 else rng.integers(0, 2, (m, k), dtype=np.uint8)
    A = companion_bits(M) if gf256 else M
    want = gf_matmul(M, X) if gf256 else gf2_matmul_bytes(M, X)
    op = gfmat.gf256_matmul_bits if gf256 else gfmat.gf2_matmul
    seen = []
    real = pallas_kernels.gf2_matmul_triton

    def fake_kernel(A_, X_):
        seen.append((A_.shape, X_.shape))
        return real(A_, X_, interpret=True)

    monkeypatch.setattr(pallas_kernels, "gf2_matmul_triton", fake_kernel)
    assert np.array_equal(np.asarray(op(A, X)), want) and seen == []  # CPU: plain path
    monkeypatch.setattr(pallas_kernels, "kernel_applies", lambda *a, **kw: True)
    assert np.array_equal(np.asarray(op(A, X)), want)
    assert seen == ([] if gf256 else [(A.shape, X.shape)])


@pytest.fixture
def jax_config_restored():
    import jax

    names = ("jax_compilation_cache_dir", "jax_hlo_source_file_canonicalization_regex")
    before = {n: getattr(jax.config, n) for n in names}
    jax.config.update("jax_hlo_source_file_canonicalization_regex", None)
    yield jax.config
    for n, v in before.items():
        jax.config.update(n, v)


def test_compile_cache_dir_from_env(monkeypatch, tmp_path, jax_config_restored):
    config = jax_config_restored
    before = config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax_cache.compile_cache_dir() == str(tmp_path)
    assert jax_cache.enable_compile_cache() == str(tmp_path)
    assert config.jax_compilation_cache_dir == before  # JAX reads the env itself
    assert config.jax_hlo_source_file_canonicalization_regex == jax_cache.SOURCE_PATH_REGEX


def test_compile_cache_dir_default_in_checkout(monkeypatch, jax_config_restored):
    config = jax_config_restored
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert jax_cache.compile_cache_dir() == want
    assert jax_cache.enable_compile_cache() == want
    assert config.jax_compilation_cache_dir == want
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_keeps_a_source_path_rule_already_set(jax_config_restored):
    jax_config_restored.update("jax_hlo_source_file_canonicalization_regex", "^/elsewhere/")
    jax_cache.enable_compile_cache()
    assert jax_config_restored.jax_hlo_source_file_canonicalization_regex == "^/elsewhere/"


def test_kernel_program_ir_holds_no_checkout_path(jax_config_restored):
    """The Triton IR a kernel program embeds (lowered for CUDA, no card
    needed) carries source locations into the compile-cache key: the
    checkout's path is in it unless enable_compile_cache strips it."""
    import io

    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda a, x: pallas_kernels.gf2_matmul_triton(a, x))
    args = (jax.ShapeDtypeStruct((64, 256), jnp.uint8), jax.ShapeDtypeStruct((256, 1280), jnp.uint8))

    def ir_bytes():
        jax.clear_caches()
        buf = io.BytesIO()
        f.trace(*args).lower(lowering_platforms=("cuda",)).compiler_ir("stablehlo").operation.write_bytecode(buf)
        return buf.getvalue()

    assert REPO.encode() in ir_bytes()
    jax_cache.enable_compile_cache()
    assert REPO.encode() not in ir_bytes()


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_outside_checkout(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    r = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


# ------------------------------------------------------------------ on the card

GPU_SHAPES = [
    ("trisolve_chunk", 256, 256, 40960),
    ("wut_K50000", 51456, 512, 5120),
    ("w_gf2_kq4096", 64, 4096, 1280),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,m,k,t", GPU_SHAPES)
def test_kernel_on_card_matches_xla(name, m, k, t):
    import jax.numpy as jnp

    rng = np.random.default_rng(len(name))
    X = jnp.asarray(rng.integers(0, 256, (k, t), dtype=np.uint8))
    A = jnp.asarray(rng.integers(0, 2, (m, k), dtype=np.uint8))
    want = gfmat.gf2_matmul_xla(A, X)
    assert pallas_kernels.kernel_applies(m, k, t)
    got = pallas_kernels.gf2_matmul_triton(A, X)
    assert np.array_equal(np.asarray(got), np.asarray(want)), name


@pytest.mark.gpu
def test_device_arm_decode_on_card():
    """Decoder.repair_all(backend="device") at K=1000: stacked GF(2) W batch
    through the kernel, byte-exact."""
    from nanorq_tpu.codec.api import Decoder, Encoder
    from nanorq_tpu.codec.oti import make_tag
    from nanorq_tpu.io.ioctx import MemoryIO

    K, T, Z = 1000, 1280, 8
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, K * T * Z, dtype=np.uint8)
    enc = Encoder(data.size, T, Al=8, Z=Z)
    src, out = MemoryIO(data), np.zeros_like(data)
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific())
    io = MemoryIO(out)
    for sbn in range(Z):
        gaps = np.nonzero(rng.random(K) < 0.06)[0]
        keep = np.setdiff1d(np.arange(K), gaps)
        rep = np.arange(K, K + gaps.size + 50)
        dec.add_symbols(data.reshape(-1, T)[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
        dec.add_symbols(enc.encode_batch(sbn, rep, src), [make_tag(sbn, int(e)) for e in rep], io)
    assert dec.repair_all(io, backend="device")
    assert np.array_equal(out, data)
    print(json.dumps({"device_arm_decode": "byte-exact"}))
