# Dev workflow targets (analog of the reference's Makefile test/bench/profile)

PY ?= python

.PHONY: test test-gpu smoke bench bench-full build-native clean-native roundtrip soak ubsan-native asan-native sanitize

test:
	$(PY) -m pytest tests/ -q

# on-card kernel + decode tests (needs an NVIDIA GPU; one process, no xdist:
# a second JAX process on the card fails for want of memory)
test-gpu:
	NANORQ_TEST_GPU=1 $(PY) -m pytest tests/test_gpu_kernels.py -m gpu -q

# main path end to end on one GPU (chip_smoke.py --cards 4 for the mesh path)
smoke:
	$(PY) chip_smoke.py

# headline benchmark (one JSON line on stdout; per-K detail on stderr)
bench:
	$(PY) bench.py --ks 1000 --iters 40

bench-full:
	$(PY) bench.py --full --iters 20

build-native:
	$(PY) -c "from nanorq_tpu.native import native_available; assert native_available(), 'native build failed'; print('native solver OK')"

clean-native:
	rm -rf nanorq_tpu/native/_build

# native runtime under sanitizers (reference Makefile:95-99 analog), two
# halves because LD_PRELOADed ASan aborts inside the XLA compiler:
#  - ubsan-native: UBSan linked into the .so, FULL native+residual pytest
#    suites (device paths included)
#  - asan-native: ASan+UBSan preloaded over a jax-free driver covering the
#    raw-pointer write-through paths (_row_ptrs/_out_row_ptrs)
ubsan-native:
	NANORQ_NATIVE_SANITIZE=undefined \
	$(PY) -m pytest tests/test_native.py tests/test_residual.py -q

asan-native:
	NANORQ_NATIVE_SANITIZE=address,undefined \
	LD_PRELOAD=$$(gcc -print-file-name=libasan.so) \
	ASAN_OPTIONS=detect_leaks=0 \
	$(PY) tools/asan_drive.py

sanitize: ubsan-native asan-native

# end-to-end file round trip through the CLIs (reference `make test` analog)
roundtrip:
	$(PY) -m pytest tests/test_cli.py -q

# randomized end-to-end soak beyond the pytest grid (CPU; minutes as arg)
SOAK_MINUTES ?= 30
soak:
	$(PY) -u tools/longfuzz.py $(SOAK_MINUTES)
