"""Persistent XLA compilation cache location, shared by every entry point.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and the directory is
not changed here.  Otherwise the cache lives at a fixed <checkout>/.jax_cache
(listed in .gitignore), so every entry point of one checkout shares it and
nothing is written outside the checkout.

Either way the checkout's path is stripped from source locations.  The cache
key drops the debug info of the program itself, but not that of the Triton
kernel IR a Pallas call embeds as a string, so without this every fresh
checkout of one commit would miss the cache for every program that holds the
GPU kernel.
"""

import os
import re

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")
SOURCE_PATH_REGEX = "^" + re.escape(REPO_ROOT + os.sep)


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir() and
    make its keys independent of the checkout's path.

    Call before the first compile.  Leaves the directory alone when the
    environment names one, and the source-path rule when one is set."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    if jax.config.jax_hlo_source_file_canonicalization_regex is None:
        jax.config.update("jax_hlo_source_file_canonicalization_regex", SOURCE_PATH_REGEX)
    return path
