"""nanorq_tpu: a JAX RaptorQ (RFC 6330) fountain-code framework for NVIDIA GPUs.

Built from scratch in JAX/XLA/Pallas with the capabilities of the C
reference implementation sleepybishop/nanorq (see SURVEY.md): systematic
encode/decode of objects partitioned into source blocks, streaming repair
generation, loss recovery, OTI wire format, pluggable I/O, CLI tooling.
"""

__version__ = "0.1.0"
