"""Device kernels: branch-free page decode, filtering, hashing.

Design (SURVEY §7): pages live in device memory as dense, padded tensors
with a host-built page directory; per-page variable-length byte parsing
happens on the host during planning, and the value-decode compute runs as
vectorized XLA kernels over whole page batches — one launch per codec,
static shapes, no data-dependent control flow.
"""

import os

import jax

# Column data is 64-bit-typed (i64/u64/f64 are first-class in the format);
# without x64 JAX silently truncates to 32-bit on device.
jax.config.update("jax_enable_x64", True)

# Decode kernels come in (codec × width × shape-bucket) variants; persist
# compilations across processes.  JAX reads JAX_COMPILATION_CACHE_DIR itself
# when it is set; otherwise the cache lives at one fixed path inside the
# checkout (a moving path never hits).
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

from .decode import (  # noqa: F401,E402
    bitunpack_device,
    delta_bitunpack_device,
    dict_gather_device,
    one_value_device,
    rle_expand_device,
    freq_scatter_device,
    unpack_validity_device,
)
