"""Scalar (pure-Python/NumPy) parity models.

Every device kernel in :mod:`fpmash_tpu.ops` is validated against these scalar
models, which in turn are validated bit-for-bit against the reference repo's
golden fixtures (tests/golden). They are also used directly on the host for
tiny inputs where device dispatch isn't worth it.
"""

from fpmash_tpu.scalar.murmur3 import murmur3_x64_128, hash_u64_vector, hash_bytes
from fpmash_tpu.scalar.lyndon import (
    cfl,
    icfl,
    cfl_icfl,
    d_cfl,
    d_icfl,
    d_cfl_icfl,
    reverse_complement,
    FACTORIZATIONS,
)
