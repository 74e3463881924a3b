"""Each configuration's public generators, derived from a seed string.

The rule is the port's fixtures' (`models.u64_fixture`,
`models.wnla_fixture`): a `SeededRng(seed)` stream, one scalar per
generator in the order g, then g_vec, then h_vec, each generator the base
point G times its scalar. The reference derives them again from the seed;
it takes no point from the program.
"""

from __future__ import annotations

from .curve import GENERATOR
from .rng import SeededRng
from .u64 import G_VEC_FULL_SZ, H_VEC_FULL_SZ, U64RangeProof


def u64_public(seed: str) -> U64RangeProof:
    """The u64 range proof's public parameters: g, g_vec (16), h_vec (32)."""
    rng = SeededRng(seed)
    g = GENERATOR.mul(rng.scalar())
    g_vec = [GENERATOR.mul(rng.scalar()) for _ in range(G_VEC_FULL_SZ)]
    h_vec = [GENERATOR.mul(rng.scalar()) for _ in range(H_VEC_FULL_SZ)]
    return U64RangeProof(g=g, g_vec=g_vec, h_vec=h_vec)


def wnla_generators(seed: str, sz_l: int, sz_n: int) -> tuple:
    """-> (g, g_vec (sz_n), h_vec (sz_l)) of a standalone WNLA."""
    rng = SeededRng(seed)
    g = GENERATOR.mul(rng.scalar())
    g_vec = [GENERATOR.mul(rng.scalar()) for _ in range(sz_n)]
    h_vec = [GENERATOR.mul(rng.scalar()) for _ in range(sz_l)]
    return g, g_vec, h_vec
