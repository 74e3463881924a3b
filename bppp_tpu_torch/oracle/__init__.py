"""Pure-Python host oracle: the bit-exactness reference of this package.

Slow, obviously-correct implementations of the full Bulletproofs++ stack
(field, curve, Keccak/STROBE/Merlin transcript, WNLA, arithmetic circuit,
reciprocal + u64 range proofs). A copy of the JAX package's oracle, kept
here so that this package imports nothing of that one; it makes proofs for
fixtures and is what the tensor code is cross-checked against.
"""

from . import field, curve, keccak, strobe, merlin, vectors, wnla, circuit, reciprocal, u64  # noqa: F401
