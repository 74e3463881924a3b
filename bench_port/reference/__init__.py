"""The benchmark's plain reference: Bulletproofs++ over secp256k1 in pure
Python ints.

A frozen copy of the port's host oracle (field, curve, Keccak / STROBE /
Merlin transcript, WNLA, arithmetic circuit, reciprocal and u64 range
proofs, the seeded draw stream and the JSON serde), kept under the
benchmark so that no later change to the program moves the yardstick.
`wire` reads and writes proofs in the port's wire layout (SEC1 points,
16-bit scalar limbs) and `instances` derives each configuration's
generators from a seed. Nothing here imports torch, the port or JAX.
"""
