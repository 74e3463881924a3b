"""Batched Bulletproofs++ protocol layers on PyTorch tensors.

Mirrors the protocol semantics of the host oracle
(`bppp_tpu_torch.oracle`), executed batched over a proof axis: every
scalar is a (16, *batch) int64 limb tensor, every scalar vector a
(16, L, *batch) tensor, every point vector a `PointJ` with coordinates
(16, L, *batch). One call verifies a whole batch of independent proofs.
"""
