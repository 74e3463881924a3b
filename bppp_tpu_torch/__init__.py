"""bppp_tpu_torch — the PyTorch/CUDA port of `bppp_tpu`.

Bulletproofs++ over secp256k1, batched over proofs on torch tensors, with
the hot loops as CUDA kernels written for NVIDIA Hopper (`csrc/`, built at
first use by `ops/_build.py`). Same sub-layout and module names as the
JAX package, so the counterpart of a module is found by its path:

  * field / curve / MSM ops and the kernel wrappers   -> bppp_tpu_torch.ops
  * Merlin/STROBE-128 transcript (bit-exact)          -> bppp_tpu_torch.transcript
  * WNLA, circuit, reciprocal, u64 verifiers          -> bppp_tpu_torch.protocol
  * ready-made instances                              -> bppp_tpu_torch.models
  * wire blobs in, the C++ host engine's bindings     -> bppp_tpu_torch.native
  * dp / tp / sp scale-out on torch.distributed         -> bppp_tpu_torch.parallel
  * the entry hook and its multi-rank dry run          -> bppp_tpu_torch.entry
  * pure-Python host oracle (cross-check, fixtures)   -> bppp_tpu_torch.oracle

Everything the JAX package does is ported but its TPU-only `utils/aot.py`
and its own `tools/`: the u64 range proof (prover, both verifiers), the
standalone WNLA and arithmetic circuit, Pippenger, the wire packer, the
entry hook and `dryrun_multichip`, and `parallel/` (one process per rank;
gloo where ranks share a card). Entry points run on the GPU unless the
caller passes `device="cpu"`; on CPU tensors the kernels' plain PyTorch
versions run.
The package imports torch and numpy, never jax, and nothing of `bppp_tpu`.
"""

__version__ = "0.1.0"
