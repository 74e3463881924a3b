"""Scale-out over `torch.distributed`: dp batch sharding and tp sharded MSMs
(`mesh.py`), the process bootstrap (`multihost.py`) and the sequence-parallel
WNLA prover (`wnla_shard.py`). Counterpart of `bppp_tpu/parallel/`."""
