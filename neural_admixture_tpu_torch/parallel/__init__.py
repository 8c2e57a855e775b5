"""Several devices and hosts: the (data, snp) grid of ranks on
torch.distributed (grid.py), the launcher and the host-level helpers
(distributed.py) and the sharded training step and Q pass
(sharded_step.py); the counterparts of the JAX package's parallel/."""
