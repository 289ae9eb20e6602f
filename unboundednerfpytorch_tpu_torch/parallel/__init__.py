"""Multi-device parallelism on ``torch.distributed``: the process group and
the (data, grid) layout of ranks (:mod:`.mesh`), the sharded trilinear
sample with its halo exchange (:mod:`.halo`), the assignment of blocks to
ranks (:mod:`.blocks`) and local process groups for CPU rehearsals
(:mod:`.spawn`)."""
