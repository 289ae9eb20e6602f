"""``cumdist_thres``'s bytes and flops by its definition, at each call (where
DCVGO's forward calls it)."""

from benchmark.counts import ops

TARGET = ("unboundednerfpytorch_tpu_torch.models.dcvgo", "cumdist_thres")


def wrap(orig, spies):
    def cumdist_thres(dist, thres):
        with spies.counting():
            spies.add("cumdist_thres", ops.cumdist_thres(dist))
        return orig(dist, thres)

    return cumdist_thres
