"""Where the seconds of a full-width checkpoint go, on the GPU's host.

    python -m unboundednerfpytorch_tpu_torch.probes.checkpoint_io

The arrays of a bicycle_single checkpoint at full width (two f32 Adam
moments and a bf16 grid of [7, 199, 199, 199, 12]) are copied from the
device, written and read back by ``numpy``'s own archive functions and by the
port's (``utils/checkpoint.py::_write_npz`` / ``_read_npz``: one write a
member, a read from each member's offset), and copied to the device again.
Prints one JSON line of seconds, in a temporary directory that it removes.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

from unboundednerfpytorch_tpu_torch.device import resolve_device
from unboundednerfpytorch_tpu_torch.utils import checkpoint as ckpt

SHAPE = (7, 199, 199, 199, 12)


def main(device=None, shape=SHAPE) -> dict:
    """``device``: None -> ``cuda``; ``shape`` of each array (the tests run
    a small one on the CPU)."""
    dev = resolve_device(device)

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    gen = torch.Generator(device=dev).manual_seed(0)
    tensors = [torch.randn(shape, generator=gen, device=dev),
               torch.rand(shape, generator=gen, device=dev),
               torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)]
    rec = {"shape": shape, "gb": sum(t.numel() * t.element_size() for t in tensors) / 1e9}
    host, rec["to_host_s"] = timed(lambda: [t.cpu() for t in tensors])
    arrays = {"exp_avg": host[0].numpy(), "exp_avg_sq": host[1].numpy(),
              "grid": host[2].view(torch.int16).numpy().view(np.uint16)}
    with tempfile.TemporaryDirectory() as d:
        theirs, ours = os.path.join(d, "savez.npz"), os.path.join(d, "port.npz")

        def savez():
            with open(theirs, "wb") as f:
                np.savez(f, **arrays)

        _, rec["np_savez_s"] = timed(savez)
        _, rec["port_write_s"] = timed(lambda: ckpt._write_npz(ours, arrays))

        def np_load():
            with np.load(ours) as npz:
                return {k: npz[k] for k in npz.files}

        _, rec["np_load_s"] = timed(np_load)
        back, rec["port_read_s"] = timed(lambda: ckpt._read_npz(ours))
        if not all(np.array_equal(back[k], v) for k, v in arrays.items()):
            raise AssertionError("the archive read back differs from what was written")
    _, rec["to_device_s"] = timed(lambda: [torch.from_numpy(a).to(dev) for a in back.values()])
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
