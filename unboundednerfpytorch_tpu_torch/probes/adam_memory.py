"""What the masked Adam update adds to the card's memory, at full width.

    python -m unboundednerfpytorch_tpu_torch.probes.adam_memory

For each config (``bicycle_single.py`` and ``Truck.py``, both FourierGrid
with bf16 grids) the density and k0 grids are made at the config's final
world size, with a bf16 gradient and Adam's two f32 moments, and one update
runs three ways: the plain version over each grid whole (before the update
was sliced, the port ran it so), the plain version in slices of ``MaskedAdam.CHUNK`` (as it
runs on the CPU), and ``MaskedAdam.step``, which on the card is one launch
of the fused kernel a grid. For each it prints one JSON line: the GB the
state holds (grids, gradients, moments) and the peak GB during the update,
or ``"out of memory"`` where the card could not hold the temporaries. The
train step's own peak adds the forward's and the backward's memory to this;
``chip_smoke.py`` measures that.
"""

from __future__ import annotations

import json
import pathlib

import torch

from unboundednerfpytorch_tpu_torch.configs import loader
from unboundednerfpytorch_tpu_torch.device import resolve_device
from unboundednerfpytorch_tpu_torch.models import fourier_grid as fg
from unboundednerfpytorch_tpu_torch.ops.cuda import adam
from unboundednerfpytorch_tpu_torch.optim.masked_adam import MaskedAdam, ParamGroup

ROOT = pathlib.Path(__file__).resolve().parents[2]
CONFIGS = ("configs/nerf_unbounded/bicycle_single.py",
           "configs/tankstemple_unbounded/Truck.py")


def grid_shapes(config: str) -> dict:
    """The full-width [banks, X, Y, Z, C] of the config's density and k0."""
    fm = loader.load_config(str(ROOT / config)).fine_model_and_render
    mcfg = fg.config_from(fm, (-1.0,) * 3, (1.0,) * 3, fm.num_voxels_density, fm.num_voxels_rgb)
    banks = 2 * mcfg.fourier_freq_num + 1
    return {"density": (banks, *mcfg.world_size_density, 1),
            "k0": (banks, *mcfg.world_size_rgb, mcfg.k0_dim)}


def measure(shapes: dict, how: str, device) -> dict:
    """One update of both grids: ``how`` is "plain whole", "plain sliced" or
    "kernel"."""
    gen = torch.Generator(device=device).manual_seed(0)
    grids = {}
    for name, shape in shapes.items():
        p = torch.nn.Parameter(torch.zeros(shape, dtype=torch.bfloat16, device=device))
        p.grad = torch.empty(shape, dtype=torch.bfloat16, device=device)
        for b in range(shape[0]):  # a bank at a time: no grid-sized f32 temporary
            p.grad[b] = torch.randn(shape[1:], generator=gen, device=device)
        grids[name] = p
    opt = MaskedAdam([ParamGroup(name, [p], 0.1, True) for name, p in grids.items()])
    torch.cuda.synchronize(device)
    state_gb = torch.cuda.memory_allocated(device) / 1e9
    torch.cuda.reset_peak_memory_stats(device)
    rec = {"update": how, "state_gb": state_gb}
    try:
        with torch.no_grad():
            if how == "kernel":
                opt.step()
            else:
                chunk = MaskedAdam.CHUNK if how == "plain sliced" else None
                for p in grids.values():
                    adam.masked_adam_plain(p, opt.exp_avg[p], opt.exp_avg_sq[p], p.grad, 0.01,
                                           opt.beta1, opt.beta2, opt.eps, True, chunk)
        torch.cuda.synchronize(device)
        rec["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    except torch.cuda.OutOfMemoryError:
        rec["peak_gb"] = "out of memory"
    del opt, grids
    torch.cuda.empty_cache()
    return rec


def main(device=None) -> list:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe measures the card's memory: it needs a CUDA device")
    out = []
    for config in CONFIGS:
        shapes = grid_shapes(config)
        for how in ("plain whole", "plain sliced", "kernel"):
            rec = {"config": config, "shapes": shapes,
                   "card": torch.cuda.get_device_name(dev),
                   "card_gb": torch.cuda.get_device_properties(dev).total_memory / 1e9,
                   **measure(shapes, how, dev)}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


if __name__ == "__main__":
    main()
