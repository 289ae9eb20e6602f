"""At each march of a forward, the samples whose density the recipe needs
(the mask it marches) and those it colours (kept over both thresholds, at
most ``colour_budget`` a ray in a render that has one), for the model
FLOPs."""

import torch

TARGET = ("unboundednerfpytorch_tpu_torch.models.common", "march")


def wrap(orig, spies):
    budget = spies.settings["colour_budget"]

    def march(density, mask, shift, interval, thres):
        out = orig(density, mask, shift, interval, thres)
        rendering = not torch.is_grad_enabled()
        with spies.counting():
            kept = out[3]
            n_colour = kept.sum()
            if budget > 0 and rendering:
                n_colour = kept.sum(-1).clamp(max=budget).sum()
            spies.add_samples(mask.sum(), n_colour)
        return out

    return march
