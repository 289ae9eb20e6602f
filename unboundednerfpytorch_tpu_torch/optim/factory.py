"""Optimizer factory: parameter groups from the ``lrate_*`` config keys.

Counterpart of ``unboundednerfpytorch_tpu/optim/factory.py``: every
training-config key ``lrate_<name>`` with a value > 0 that names a field of
the model becomes a group with that lr and a ``skip_zero_grad`` flag from
``skip_zero_grad_fields``; lr == 0 freezes the field.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from unboundednerfpytorch_tpu_torch.optim.masked_adam import MaskedAdam, ParamGroup


def split_trainable(params: nn.Module, train_cfg) -> dict[str, nn.Module]:
    """{group name: submodule} for every trainable lrate_* field."""
    out = {}
    for f in dataclasses.fields(train_cfg):
        if not f.name.startswith("lrate_") or f.name == "lrate_decay":
            continue
        name = f.name[len("lrate_"):]
        sub = getattr(params, name, None)
        if sub is None or getattr(train_cfg, f.name) <= 0:
            continue
        out[name] = sub
    return out


def make_optimizer(params: nn.Module, train_cfg) -> MaskedAdam:
    skip = tuple(getattr(train_cfg, "skip_zero_grad_fields", ()) or ())
    groups = []
    for name, sub in split_trainable(params, train_cfg).items():
        groups.append(ParamGroup(name=name, params=list(sub.parameters()),
                                 lr=float(getattr(train_cfg, f"lrate_{name}")),
                                 skip_zero_grad=name in skip))
    trainable = {id(p) for g in groups for p in g.params}
    for p in params.parameters():
        p.requires_grad_(id(p) in trainable)
    return MaskedAdam(groups)


def lr_decay_scale(global_step: float, lrate_decay: int) -> float:
    """0.1^(step / (lrate_decay * 1000))."""
    return 0.1 ** (global_step / (lrate_decay * 1000))
