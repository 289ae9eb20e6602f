"""Convert a reference UnboundedNeRFPytorch checkpoint (a torch ``.tar``)
to one of the port's checkpoint directories:

    python -m unboundednerfpytorch_tpu_torch.tools.import_reference_ckpt \\
        logs/garden/fine_last.tar --out logs/garden/imported \\
        [--family FourierGrid] [--stepsize 0.5] [--t_boundary 2.0]

The port's counterpart of the JAX package's ``tools/import_reference_ckpt.py``.
The output directory then works wherever a native checkpoint does:
``--program render --ft_path <out>``, ``tools.serve --ckpt <out>``,
``--program export_baked``, or as the state a fine-tuning run resumes from.
The conversion runs on the card unless ``main(argv, device="cpu")`` is
called from Python.
"""

from __future__ import annotations

import argparse

FAMILIES = ("dvgo", "dcvgo", "dmpigo", "FourierGrid")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Import a reference .tar checkpoint into the "
                                             "port's checkpoint format")
    ap.add_argument("tar", help="reference checkpoint (e.g. fine_last.tar)")
    ap.add_argument("--out", required=True, help="output checkpoint directory")
    ap.add_argument("--family", choices=FAMILIES, help="override model-family auto-detection")
    ap.add_argument("--stepsize", type=float,
                    help="render stepsize (a config value, not stored in reference ckpts)")
    ap.add_argument("--t_boundary", type=float,
                    help="FourierGrid inner/outer sampling boundary (1.5 waymo, 2.0 else)")
    return ap


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    from unboundednerfpytorch_tpu_torch.utils.reference_import import import_checkpoint

    overrides = {k: getattr(args, k) for k in ("stepsize", "t_boundary")
                 if getattr(args, k) is not None}
    family, _, params, step = import_checkpoint(args.tar, out_dir=args.out, family=args.family,
                                                overrides=overrides, device=device)
    n_params = sum(int(t.numel()) for t in params.state_dict().values())
    print(f"imported {family} checkpoint (step {step}, {n_params:,} param elements) -> "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
