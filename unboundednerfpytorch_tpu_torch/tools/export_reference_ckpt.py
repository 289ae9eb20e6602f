"""Export a checkpoint directory as a reference-format torch ``.tar``:

    python -m unboundednerfpytorch_tpu_torch.tools.export_reference_ckpt \\
        logs/garden/fine_last --out logs/garden/fine_last.tar

The port's counterpart of the JAX package's ``tools/export_reference_ckpt.py``
and the reverse of ``tools.import_reference_ckpt``: a model trained here (or
by the JAX package: its checkpoint directories load as well) is then loaded
by the reference framework's own tooling (``FourierGrid/utils.py::load_model``,
a strict ``load_state_dict``). Host work only: the tensors are read on the
CPU and written as they are.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Export a checkpoint directory to the reference "
                                             ".tar format")
    ap.add_argument("ckpt", help="checkpoint directory (meta.json and its members)")
    ap.add_argument("--out", required=True, help="output .tar path")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from unboundednerfpytorch_tpu_torch.utils.reference_import import export_checkpoint

    ref = export_checkpoint(args.ckpt, args.out)
    n = sum(int(v.numel()) for v in ref["model_state_dict"].values())
    print(f"exported step {ref['global_step']} ({n:,} tensor elements, "
          f"{len(ref['model_state_dict'])} entries) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
