"""``python -m unboundednerfpytorch_tpu_torch``: the command line of
``cli/main.py``."""

from unboundednerfpytorch_tpu_torch.cli.main import main

raise SystemExit(main())
