"""PyTorch / CUDA port of ``unboundednerfpytorch_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package (``configs``, ``ops``, ``fields``,
``models``, ``optim``, ``train``) so each counterpart is easy to find. The
port imports ``torch`` and numpy only: nothing of JAX and nothing of the JAX
package. Public functions keep the JAX layouts (channel-last grids
``[B, X, Y, Z, C]``, rays ``[N, S]``), so the two packages compare like with
like.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (:func:`resolve_device`).
"""

from unboundednerfpytorch_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
