"""At each colouring of a forward's samples (``models/common.py::colour``), the rows it coloured
and the sample slots it was handed: every slot in the dense forward, the samples over both
``fast_color_thres`` thresholds in the compacted one. Read by the ``colour_share.*`` metrics."""

TARGET = ("unboundednerfpytorch_tpu_torch.models.common", "colour")


def wrap(orig, spies):
    def colour(mask, *args, **kwargs):
        out = orig(mask, *args, **kwargs)
        rows = out[2]
        with spies.counting():
            spies.add("colour_rows", (mask.numel() if rows is None else rows.shape[0],
                                      mask.numel()))
        return out

    return colour
