"""The share of a step's sample slots whose k0 the forward looked up and coloured (%): rows over
slots, counted by spies/colour_rows.py at each colouring. The DCVGO group's training cells."""


def read(ctx):
    work = ctx.totals["ops"].get("colour_rows")
    if not work or work[1] <= 0:
        return None
    return work[0] / work[1] * 100.0
