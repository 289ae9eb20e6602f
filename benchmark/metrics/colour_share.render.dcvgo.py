"""The share of a view's sample slots whose k0 the cached forward looked up and coloured (%): rows
over slots, counted by spies/colour_rows.py at each colouring of a chunk. DCVGO's render cell."""


def read(ctx):
    work = ctx.totals["ops"].get("colour_rows")
    if not work or work[1] <= 0:
        return None
    return work[0] / work[1] * 100.0
