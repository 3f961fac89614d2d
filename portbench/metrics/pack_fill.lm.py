"""pack_fill.lm: real tokens over the token slots (bins x bin length) of the
window's batches, in percent."""


def read(record):
    totals = record['window']['totals']
    return 100.0 * totals['tokens'] / totals['slots']
