"""train_tokens_per_s: real tokens (segment id above 0) of the steps that
ended in the window, over its span."""


def read(record):
    window = record['window']
    return window['totals']['tokens'] / window['seconds']
