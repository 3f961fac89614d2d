"""train_images_per_s: images of the steps that ended in the window, over its span."""


def read(record):
    window = record['window']
    return window['totals']['images'] / window['seconds']
