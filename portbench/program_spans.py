"""What the readers of the loader's own spans share (``deliver`` on the
host clock; ``h2d_on_device``, ``decode_tail_on_device`` and
``input_stall_on_device`` on the card's clock): each span's mean over its
own count in the window, so a batch whose events were still pending when
the window closed biases nothing. A program without the span gives None."""


def span_ms_per_count(record, stage):
    """Milliseconds of the loader's ``stage`` span per observation in the
    window; None where the window recorded none."""
    spans = record.get('spans')
    if not spans:
        return None
    span = spans['loader'].get(stage)
    if not span or span['count'] <= 0:
        return None
    return 1e3 * span['sum'] / span['count']


def stall_share(record):
    """Percent of the window's mean step interval in which the training
    stream waited on the card for the loader's stream, per batch."""
    stall_ms = span_ms_per_count(record, 'input_stall_on_device')
    window = record.get('window')
    if stall_ms is None or not window or window['steps'] <= 0 or window['seconds'] <= 0:
        return None
    return 100.0 * stall_ms / (1e3 * window['seconds'] / window['steps'])
