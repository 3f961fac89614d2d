"""What the per-layer readers share: arithmetic over a run's record.

A record holds the window (``window``: ``steps``, ``seconds``,
``intervals_ms``, ``totals``), with ``--trace 1`` the window's deltas of the
program's stage spans (``spans``: ``loader`` and ``reader``, each ``{stage:
{'sum', 'count'}}``) and loader counters (``stats``), the profiled steps'
summary (``trace``, see :mod:`portbench.devicetrace`; None without device
activity) and each profiled step's facts (``facts``), and the card's name
(``card``). Each reader returns None where it finds nothing to read.
"""

from portbench import bounds, devicetrace


def stage_ms_per_batch(record, side, stages):
    """Milliseconds of the ``stages`` spans of ``side`` in the window, per
    batch the loader delivered."""
    spans, stats = record.get('spans'), record.get('stats')
    if not spans or not stats or stats['batches'] <= 0:
        return None
    found = [spans[side][stage] for stage in stages if stage in spans[side]]
    if not found or not any(span['count'] for span in found):
        return None
    return 1e3 * sum(span['sum'] for span in found) / stats['batches']


def input_wait_share(record):
    """Percent of the training loop's time blocked on the loader's queue."""
    stats = record.get('stats')
    if not stats or stats['total_time_s'] <= 0:
        return None
    return 100.0 * stats['wait_time_s'] / stats['total_time_s']


def model_flops_share(record):
    """Percent of the card's dense bf16 peak: the window's model FLOPs over
    its span."""
    window = record['window']
    return 100.0 * window['totals']['flops'] / window['seconds'] / bounds.peaks(
        record['card'])['bf16_flops']


def device_idle_share(record):
    """Percent of the profiled steps' range in which the card ran nothing."""
    trace = record.get('trace')
    if not trace:
        return None
    return 100.0 * (1.0 - trace['busy_s'] / trace['window_s'])


def stored_copy_roofline(record):
    """K1's least time for the bytes of the batches it inflated, over its
    device time, in percent."""
    trace = record.get('trace')
    if not trace:
        return None
    launches, seconds = devicetrace.kernel_time(trace, 'stored_copy_kernel')
    if not launches or seconds <= 0:
        return None
    per_launch = record['facts'][0]['stored_copy_bytes']
    return 100.0 * launches * bounds.stored_copy_bound_s(per_launch, record['card']) / seconds


FLASH_KERNELS = {'fwd': 'flash_fwd_kernel', 'dq': 'flash_bwd_dq_kernel',
                 'dkv': 'flash_bwd_dkv_kernel'}


def flash_roofline(record):
    """K2, K3 and K4's least times on the profiled batches, summed, over
    their device times summed, in percent. Each kernel runs once a layer a
    step; its bound is the profiled launches times its mean bound a launch,
    so a record the trace lost takes its bound with it."""
    trace = record.get('trace')
    if not trace:
        return None
    facts = record['facts']
    expected = len(facts) * facts[0]['layers']
    bound, seconds = 0.0, 0.0
    for name, fragment in FLASH_KERNELS.items():
        launches, kernel_s = devicetrace.kernel_time(trace, fragment)
        if not launches:
            return None
        seconds += kernel_s
        bound += launches / expected * sum(fact['layers'] * bounds.flash_bounds_s(
            fact['segments'], fact['heads'], fact['head_dim'], fact['elem_bytes'],
            record['card'])[name] for fact in facts)
    return 100.0 * bound / seconds
