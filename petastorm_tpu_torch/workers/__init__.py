"""Worker-pool runtime: ventilation, the thread and dummy pools, and the
worker protocol (a trimmed copy of ``petastorm_tpu.workers``; the process
pool and its shared-memory transport come in a later slice)."""


class EmptyResultError(Exception):
    """Raised by a pool's ``get_results`` when all ventilated work completed and
    no more results will arrive."""


class VentilatedItemProcessedMessage(object):
    """Control message a worker publishes after fully processing one ventilated
    item; drives the ventilator's bounded in-flight accounting."""
