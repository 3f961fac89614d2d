"""Worker-pool runtime: ventilation, the thread, dummy and process pools, the
process pool's shared-memory transport, and the worker protocol (a trimmed
copy of ``petastorm_tpu.workers``)."""


class EmptyResultError(Exception):
    """Raised by a pool's ``get_results`` when all ventilated work completed and
    no more results will arrive."""


class TimeoutWaitingForResultError(Exception):
    """Raised when waiting on results times out."""


class WorkerTerminationError(Exception):
    """A process-pool worker could not start, or died with its respawn budget
    spent."""


class VentilatedItemProcessedMessage(object):
    """Control message a worker publishes after fully processing one ventilated
    item; drives the ventilator's bounded in-flight accounting."""
