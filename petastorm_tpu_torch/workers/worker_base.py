"""Pool-agnostic worker contract."""


class WorkerBase(object):
    """A worker instance owned by one pool slot. ``publish_func`` delivers a
    result object to the pool's results channel; ``args`` is the
    worker-class-specific setup."""

    def __init__(self, worker_id, publish_func, args):
        self.worker_id = worker_id
        self.publish_func = publish_func
        self.args = args

    def process(self, **kwargs):
        """Process one ventilated work item, publishing zero or more results."""
        raise NotImplementedError()

    def shutdown(self):
        """Called once when the pool stops; release per-worker resources."""
