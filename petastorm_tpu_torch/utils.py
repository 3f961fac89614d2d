"""Running a function in a fresh interpreter: the counterpart of
``petastorm_tpu.utils.run_in_subprocess``.

The function and its arguments travel through ``dill`` where it imports, else
through ``pickle`` (the defined difference: without dill, a module-level
function works and a lambda or closure does not)."""

import pickle


def _serializer():
    try:
        import dill
        return dill
    except ImportError:
        return pickle


def _subprocess_entry(serialized, result_queue):
    try:
        func, args, kwargs = _serializer().loads(serialized)
        result_queue.put(('ok', pickle.dumps(func(*args, **kwargs))))
    except Exception as exc:  # noqa: BLE001 - every failure ships to the parent
        import traceback
        result_queue.put(('error', pickle.dumps((exc, traceback.format_exc()))))


def run_in_subprocess(func, *args, **kwargs):
    """Run ``func(*args, **kwargs)`` in a spawned interpreter and return its
    result. A child's exception is raised here as a ``RuntimeError`` holding
    its traceback (the exception itself is the cause); a child that dies
    without replying is reported at once."""
    import multiprocessing as mp
    import queue as queue_mod
    import time
    ctx = mp.get_context('spawn')
    result_queue = ctx.Queue()
    serialized = _serializer().dumps((func, args, kwargs))
    process = ctx.Process(target=_subprocess_entry, args=(serialized, result_queue))
    process.start()
    try:
        deadline = time.monotonic() + 600
        while True:
            try:
                status, payload = result_queue.get(timeout=1)
                break
            except queue_mod.Empty:
                if not process.is_alive():
                    raise RuntimeError(
                        'Subprocess died with exit code {} before returning a result'
                        .format(process.exitcode)) from None
                if time.monotonic() > deadline:
                    raise TimeoutError('Subprocess produced no result within 600s')
    finally:
        process.join(timeout=30)
        if process.is_alive():
            process.kill()
    if status == 'error':
        exc, tb = pickle.loads(payload)
        raise RuntimeError('Subprocess failed:\n{}'.format(tb)) from exc
    return pickle.loads(payload)
