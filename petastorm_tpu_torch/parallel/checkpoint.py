"""Training checkpoints: the model and optimizer state and the input
pipeline's read position saved as one unit. The counterpart of
``petastorm_tpu.parallel.checkpoint.TrainingCheckpointer``, on
``torch.save``/``torch.load`` instead of orbax.

Usage::

    ckpt = TrainingCheckpointer('/ckpts', max_to_keep=3)
    for step, batch in enumerate(loader, 1):
        train_step(batch)
        ckpt.save(step, {'model': model.state_dict(),
                         'optimizer': optimizer.state_dict()}, loader=loader)

    # on restart
    state, loader_state = ckpt.restore({'model': model.state_dict(),
                                        'optimizer': optimizer.state_dict()})
    model.load_state_dict(state['model'])
    optimizer.load_state_dict(state['optimizer'])
    loader = make_torch_loader(url, ..., resume_state=loader_state['reader'])

Each step is a directory ``<directory>/<step>/`` holding ``train_state.pt``
and, when a read position was saved, ``input_pipeline.json`` (the loader
state as ``{'reader': state}``, the JSON a JAX checkpoint's input-pipeline
item holds, so either package's saved position resumes the other's reader).
A step is written under a temporary name and renamed into place with one
``os.replace``: a save that fails leaves the previous steps whole.

Cross-topology restore (save on 4 hosts, resume on 2): collect every host's
restored ``loader_state['reader']`` and re-deal them with
:func:`restore_across_topology`; each merged state pins the new host's
identity and shard assignment, so the resumed hosts cover exactly the
unconsumed rest whatever their count.
"""

import json
import os
import shutil

import torch

from petastorm_tpu_torch.parallel.loader import resolve_device

_MODEL_KEY = 'train_state'
_LOADER_KEY = 'input_pipeline'
_MODEL_FILE = _MODEL_KEY + '.pt'
_LOADER_FILE = _LOADER_KEY + '.json'
_TMP_PREFIX = '.tmp-'


def restore_across_topology(reader_states, new_count):
    """Re-deal a whole pod's saved reader states onto ``new_count`` hosts.

    ``reader_states`` is every old host's ``loader_state['reader']`` (all of
    them: a partial pod cannot prove coverage). Returns one merged reader
    state per NEW host; feed state ``i`` to new host ``i`` as::

        from petastorm_tpu_torch.parallel.topology import policy_from_state
        state = merged[rank]
        reader = make_reader(url, ...,
                             topology=policy_from_state(state, journal_path),
                             resume_state=state)

    A bridge over
    :func:`petastorm_tpu_torch.parallel.topology.merge_topology_states`,
    which refuses mid-batch cursors, mismatched epochs and states not saved
    by a topology-armed reader."""
    from petastorm_tpu_torch.parallel.topology import merge_topology_states
    return merge_topology_states(reader_states, new_count)


def _check_json_roundtrip(loader_state):
    """Fail a save early, naming the offending key, when the loader state
    would not survive JSON."""
    try:
        json.dumps(loader_state)
        return
    except (TypeError, ValueError):
        pass

    def blame(node, path):
        if isinstance(node, dict):
            for key, value in node.items():
                blame(value, path + (str(key),))
        elif isinstance(node, (list, tuple)):
            for index, value in enumerate(node):
                blame(value, path + (str(index),))
        else:
            try:
                json.dumps(node)
            except (TypeError, ValueError):
                raise TypeError(
                    'loader state is not JSON-serializable at {!r}: {!r} '
                    '({}); convert it before save() or drop it from '
                    'state_dict()'.format('/'.join(path) or '<root>', node,
                                          type(node).__name__)) from None

    blame(loader_state, ())
    # a structure-level failure (a circular reference) has no leaf to blame
    raise TypeError('loader state is not JSON-serializable (circular reference?)')


def _place_like(restored, template, device):
    """``restored`` with every tensor on the device of the template's tensor at
    the same place, or where the template has none, saved CUDA tensors on
    ``device`` and saved CPU tensors on the CPU (an optimizer's step counts
    stay on the CPU, as a fresh one keeps them)."""
    if isinstance(restored, torch.Tensor):
        if isinstance(template, torch.Tensor):
            return restored.to(template.device)
        return restored
    if isinstance(restored, dict):
        template = template if isinstance(template, dict) else {}
        return {key: _place_like(value, template.get(key), device)
                for key, value in restored.items()}
    if isinstance(restored, (list, tuple)):
        template = (template if isinstance(template, (list, tuple))
                    and len(template) == len(restored) else [None] * len(restored))
        return type(restored)(_place_like(value, twin, device)
                              for value, twin in zip(restored, template))
    return restored


class TrainingCheckpointer(object):
    """Atomic (training state, input position) checkpoints in a directory.

    :param directory: the checkpoint root (a local path; created if missing).
    :param max_to_keep: how many of the newest steps are kept; older ones are
        deleted after each save.
    :param save_interval_steps: if set, :meth:`save` is a no-op except every
        N-th step, so a training loop can call it unconditionally.
    """

    def __init__(self, directory, max_to_keep=3, save_interval_steps=None):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError('max_to_keep must be >= 1 or None, got {!r}'.format(max_to_keep))
        self.directory = os.path.abspath(os.fspath(directory))
        os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._save_interval_steps = save_interval_steps or 1

    def should_save(self, step):
        """True when :meth:`save` of ``step`` would write (newer than the
        latest step, and on the interval)."""
        latest = self.latest_step
        if latest is not None and latest >= step:
            return False
        return step % self._save_interval_steps == 0

    def save(self, step, train_state, loader=None, loader_state=None, force=False):
        """Save ``train_state`` (a dict of ``state_dict()``s: model, optimizer,
        anything else ``torch.save`` takes) with the input position.

        Pass either ``loader`` (its ``state_dict()`` is taken, raising where the
        loader cannot attribute in-flight rows, exactly like a direct call) or
        an explicit ``loader_state`` dict; with neither only ``train_state`` is
        saved. The interval gate is checked first, so a step that is not saved
        never asks the loader. Returns True when the step was written."""
        if loader is not None and loader_state is not None:
            raise ValueError('Pass loader or loader_state, not both')
        if not force and not self.should_save(step):
            return False
        if loader is not None:
            loader_state = {'reader': loader.state_dict()}
        elif loader_state is not None and 'reader' not in loader_state:
            loader_state = {'reader': loader_state}
        if loader_state is not None:
            _check_json_roundtrip(loader_state)
        final = self._step_dir(step)
        if os.path.exists(final):
            raise ValueError('checkpoint step {} already exists under {!r}'
                             .format(step, self.directory))
        tmp = os.path.join(self.directory, '{}{}-{}'.format(_TMP_PREFIX, step, os.getpid()))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            torch.save(train_state, os.path.join(tmp, _MODEL_FILE))
            if loader_state is not None:
                with open(os.path.join(tmp, _LOADER_FILE), 'w') as f:
                    json.dump(loader_state, f)
            for name in os.listdir(tmp):
                with open(os.path.join(tmp, name), 'rb') as f:
                    os.fsync(f.fileno())
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        return True

    def restore(self, train_state_template, step=None, device=None):
        """``(train_state, loader_state)`` of ``step`` (default: the latest).

        ``train_state_template`` is the state the caller would save now (a
        fresh model's and optimizer's ``state_dict()``s): every restored tensor
        goes to the device of the template's tensor at the same place. Tensors
        the template lacks (an optimizer's moments before its first step) go
        to ``device`` if they were saved from a card: CUDA unless ``'cpu'`` is
        given, and a CUDA request without a card raises. ``loader_state`` is
        the dict whose ``['reader']`` feeds ``resume_state=``; None when the
        step saved no input position."""
        device = resolve_device(device)
        if step is None:
            step = self.latest_step
        if step is None:
            raise ValueError('No checkpoint found under {!r}'.format(self.directory))
        step_dir = self._step_dir(step)
        if not os.path.isdir(step_dir):
            raise ValueError('No checkpoint of step {} under {!r}'.format(step, self.directory))

        def locate(storage, location):
            if location.startswith('cpu') or device.type == 'cpu':
                return storage
            return storage.cuda(device.index if device.index is not None
                                else torch.cuda.current_device())

        restored = torch.load(os.path.join(step_dir, _MODEL_FILE), map_location=locate,
                              weights_only=True)
        loader_path = os.path.join(step_dir, _LOADER_FILE)
        loader_state = None
        if os.path.exists(loader_path):
            with open(loader_path) as f:
                loader_state = json.load(f)
        return _place_like(restored, train_state_template, device), loader_state

    @property
    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        """The saved steps, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isdir(os.path.join(self.directory, name)))

    def wait_until_finished(self):
        """Saves are synchronous: nothing to wait for."""

    def close(self):
        """Nothing is held open between calls."""

    def _step_dir(self, step):
        return os.path.join(self.directory, str(int(step)))

    def _prune(self):
        if self._max_to_keep is None:
            return
        for step in self.all_steps()[:-self._max_to_keep]:
            shutil.rmtree(self._step_dir(step))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
