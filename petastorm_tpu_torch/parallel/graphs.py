"""Whole programs of training steps: the port's counterpart of a ``lax.scan``
of train steps under ``jit``, which the JAX package's
``InMemJaxLoader.scan_epochs`` and ``JaxDataLoader.scan_stream`` dispatch
once per epoch or per chunk of batches.

:class:`StepProgram` runs ``steps`` calls of ``step_fn(batch) -> aux`` over
static input tensors that the caller refills before each run. On the card
the calls are one CUDA graph, captured at the first run and replayed by every
run after it: one host dispatch for all the steps. On the CPU (the caller's
explicit ``device='cpu'``) the same calls run eagerly. There is no eager
fallback on the card: a step that cannot be captured raises.

Capture, as PyTorch's whole-network recipe does it:

- A few eager warm-up calls on a side stream first initialise cuBLAS/cuDNN,
  autograd's accumulators and the optimizer's state. They would also train,
  which the JAX program never does, so the tensors of ``state`` (modules'
  parameters and buffers, optimizers' state, plain tensors) are copied before
  the warm-up and copied back in place after it (their addresses stay, which
  the graph needs), optimizer state the warm-up created is set to zero
  (where torch's optimizers start from; SGD's momentum buffer starts as the
  first gradient instead, which gives the same first step for the default
  ``dampening=0``), gradients are set to None and the card's random state is
  restored. The graph's first replay computes the first step an eager run
  from the same weights would.
- ``step_fn`` calls ``optimizer.zero_grad(set_to_none=True)`` as in eager
  code; inside the capture the gradients then come from the graph's own
  memory pool. Adam needs ``capturable=True`` (torch refuses to capture it
  otherwise); SGD needs nothing.
- Each step's ``aux`` (a tensor, a tuple/list or dict of tensors, or None)
  is stacked over the steps into static outputs inside the graph, which each
  run clones before the next replay overwrites them.
- A step that syncs the host (``.item()``, printing a tensor, a
  data-dependent shape, boolean indexing, a tensor made from host data)
  makes the capture fail; :class:`StepProgram` raises ``ValueError`` naming
  the cause.

The port's kernel wrappers count only the launches they make outside a
capture: a captured call records its launch, and a replay runs the graph's
kernels without calling any wrapper. What a replay runs is the graph's
kernel nodes, all of them every replay: :meth:`StepProgram.kernel_nodes`
reads them off the captured graph through the CUDA driver
(``cuGraphGetNodes``), by kernel function name, where this torch keeps the
graph after capture (``CUDAGraph(keep_graph=True)``).

:class:`ModuleGraphs` graphs one module instead of a whole step:
``torch.cuda.make_graphed_callables``' design applied inside the module.
The module's ``forward`` hands every call to it with its eager forward; on
the card, in training, with gradients on and outside any capture
(:func:`route`), the forward runs as one captured CUDA graph and the
backward as another, behind an autograd function. The caller's step
(``model(x)``, ``loss.backward()``, ``optimizer.step()``) is unchanged;
every other call (the CPU, evaluation, ``no_grad``, a call inside a
:class:`StepProgram`'s warm-up or capture) runs the eager forward.

- The first qualifying call for a key (the input's shape, dtype, device
  and ``requires_grad``; the addresses of the module's parameters and
  buffers; which parameters require gradients and which submodules are in
  training, all as the first call found them) warms the forward and its
  gradient up on a side stream, puts the parameters, buffers and random
  state back as :class:`StepProgram` does (:func:`warm_up_undone`),
  captures the forward and the backward into one memory pool, and replays.
  A model that is moved or reloaded to new memory therefore captures
  again; a parameter replaced by a new tensor object after the first call
  is not seen. At most :data:`MODULE_PROGRAMS` keys are kept.
- A replay copies the input into the graph's static input, replays the
  forward and returns a copy of its output that the caller may keep. The
  backward copies the output's gradient in, replays, and hands the static
  gradients to autograd, which copies them into ``.grad`` (or adds them to
  a gradient already there): a later replay never writes into a ``.grad``.
- The saved activations live in the pool, so one replay's backward must
  run before the next replay: a call made while the last replay's output
  still awaits its backward (two forwards, one loss) runs eagerly, and the
  backward of a replay that a later one overwrote raises.
- Telemetry (``ModuleGraphs.telemetry``): the counters
  ``model_graph_capture``, ``model_graph_replay`` and
  ``model_graph_eager_on_card`` (a training call on the card that ran
  eagerly), and the host span ``graph_capture`` (warm-up and capture, in
  the profiler range ``petastorm_tpu_torch.model.graph_capture``).
"""

import contextlib
import operator
import threading
import time
import warnings
import weakref

import torch

from petastorm_tpu_torch.telemetry import spans as _spans
from petastorm_tpu_torch.telemetry.registry import MetricsRegistry

#: eager calls of the first step before a capture
WARMUP_STEPS = 3
#: captured (forward, backward) pairs a :class:`ModuleGraphs` keeps
MODULE_PROGRAMS = 4


def _flatten(aux):
    """(tensor leaves, a function rebuilding ``aux``'s structure from new leaves)."""
    if aux is None:
        return [], lambda leaves: None
    if isinstance(aux, torch.Tensor):
        return [aux], lambda leaves: leaves[0]
    if isinstance(aux, (tuple, list)):
        kind = type(aux)
        return list(aux), lambda leaves: kind(leaves)
    if isinstance(aux, dict):
        names = list(aux)
        return [aux[name] for name in names], lambda leaves: dict(zip(names, leaves))
    raise TypeError('step_fn must return a tensor, a tuple/list or dict of tensors, or '
                    'None; got {}'.format(type(aux).__name__))


def _stack_steps(auxes):
    """Per-step aux -> ``aux`` with every leaf stacked over the steps."""
    flat = [_flatten(aux) for aux in auxes]
    rebuild = flat[0][1]
    columns = zip(*(leaves for leaves, _ in flat))
    return rebuild([torch.stack([leaf.detach() for leaf in column]) for column in columns])


def _state_tensors(state):
    seen = {}
    for item in state:
        if isinstance(item, torch.nn.Module):
            tensors = list(item.parameters()) + list(item.buffers())
        elif isinstance(item, torch.optim.Optimizer):
            tensors = [value for entry in item.state.values() for value in entry.values()
                       if isinstance(value, torch.Tensor)]
        elif isinstance(item, torch.Tensor):
            tensors = [item]
        else:
            raise TypeError('state holds modules, optimizers and tensors; got {}'
                            .format(type(item).__name__))
        for tensor in tensors:
            seen.setdefault(id(tensor), tensor)
    return list(seen.values())


def program_state(state, device):
    """``state`` as a tuple for :class:`StepProgram`. On the card it must be
    given: the capture's warm-up has to be undone, and the program cannot
    find what ``step_fn`` mutates by itself. On the CPU nothing is captured
    and None means ``()``."""
    if state is None:
        if torch.device(device).type == 'cuda':
            raise ValueError('on the card pass state=(model, optimizer, ...): the tensors '
                             'step_fn mutates, which the CUDA graph capture restores after '
                             'its warm-up; pass state=() for a step that mutates nothing')
        return ()
    if isinstance(state, (torch.nn.Module, torch.optim.Optimizer, torch.Tensor)):
        return (state,)
    return tuple(state)


def _drop_grads(state):
    for item in state:
        if isinstance(item, (torch.nn.Module, torch.optim.Optimizer)):
            item.zero_grad(set_to_none=True)


def warm_up_undone(state, device, warm_up):
    """Call ``warm_up()`` eagerly (on the card, on a side stream, then
    synchronised), then undo what it did to ``state`` (modules, optimizers
    and tensors, as :class:`StepProgram` takes them): every tensor of it
    gets its value back in place, so its address stays (a graph reads it
    there), optimizer state the warm-up created is set to zero, and the
    device's random state is restored. Gradients are left as they are."""
    device = torch.device(device)
    cuda = device.type == 'cuda'
    tensors = _state_tensors(state)
    saved = [tensor.detach().clone() for tensor in tensors]
    known = {id(tensor) for tensor in tensors}
    rng = torch.cuda.get_rng_state(device) if cuda else torch.get_rng_state()
    if cuda:
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm_up()
        current.wait_stream(side)
        torch.cuda.synchronize(device)
    else:
        warm_up()
    with torch.no_grad():
        for tensor, value in zip(tensors, saved):
            tensor.copy_(value)
        for tensor in _state_tensors(state):
            if id(tensor) not in known:
                tensor.zero_()
    if cuda:
        torch.cuda.set_rng_state(rng, device)
        torch.cuda.synchronize(device)
    else:
        torch.set_rng_state(rng)


def _capture(graph, record, stream, **options):
    """``record()``'s work captured into ``graph`` (``torch.cuda.graph``
    with ``options``); returns what it returned. On failure ``stream`` is
    made current again (a failed capture leaves torch's capture stream
    current) and the first error is raised: the capture's own error on
    leaving would otherwise hide it."""
    first_error = []
    try:
        with torch.cuda.graph(graph, **options):
            try:
                return record()
            except Exception as exc:
                first_error.append(exc)
                raise
    except Exception as exc:
        torch.cuda.set_stream(stream)
        if first_error and first_error[0] is not exc:
            raise first_error[0] from exc
        raise


#: per thread: how many whole-step programs are warming up or capturing
_step_captures = threading.local()


@contextlib.contextmanager
def _whole_step_capture():
    _step_captures.depth = getattr(_step_captures, 'depth', 0) + 1
    try:
        yield
    finally:
        _step_captures.depth -= 1


def capture_under_way():
    """True inside a CUDA graph capture on this thread's current stream, or
    while a :class:`StepProgram` warms up or captures on this thread (its
    warm-up's calls are eager steps, not the module's own)."""
    return bool(getattr(_step_captures, 'depth', 0)) or torch.cuda.is_current_stream_capturing()


class StepProgram(object):
    """``steps`` calls of ``step_fn(batch_of(i))`` for ``i`` in ``range(steps)``,
    as one CUDA graph on the card or eager calls on the CPU.

    :param step_fn: ``step_fn(batch) -> aux``; mutates the model and optimizer
        in place.
    :param batch_of: ``batch_of(i) -> batch``: step ``i``'s batch, built from
        static tensors that the caller refills before each :meth:`run`
        (inside the graph this is part of the captured work).
    :param steps: calls per run.
    :param state: the modules, optimizers and tensors ``step_fn`` mutates,
        restored after the capture's warm-up; ``()`` for a step that mutates
        nothing.
    :param device: the device of the static tensors.
    """

    def __init__(self, step_fn, batch_of, steps, state, device):
        if steps < 1:
            raise ValueError('a program needs at least one step')
        self.step_fn = step_fn
        self.steps = steps
        self.device = torch.device(device)
        self._batch_of = batch_of
        self._state = tuple(state)
        _state_tensors(self._state)  # type check before anything runs
        self._graph = None
        self._outputs = None
        self._rebuild = None
        #: graph replays so far
        self.replays = 0
        #: seconds of the warm-up and capture (host clock, synchronised)
        self.capture_s = None

    def run(self):
        """Run every step once; returns the steps' ``aux`` stacked over the
        steps (tensors of their own, not overwritten by later runs)."""
        if self.device.type != 'cuda':
            return _stack_steps([self.step_fn(self._batch_of(i)) for i in range(self.steps)])
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self.replays += 1
        return self._rebuild([output.clone() for output in self._outputs])

    def _warm_up(self):
        for _ in range(WARMUP_STEPS):
            self.step_fn(self._batch_of(0))

    def _capture(self):
        start = time.perf_counter()
        with _whole_step_capture():
            warm_up_undone(self._state, self.device, self._warm_up)
            _drop_grads(self._state)
            try:
                # kept after instantiation, so kernel_nodes() can read it
                graph = torch.cuda.CUDAGraph(keep_graph=True)
            except TypeError:   # a torch without keep_graph
                graph = torch.cuda.CUDAGraph()
            try:
                leaves = _capture(graph, lambda: _flatten(_stack_steps(
                    [self.step_fn(self._batch_of(i)) for i in range(self.steps)])),
                    torch.cuda.current_stream(self.device))
            except Exception as cause:
                # drop gradients that point into the graph's pool
                _drop_grads(self._state)
                raise ValueError(
                    'step_fn could not be captured into a CUDA graph ({}: {}). A step that '
                    'reads a value back to the host (.item(), float(tensor), printing a '
                    'tensor), has data-dependent shapes (boolean indexing, nonzero) or makes '
                    'tensors from host data cannot run inside one; Adam needs '
                    'capturable=True.'.format(type(cause).__name__, cause)) from cause
        self._outputs, self._rebuild = leaves
        self._graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - start

    def kernel_nodes(self):
        """``{kernel function name: kernel nodes}`` of the captured graph, read
        off the graph through the CUDA driver: what every replay launches.
        None before the capture, or when this torch or driver cannot hand
        out the graph or name its kernels."""
        if self._graph is None:
            return None
        try:
            raw_graph = self._graph.raw_cuda_graph()
        except (AttributeError, RuntimeError):
            return None
        return graph_kernel_nodes(raw_graph)


#: ``CU_GRAPH_NODE_TYPE_KERNEL`` of the driver API
_KERNEL_NODE = 0
#: byte offset of ``kern`` in ``CUDA_KERNEL_NODE_PARAMS_v2`` (func, 6 dims,
#: shared memory bytes, padding, kernelParams, extra)
_KERN_OFFSET = 56


def graph_kernel_nodes(raw_graph):
    """``{kernel function name: count}`` of the kernel nodes of the
    ``cudaGraph_t`` at ``raw_graph`` (an int), through ``libcuda``'s
    ``cuGraphGetNodes``, ``cuGraphKernelNodeGetParams`` and
    ``cuFuncGetName``/``cuKernelGetName``; None when the driver lacks them."""
    import ctypes
    try:
        libcuda = ctypes.CDLL('libcuda.so.1')
        func_name, kernel_name = libcuda.cuFuncGetName, libcuda.cuKernelGetName
    except (OSError, AttributeError):
        return None
    # the v2 layout carries ``kern`` (a library kernel's node has no func)
    node_params = (getattr(libcuda, 'cuGraphKernelNodeGetParams_v2', None)
                   or libcuda.cuGraphKernelNodeGetParams)

    def call(fn, *args):
        status = fn(*args)
        if status != 0:
            raise RuntimeError('{} failed: CUresult {}'.format(fn.__name__, status))

    graph = ctypes.c_void_p(raw_graph)
    count = ctypes.c_size_t(0)
    call(libcuda.cuGraphGetNodes, graph, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * max(count.value, 1))()
    call(libcuda.cuGraphGetNodes, graph, nodes, ctypes.byref(count))
    params = ctypes.create_string_buffer(128)
    names = {}
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        call(libcuda.cuGraphNodeGetType, ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != _KERNEL_NODE:
            continue
        call(node_params, ctypes.c_void_p(node), params)
        func = ctypes.c_void_p.from_buffer(params, 0).value
        name = ctypes.c_char_p()
        if func:
            call(func_name, ctypes.byref(name), ctypes.c_void_p(func))
        elif ctypes.c_void_p.from_buffer(params, _KERN_OFFSET).value:
            kern = ctypes.c_void_p.from_buffer(params, _KERN_OFFSET).value
            call(kernel_name, ctypes.byref(name), ctypes.c_void_p(kern))
        key = (name.value or b'').decode('utf-8', 'replace')
        names[key] = names.get(key, 0) + 1
    return names


class ProgramCache(object):
    """Programs by key, at most ``limit`` of them: past it the oldest is
    evicted (a fresh ``step_fn`` closure per call would otherwise pin every
    graph and its memory pool) and ``warning`` is given once."""

    def __init__(self, limit, warning):
        self._limit = limit
        self._warning = warning
        self._programs = {}
        self._warned = False
        #: programs built so far
        self.built = 0

    def get(self, key, build):
        """The program of ``key``, built by ``build()`` if it is not cached."""
        if key not in self._programs:
            program = build()
            self.built += 1
            if len(self._programs) >= self._limit:
                if not self._warned:
                    self._warned = True
                    warnings.warn(self._warning.format(built=self.built, limit=self._limit))
                self._programs.pop(next(iter(self._programs)))
            self._programs[key] = program
        return self._programs[key]

    def discard(self, key):
        """Forget the program of ``key`` (one whose capture failed)."""
        self._programs.pop(key, None)

    def programs(self):
        """The cached programs, oldest first."""
        return list(self._programs.values())

    def __len__(self):
        return len(self._programs)


def route(device_type, training, grad_enabled, capturing):
    """How :class:`ModuleGraphs` runs a call: ``'graphs'`` on the card in
    training with gradients on and no capture under way
    (:func:`capture_under_way`), ``'eager_on_card'`` for any other training
    call on the card, ``'eager'`` for the rest (the CPU, evaluation)."""
    if device_type != 'cuda' or not training:
        return 'eager'
    return 'graphs' if grad_enabled and not capturing else 'eager_on_card'


_requires_grad = operator.attrgetter('requires_grad')
_training = operator.attrgetter('training')


class _Token(object):
    """Lives as long as a replay's autograd node, whose ``ctx`` holds it."""

    __slots__ = ('__weakref__',)


class _ModuleProgram(object):
    """One key's forward and backward, captured into one memory pool from
    ``forward(static_x)``, with ``params`` the parameters that take
    gradients (:class:`ModuleGraphs`)."""

    def __init__(self, module, forward, x, params, name):
        self.params = params
        self.static_x = x.detach().clone().requires_grad_(x.requires_grad)
        inputs = ((self.static_x,) if x.requires_grad else ()) + params

        def warm_up():
            for _ in range(WARMUP_STEPS):
                out = forward(self.static_x)
                torch.autograd.grad(out, inputs, torch.zeros_like(out), allow_unused=True)

        warm_up_undone((module,), x.device, warm_up)
        stream = torch.cuda.current_stream(x.device)
        # thread-local: the loader's threads go on issuing their own work and
        # reading their events while the training thread captures
        options = dict(pool=torch.cuda.graph_pool_handle(), capture_error_mode='thread_local')
        self.forward_graph, self.backward_graph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        try:
            out = _capture(self.forward_graph, lambda: forward(self.static_x), stream,
                           **options)
            self.static_out = out.detach()
            self.static_grad_out = torch.empty_like(out)
            grads = _capture(self.backward_graph, lambda: torch.autograd.grad(
                out, inputs, self.static_grad_out, allow_unused=True), stream, **options)
        except Exception as cause:
            raise ValueError(
                '{}\'s training forward could not be captured into CUDA graphs ({}: {}). A '
                'forward that reads a value back to the host or has data-dependent shapes '
                'cannot run inside one.'.format(name, type(cause).__name__, cause)) from cause
        # _Replay.backward's gradients: none for the program, x's, params'
        self.grads = (None,) + (() if x.requires_grad else (None,)) + tuple(grads)
        self._last = None
        self._awaiting = False

    def replayed(self):
        """Note a forward replay; its autograd node keeps the token."""
        token = _Token()
        self._last = weakref.ref(token)
        self._awaiting = True
        return token

    def busy(self):
        """True while the last replay's output still awaits its backward:
        another replay would overwrite the activations it saved."""
        return self._awaiting and self._last() is not None

    def backward_of(self, token):
        if self._last() is not token:
            raise RuntimeError('the backward of a CUDA graph replay ran after a later replay '
                               'overwrote its saved activations; run each backward before '
                               'the next training call of the model (or call it under '
                               'no_grad)')
        self._awaiting = False


class _Replay(torch.autograd.Function):
    """A :class:`_ModuleProgram`'s forward and backward as replays; the
    gradients handed to autograd are the static ones, which its
    accumulators copy (or add) into ``.grad`` since the program holds them
    too."""

    @staticmethod
    def forward(ctx, program, x, *params):
        program.static_x.copy_(x)
        program.forward_graph.replay()
        ctx.program = program
        ctx.token = program.replayed()
        return program.static_out.clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        program = ctx.program
        program.backward_of(ctx.token)
        program.static_grad_out.copy_(grad)
        program.backward_graph.replay()
        return program.grads


class ModuleGraphs(object):
    """A module's training forward and backward as two CUDA graphs (see the
    module docstring). The module's ``forward`` returns
    ``self.graphs(self, self.forward_eager, x)``; ``name`` names the module
    in the warning given when more than :data:`MODULE_PROGRAMS` keys were
    captured. Copies and unpickled modules start with no graphs."""

    def __init__(self, name):
        self.name = name
        #: ``model_graph_*`` counters and the ``graph_capture`` span
        self.telemetry = MetricsRegistry()
        self._programs = ProgramCache(
            MODULE_PROGRAMS,
            name + ' captured {built} forward and backward graph pairs (new input shapes, '
            'or parameters moved); only the newest {limit} are kept')
        self._tensors = self._params = self._modules = None

    def __reduce__(self):
        return type(self), (self.name,)

    def __call__(self, module, forward, x):
        """``forward(x)``, or its captured graphs' replay (:func:`route`)."""
        way = route(x.device.type, module.training, torch.is_grad_enabled(),
                    x.device.type == 'cuda' and capture_under_way())
        if way == 'graphs':
            program = self._program(module, forward, x)
            if program is not None:
                self.telemetry.inc('model_graph_replay')  # pipecheck: disable=telemetry-names -- the port's own counter (PORT_COUNTERS), which the JAX package's catalog lacks
                return _Replay.apply(program, x, *program.params)
        if way != 'eager':
            self.telemetry.inc('model_graph_eager_on_card')  # pipecheck: disable=telemetry-names -- the port's own counter (PORT_COUNTERS), which the JAX package's catalog lacks
        return forward(x)

    def _program(self, module, forward, x):
        """The program of the call's key, captured if it is new; None where
        the call runs eagerly: nothing takes a gradient, or the program's
        last replay still awaits its backward."""
        if self._tensors is None:
            self._tensors = _state_tensors((module,))
            self._params = list(module.parameters())
            self._modules = list(module.modules())
        requires = tuple(map(_requires_grad, self._params))
        if not (x.requires_grad or any(requires)):
            return None
        key = (x.shape, x.dtype, x.device, x.requires_grad, requires,
               tuple(map(torch.Tensor.data_ptr, self._tensors)),
               tuple(map(_training, self._modules)))
        program = self._programs.get(key, lambda: self._capture(module, forward, x, requires))
        return None if program.busy() else program

    def _capture(self, module, forward, x, requires):
        params = tuple(p for p, takes in zip(self._params, requires) if takes)
        with _spans.host_span('model', 'graph_capture') as span:
            program = _ModuleProgram(module, forward, x, params, self.name)
            torch.cuda.synchronize(x.device)
        self.telemetry.observe('graph_capture', span.seconds)  # pipecheck: disable=telemetry-names -- the port's own stage (PORT_STAGES), which the JAX package's catalog lacks
        self.telemetry.inc('model_graph_capture')  # pipecheck: disable=telemetry-names -- the port's own counter (PORT_COUNTERS), which the JAX package's catalog lacks
        return program
