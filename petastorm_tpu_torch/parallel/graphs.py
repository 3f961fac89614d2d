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
"""

import time
import warnings

import torch

#: eager calls of the first step before a capture
WARMUP_STEPS = 3


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
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.step_fn(self._batch_of(0))
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)

    def _capture(self):
        start = time.perf_counter()
        tensors = _state_tensors(self._state)
        saved = [tensor.detach().clone() for tensor in tensors]
        known = {id(tensor) for tensor in tensors}
        rng = torch.cuda.get_rng_state(self.device)
        self._warm_up()
        with torch.no_grad():
            for tensor, value in zip(tensors, saved):
                tensor.copy_(value)
            for tensor in _state_tensors(self._state):
                if id(tensor) not in known:
                    tensor.zero_()
        del saved
        _drop_grads(self._state)
        torch.cuda.set_rng_state(rng, self.device)
        torch.cuda.synchronize(self.device)

        try:
            # kept after instantiation, so kernel_nodes() can read it
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError:   # a torch without keep_graph
            graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream(self.device)
        first_error = []
        try:
            with torch.cuda.graph(graph):
                try:
                    auxes = [self.step_fn(self._batch_of(i)) for i in range(self.steps)]
                    leaves = _flatten(_stack_steps(auxes))
                except Exception as exc:
                    first_error.append(exc)
                    raise
        except Exception as exc:
            # a failed capture leaves torch's capture stream current: put the
            # caller's back, and drop gradients that point into the graph's pool
            torch.cuda.set_stream(stream)
            _drop_grads(self._state)
            cause = first_error[0] if first_error else exc
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
