"""Flash attention on the card: forward and backward as hand-written Hopper
kernels, the counterpart of ``petastorm_tpu.ops.flash_attention``.

:func:`flash_attention` and :func:`flash_attention_segmented` take the JAX
package's ``[B, T, H, D]`` layout and are ``torch.autograd.Function``\\ s whose
forward launches K2 and whose backward launches K3 (dQ) and K4 (dK/dV), all
exported by ``csrc/flash_attention.cu``:

- K2 replaces ``_flash_kernel`` (``petastorm_tpu/ops/flash_attention.py:44``),
  K3 ``_flash_bwd_dq_kernel`` (``:194``) and K4 ``_flash_bwd_dkv_kernel``
  (``:237``). The kernels work on ``[BH, T, D]``; ``_to_bh``/``_from_bh``
  convert as in the reference, and ``delta = rowsum(dO * O)`` stays plain
  torch, as it is plain XLA outside the Pallas kernels there.
- The kernels take head_dim 64 or 128, any T (the ragged tail is masked),
  float32 or bfloat16, with equal q/k/v shapes. The reference's tile rule
  (``T % block == 0`` and ``head_dim % 128 == 0``) is a TPU lane rule and does
  not carry over; ``block_q``/``block_k`` stay in the signatures for call
  compatibility, and the kernels pick their own tiles. Other shapes
  take the dense path as in the reference, and each such call adds one to
  the module's ``dense_fallbacks``.
- bfloat16 K2, K3 and K4 run on the tensor cores
  (``csrc/flash_attention_sm90.cuh``: wgmma fed by TMA), rounding P (K2, K4)
  and dS (K3, K4) to bf16 before the second product; float32 inputs run fp32
  SIMT kernels.
  :func:`flash_compare` holds a kernel's output against its plain version
  with an allowance derived from that rounding (:func:`flash_reference`).
- Segments (``[B, T]`` int32, 0 = padding, documents numbered from 1) are
  shared by the H heads of each batch row; a row with no valid key gets
  ``o = 0`` and ``lse = 0``. The kernel wrappers also take ``key_segments``,
  the key rows' ids where they are not the query rows' (ring attention
  pairs its local queries with another shard's keys).

Each kernel wrapper (:func:`flash_forward`, :func:`flash_bwd_dq`,
:func:`flash_bwd_dkv`) checks its inputs, launches on the current CUDA stream
for CUDA tensors and counts the launch in ``flash_attention.launches``
(``{'fwd': n, 'dq': n, 'dkv': n}``). A call inside a CUDA graph capture only
records the launch and is not counted, and a replay runs the kernels without
calling the wrappers: a graph's launches show in a profiler trace. For CPU tensors it runs the plain
PyTorch version beside it (:func:`flash_forward_plain`,
:func:`flash_bwd_dq_plain`, :func:`flash_bwd_dkv_plain`), which the CPU tests
and ``chip_smoke.py``'s comparisons also call directly.
"""

import torch

from petastorm_tpu_torch.ops.ring_attention import dense_attention

_NEG_INF = -1e30
#: head dims the kernels are built for
HEAD_DIMS = (64, 128)
#: input dtype -> the kernels' dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the fp32 SIMT kernels' grid holds B * H in its y dimension
_MAX_BH = 65535
#: query/key rows per step of the plain versions
_PLAIN_BLOCK = 1024

#: calls (forward or segmented) whose shapes the kernels do not take, run on
#: the dense path since the count was last set to 0
dense_fallbacks = 0


# ----------------------------------------------------------------- plain versions

def _bh_segments(segments, heads):
    """[B, T] segments -> [B * H, T], row ``bh`` holding batch row ``bh // H``."""
    return None if segments is None else segments.repeat_interleave(heads, dim=0)


def _mask(q0, q1, k0, k1, causal, seg, key_seg, device):
    """Boolean mask ``[BH or 1, q1 - q0, k1 - k0]`` of the scores that attend,
    or None when every score does; ``seg`` holds the query rows' segment
    ids, ``key_seg`` the key rows'."""
    mask = None
    if causal:
        rows = torch.arange(q0, q1, device=device)
        mask = (rows[:, None] >= torch.arange(k0, k1, device=device)[None, :])[None]
    if seg is not None:
        qs = seg[:, q0:q1, None]
        same = (qs == key_seg[:, None, k0:k1]) & (qs > 0)
        mask = same if mask is None else mask & same
    return mask


def flash_forward_plain(q, k, v, causal=False, segments=None, heads=1,
                        key_segments=None):
    """Plain PyTorch version of K2: ``[BH, T, D]`` q, k, v -> (o in q's dtype,
    lse ``[BH, T]`` float32), exact in float32, a block of query rows at a
    time with a full softmax over the keys they see."""
    bh, t, d = q.shape
    scale = d ** -0.5
    seg = _bh_segments(segments, heads)
    key_seg = seg if key_segments is None else _bh_segments(key_segments, heads)
    o = torch.empty_like(q)
    lse = torch.empty(bh, t, dtype=torch.float32, device=q.device)
    for q0 in range(0, t, _PLAIN_BLOCK):
        q1 = min(t, q0 + _PLAIN_BLOCK)
        k1 = q1 if causal else t
        s = torch.matmul(q[:, q0:q1].float(), k[:, :k1].float().transpose(1, 2)) * scale
        mask = _mask(q0, q1, 0, k1, causal, seg, key_seg, q.device)
        if mask is not None:
            s = s.masked_fill(~mask, _NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        if mask is not None:
            p = torch.where(mask, p, torch.zeros_like(p))
        l = p.sum(dim=-1, keepdim=True)
        nonempty = l > 0
        l_safe = torch.where(nonempty, l, torch.ones_like(l))
        out = torch.matmul(p, v[:, :k1].float()) / l_safe
        o[:, q0:q1] = torch.where(nonempty, out, torch.zeros_like(out)).to(q.dtype)
        lse[:, q0:q1] = torch.where(nonempty, m + torch.log(l_safe),
                                    torch.zeros_like(m))[..., 0]
    return o, lse


def _replay(q_blk, k_blk, lse_rows, mask, scale):
    """P of a block replayed from q, k and the forward's lse, masked to 0."""
    s = torch.matmul(q_blk.float(), k_blk.float().transpose(1, 2)) * scale
    p = torch.exp(s - lse_rows[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    return p


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=False, segments=None, heads=1,
                       key_segments=None):
    """Plain PyTorch version of K3: dQ = sum_k dS K scale with
    dS = P * (dO V^T - delta), block by block of query rows, in float32."""
    bh, t, d = q.shape
    scale = d ** -0.5
    seg = _bh_segments(segments, heads)
    key_seg = seg if key_segments is None else _bh_segments(key_segments, heads)
    dq = torch.empty_like(q)
    for q0 in range(0, t, _PLAIN_BLOCK):
        q1 = min(t, q0 + _PLAIN_BLOCK)
        k1 = q1 if causal else t
        p = _replay(q[:, q0:q1], k[:, :k1], lse[:, q0:q1],
                    _mask(q0, q1, 0, k1, causal, seg, key_seg, q.device), scale)
        dp = torch.matmul(do[:, q0:q1].float(), v[:, :k1].float().transpose(1, 2))
        ds = p * (dp - delta[:, q0:q1, None])
        dq[:, q0:q1] = (torch.matmul(ds, k[:, :k1].float()) * scale).to(q.dtype)
    return dq


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=False, segments=None, heads=1,
                        key_segments=None):
    """Plain PyTorch version of K4: dV = sum_q P^T dO and dK = sum_q dS^T Q
    scale, block by block of key rows, in float32."""
    bh, t, d = q.shape
    scale = d ** -0.5
    seg = _bh_segments(segments, heads)
    key_seg = seg if key_segments is None else _bh_segments(key_segments, heads)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for k0 in range(0, t, _PLAIN_BLOCK):
        k1 = min(t, k0 + _PLAIN_BLOCK)
        q0 = k0 if causal else 0
        p = _replay(q[:, q0:], k[:, k0:k1], lse[:, q0:],
                    _mask(q0, t, k0, k1, causal, seg, key_seg, q.device), scale)
        dv[:, k0:k1] = torch.matmul(p.transpose(1, 2), do[:, q0:].float()).to(v.dtype)
        dp = torch.matmul(do[:, q0:].float(), v[:, k0:k1].float().transpose(1, 2))
        ds = p * (dp - delta[:, q0:, None])
        dk[:, k0:k1] = (torch.matmul(ds.transpose(1, 2), q[:, q0:].float()) * scale).to(k.dtype)
    return dk, dv


def flash_dq_abs_plain(q, k, v, do, lse, delta, causal=False, segments=None, heads=1,
                       key_segments=None):
    """``scale * |dS| |K|`` in float32: K3's dQ taken over absolute values,
    the size of the sum whose terms the kernel rounds to bf16."""
    bh, t, d = q.shape
    scale = d ** -0.5
    seg = _bh_segments(segments, heads)
    key_seg = seg if key_segments is None else _bh_segments(key_segments, heads)
    out = torch.empty(bh, t, d, dtype=torch.float32, device=q.device)
    for q0 in range(0, t, _PLAIN_BLOCK):
        q1 = min(t, q0 + _PLAIN_BLOCK)
        k1 = q1 if causal else t
        p = _replay(q[:, q0:q1], k[:, :k1], lse[:, q0:q1],
                    _mask(q0, q1, 0, k1, causal, seg, key_seg, q.device), scale)
        dp = torch.matmul(do[:, q0:q1].float(), v[:, :k1].float().transpose(1, 2))
        ds = (p * (dp - delta[:, q0:q1, None])).abs()
        out[:, q0:q1] = torch.matmul(ds, k[:, :k1].float().abs()) * scale
    return out


def flash_dk_abs_plain(q, k, v, do, lse, delta, causal=False, segments=None, heads=1,
                       key_segments=None):
    """``scale * |dS|^T |Q|`` in float32: K4's dK taken over absolute values,
    the size of the sum whose terms the kernel rounds to bf16."""
    bh, t, d = q.shape
    scale = d ** -0.5
    seg = _bh_segments(segments, heads)
    key_seg = seg if key_segments is None else _bh_segments(key_segments, heads)
    out = torch.empty(bh, t, d, dtype=torch.float32, device=q.device)
    for k0 in range(0, t, _PLAIN_BLOCK):
        k1 = min(t, k0 + _PLAIN_BLOCK)
        q0 = k0 if causal else 0
        p = _replay(q[:, q0:], k[:, k0:k1], lse[:, q0:],
                    _mask(q0, t, k0, k1, causal, seg, key_seg, q.device), scale)
        dp = torch.matmul(do[:, q0:].float(), v[:, k0:k1].float().transpose(1, 2))
        ds = (p * (dp - delta[:, q0:, None])).abs()
        out[:, k0:k1] = torch.matmul(ds.transpose(1, 2), q[:, q0:].float().abs()) * scale
    return out


# ----------------------------------------------------------------- the kernels' check

#: a kernel output against its plain version, by the output's dtype (lse is
#: float32): (rtol, atol, norm limit) of the element-wise bound |got - want|
#: <= rtol * |want| + atol * max|want| (+ the rounding term below) and of
#: ||got - want|| / ||want||. Both sides compute in fp32 and differ by
#: summation order before the final rounding, so a bf16 element may land on
#: the neighbouring bf16 value (at most 2^-7 of it away); atol covers the fp32
#: difference where the value itself is near 0.
FLASH_TOL = {torch.bfloat16: (2.0 ** -7, 2.0 ** -16, 2.0 ** -12),
             torch.float32: (2.0 ** -18, 2.0 ** -22, 2.0 ** -21)}
#: the bf16 tensor-core kernels round each term P (K2, K4) or dS (K3, K4) of
#: the second product to bf16, a relative error of at most 2^-9 a term; a
#: bf16 output of them may also differ by 2^-8 of the same sum over absolute
#: values (P |V| / l for o, scale |dS| |K| for dq, P^T |dO| for dv,
#: scale |dS|^T |Q| for dk)
ROUNDING = 2.0 ** -8
#: ||got - want|| / ||want|| of those outputs (o, dq, dk, dv in bf16): about four
#: times the largest measured on an H100 (2.7e-3: rounding P and dS moves an
#: output by ~1e-3 of its norm, and its own bf16 rounding by about as much)
ROUNDED_NORM_LIMIT = 1.1e-2


def flash_reference(q, k, v, do, causal=False, segments=None, heads=1, key_segments=None):
    """What K2-K4 are held against on inputs ``q, k, v, do``: ``(want,
    bound, lse, delta)``. ``want`` maps each output ('o', 'lse', 'dq', 'dk',
    'dv') to its plain version, the backward's from the plain forward's lse
    and ``delta = rowsum(dO * O)`` (also returned, to feed the kernels);
    ``bound`` maps the outputs that the bf16 kernels round (o, dq, dk, dv;
    none for float32 inputs) to the sum over absolute values that bounds
    it."""
    mode = (causal, segments, heads, key_segments)
    o, lse = flash_forward_plain(q, k, v, *mode)
    delta = (do.float() * o.float()).sum(dim=-1)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, *mode)
    want = {'o': o, 'lse': lse, 'dq': flash_bwd_dq_plain(q, k, v, do, lse, delta, *mode),
            'dk': dk, 'dv': dv}
    bound = {}
    if q.dtype == torch.bfloat16:
        qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
        bound['o'] = flash_forward_plain(qf, kf, vf.abs(), *mode)[0]
        bound['dv'] = flash_bwd_dkv_plain(qf, kf, vf, dof.abs(), lse, delta, *mode)[1]
        bound['dq'] = flash_dq_abs_plain(qf, kf, vf, dof, lse, delta, *mode)
        bound['dk'] = flash_dk_abs_plain(qf, kf, vf, dof, lse, delta, *mode)
    return want, bound, lse, delta


def flash_compare(got, want, bound=None):
    """One kernel output against its plain version: ``{'max_abs_err',
    'tol_share' (the largest share of an element's allowance used),
    'rel_norm_err', 'ok'}``. With ``bound`` (from :func:`flash_reference`)
    each element's allowance adds ``ROUNDING * bound`` and the norm limit is
    ``ROUNDED_NORM_LIMIT``; otherwise ``FLASH_TOL`` alone."""
    rtol, atol, norm_limit = FLASH_TOL[want.dtype]
    got, want = got.double(), want.double()
    err = (got - want).abs()
    allowed = rtol * want.abs() + atol * float(want.abs().max())
    if bound is not None:
        allowed = allowed + ROUNDING * bound.double()
        norm_limit = ROUNDED_NORM_LIMIT
    share = float((err / allowed.clamp_min(1e-30)).max())
    norm = float(want.norm())
    norm_err = float(err.norm()) / norm if norm else float(err.norm())
    return {'max_abs_err': float(err.max()), 'tol_share': share, 'rel_norm_err': norm_err,
            'ok': share <= 1 and norm_err <= norm_limit}


# ----------------------------------------------------------------- kernel wrappers

def _check(name, tensors, segments, heads, rows=(), key_segments=None):
    """Raise unless the [BH, T, D] tensors, the [BH, T] float32 row vectors
    and the [BH / heads, T] int32 segments (and key segments) are what the
    kernels take."""
    first = tensors[0]
    device = first.device
    if device.type not in ('cuda', 'cpu'):
        raise ValueError('{} runs on cuda or cpu tensors, got {}'.format(name, device))
    if first.dim() != 3:
        raise ValueError('{} takes [BH, T, D] tensors, got shape {}'.format(
            name, tuple(first.shape)))
    bh, t, d = first.shape
    for x in tensors:
        if x.shape != first.shape or x.dtype != first.dtype or x.device != device:
            raise ValueError('{}: q, k, v (and dO) must share shape, dtype and device'
                             .format(name))
        if not x.is_contiguous():
            raise ValueError('{} needs contiguous inputs'.format(name))
    if first.dtype not in _DTYPE_CODES:
        raise ValueError('{} takes float32 or bfloat16, got {}'.format(name, first.dtype))
    if d not in HEAD_DIMS:
        raise ValueError('{} takes head_dim {}, got {}'.format(name, HEAD_DIMS, d))
    if t < 1 or bh < 1 or bh > _MAX_BH:
        raise ValueError('{}: need T >= 1 and 1 <= B * H <= {}, got {}'.format(
            name, _MAX_BH, tuple(first.shape)))
    for x in rows:
        if (x.shape != (bh, t) or x.dtype != torch.float32 or x.device != device
                or not x.is_contiguous()):
            raise ValueError('{}: lse and delta must be contiguous float32 [BH, T]'
                             .format(name))
    if key_segments is not None and segments is None:
        raise ValueError('{}: key_segments need segments'.format(name))
    if segments is not None:
        if heads < 1 or bh % heads:
            raise ValueError('{}: B * H = {} is not a multiple of heads = {}'.format(
                name, bh, heads))
        for ids in (segments, key_segments):
            if ids is not None and (ids.shape != (bh // heads, t) or ids.dtype != torch.int32
                                    or ids.device != device or not ids.is_contiguous()):
                raise ValueError('{}: segments must be contiguous int32 [B, T] on the '
                                 'inputs\' device'.format(name))


def _run(symbol, counter, tensors, ints):
    """Launch ``symbol`` with device pointers (None for a missing tensor) and
    int arguments on the current stream; raise on a non-zero cudaError."""
    from petastorm_tpu_torch import cuda_build
    kernel = cuda_build.load('flash_attention', symbol)
    device = tensors[0].device
    pointers = [x.data_ptr() if x is not None else None for x in tensors]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = kernel(*pointers, *ints, stream)
    if status != 0:
        raise RuntimeError('{} kernel launch failed: cudaError {}'.format(symbol, status))
    if not torch.cuda.is_current_stream_capturing():
        flash_attention.launches[counter] += 1   # a captured call only records the launch


def _key_ids(segments, key_segments):
    """The key rows' segment ids the kernels read: the query rows' own for
    self-attention."""
    return segments if key_segments is None else key_segments


def flash_forward(q, k, v, causal=False, segments=None, heads=1, key_segments=None):
    """K2: ``[BH, T, D]`` q, k, v (and optional ``[B, T]`` int32 segments with
    B = BH / heads, and the key rows' own when they differ) -> (o ``[BH, T,
    D]`` in q's dtype, lse ``[BH, T]`` float32). Launches the kernel for CUDA
    tensors, runs :func:`flash_forward_plain` for CPU tensors."""
    _check('flash_forward', (q, k, v), segments, heads, key_segments=key_segments)
    if q.device.type == 'cpu':
        return flash_forward_plain(q, k, v, causal, segments, heads, key_segments)
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(bh, t, dtype=torch.float32, device=q.device)
    _run('flash_fwd', 'fwd', (q, k, v, segments, _key_ids(segments, key_segments), o, lse),
         (bh, t, d, heads, int(bool(causal)), _DTYPE_CODES[q.dtype]))
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False, segments=None, heads=1,
                 key_segments=None):
    """K3: dQ ``[BH, T, D]`` from q, k, v, dO, the forward's lse and
    ``delta = rowsum(dO * O)``. Kernel for CUDA tensors,
    :func:`flash_bwd_dq_plain` for CPU tensors."""
    _check('flash_bwd_dq', (q, k, v, do), segments, heads, rows=(lse, delta),
           key_segments=key_segments)
    if q.device.type == 'cpu':
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, segments, heads,
                                  key_segments)
    bh, t, d = q.shape
    dq = torch.empty_like(q)
    _run('flash_bwd_dq', 'dq',
         (q, k, v, do, lse, delta, segments, _key_ids(segments, key_segments), dq),
         (bh, t, d, heads, int(bool(causal)), _DTYPE_CODES[q.dtype]))
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, segments=None, heads=1,
                  key_segments=None):
    """K4: (dK, dV) ``[BH, T, D]`` from the same inputs as K3. Kernel for CUDA
    tensors, :func:`flash_bwd_dkv_plain` for CPU tensors."""
    _check('flash_bwd_dkv', (q, k, v, do), segments, heads, rows=(lse, delta),
           key_segments=key_segments)
    if q.device.type == 'cpu':
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, segments, heads,
                                   key_segments)
    bh, t, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _run('flash_bwd_dkv', 'dkv',
         (q, k, v, do, lse, delta, segments, _key_ids(segments, key_segments), dk, dv),
         (bh, t, d, heads, int(bool(causal)), _DTYPE_CODES[q.dtype]))
    return dk, dv


# ----------------------------------------------------------------- autograd

def _to_bh(x):
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def _from_bh(x, b, h):
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).permute(0, 2, 1, 3)


class _FlashAttention(torch.autograd.Function):
    """Forward through K2, backward through K3 and K4, on [B, T, H, D]
    inputs."""

    @staticmethod
    def forward(ctx, q, k, v, segments, causal):
        b, _, h, _ = q.shape
        q_bh, k_bh, v_bh = _to_bh(q), _to_bh(k), _to_bh(v)
        o_bh, lse = flash_forward(q_bh, k_bh, v_bh, causal, segments, h)
        ctx.save_for_backward(q_bh, k_bh, v_bh, o_bh, lse, segments)
        ctx.causal = causal
        ctx.dims = (b, h)
        return _from_bh(o_bh, b, h)

    @staticmethod
    def backward(ctx, grad):
        q_bh, k_bh, v_bh, o_bh, lse, segments = ctx.saved_tensors
        b, h = ctx.dims
        do = _to_bh(grad.to(o_bh.dtype))
        # the softmax jacobian's diagonal term, O(T * D): no score matrix
        delta = (do.float() * o_bh.float()).sum(dim=-1)
        dq = flash_bwd_dq(q_bh, k_bh, v_bh, do, lse, delta, ctx.causal, segments, h)
        dk, dv = flash_bwd_dkv(q_bh, k_bh, v_bh, do, lse, delta, ctx.causal, segments, h)
        return _from_bh(dq, b, h), _from_bh(dk, b, h), _from_bh(dv, b, h), None, None


def _use_kernels(q, k, v):
    """The dispatch predicate: True when the kernels take these ``[B, T, H,
    D]`` inputs (equal q/k/v shapes, head_dim 64 or 128, T >= 1, float32 or
    bfloat16, B * H within the grid)."""
    return (q.dim() == 4 and q.shape == k.shape == v.shape and q.shape[-1] in HEAD_DIMS
            and q.shape[1] >= 1 and q.dtype in _DTYPE_CODES
            and q.dtype == k.dtype == v.dtype and 1 <= q.shape[0] * q.shape[2] <= _MAX_BH)


def _count_fallback():
    global dense_fallbacks
    dense_fallbacks += 1


def flash_attention(q, k, v, causal=False, block_q='auto', block_k='auto'):
    """Exact attention over ``[B, T, H, D]`` inputs (the layout of
    :func:`~petastorm_tpu_torch.ops.ring_attention.dense_attention`), forward
    through K2 and backward through K3/K4, with O(T * tile) memory in both.
    Shapes the kernels do not take run the dense path (counted in
    ``dense_fallbacks``). ``block_q``/``block_k`` are ignored (the kernels
    pick their tiles)."""
    if not _use_kernels(q, k, v):
        _count_fallback()
        return dense_attention(q, k, v, causal=causal)
    return _FlashAttention.apply(q, k, v, None, bool(causal))


#: launches of K2 ('fwd'), K3 ('dq') and K4 ('dkv') since the counts were
#: last set to 0
flash_attention.launches = {'fwd': 0, 'dq': 0, 'dkv': 0}


def flash_attention_segmented(q, k, v, segments, causal=False, block_q='auto',
                              block_k='auto'):
    """Flash attention confined to packed-sequence segments: ``[B, T, H, D]``
    inputs plus ``segments [B, T]`` int32 (0 = padding, documents numbered
    from 1; padding rows emit zeros), through the same kernels with the
    segment mask applied in every tile. Shapes the kernels do not take run
    the masked dense path (counted in ``dense_fallbacks``)."""
    if segments.dim() != 2 or tuple(segments.shape) != (q.shape[0], q.shape[1]):
        raise ValueError('segments must be [B, T] = {}, got {}'.format(
            (q.shape[0], q.shape[1]), tuple(segments.shape)))
    if not _use_kernels(q, k, v):
        from petastorm_tpu_torch.ops.packing import masked_dense_attention, segment_mask
        _count_fallback()
        return masked_dense_attention(q, k, v, segment_mask(segments, segments, causal=causal))
    segments = segments.to(device=q.device, dtype=torch.int32).contiguous()
    return _FlashAttention.apply(q, k, v, segments, bool(causal))
