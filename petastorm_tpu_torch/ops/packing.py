"""Sequence packing: variable-length token rows -> fixed-shape bins with
segments, and the attention and loss that keep packed documents apart. The
counterpart of ``petastorm_tpu.ops.packing``.

- :func:`pack_sequences` (greedy first-fit, deterministic, numpy) is a copy of
  the JAX package's and gives the same arrays for the same input.
  :func:`make_packing_transform` runs it inside ``make_batch_reader``'s
  workers, so packing parallelizes across rowgroups and the loader ships
  dense ``[n_bins, seq_len]`` columns.

  Defined difference: the port's transform is a ``TransformSpec(batched=True)``
  whose ``func`` takes and returns a dict of columns, where the JAX package's
  takes and returns a pandas ``DataFrame``: the card machine has no pandas.
  The bins are the same.
- :func:`segment_causal_attention` masks attention to (same segment AND causal
  AND not padding); with ``use_flash=True`` it runs the segmented flash
  kernels. :func:`packed_next_token_loss` masks targets that would cross a
  document boundary.

Pass the packed ``<field>_positions`` column as ``TransformerLM``'s
``positions`` so each document's position embedding restarts at 0.
"""

import warnings

import numpy as np
import torch

_NEG_INF = -1e30


def pack_sequences(sequences, seq_len, dtype=np.int32):
    """Greedy first-fit packing of 1-D arrays into fixed-length bins.

    :param sequences: iterable of 1-D integer arrays, each with
        ``0 < len <= seq_len`` (longer sequences raise; empty ones are skipped).
    :param seq_len: bin length.
    :returns: dict with ``tokens [n_bins, seq_len]`` of ``dtype``, and int32
        ``segments`` (1-based per-bin segment ids, 0 = padding) and
        ``positions`` (offset within the segment), all numpy arrays.
        Deterministic: first fit in arrival order.
    """
    bins = []
    space = []
    for i, seq in enumerate(sequences):
        seq = np.asarray(seq)
        if seq.ndim != 1:
            raise ValueError('sequence {} has ndim {} (expected 1)'.format(i, seq.ndim))
        if len(seq) == 0:
            continue
        if len(seq) > seq_len:
            raise ValueError('sequence {} has length {} > seq_len {}; split it '
                             'upstream'.format(i, len(seq), seq_len))
        for b, free in enumerate(space):
            if free >= len(seq):
                bins[b].append(seq)
                space[b] -= len(seq)
                break
        else:
            bins.append([seq])
            space.append(seq_len - len(seq))

    n_bins = max(1, len(bins))
    tokens = np.zeros((n_bins, seq_len), dtype=dtype)
    segments = np.zeros((n_bins, seq_len), dtype=np.int32)
    positions = np.zeros((n_bins, seq_len), dtype=np.int32)
    for b, seqs in enumerate(bins):
        offset = 0
        for seg_id, seq in enumerate(seqs, start=1):
            end = offset + len(seq)
            tokens[b, offset:end] = seq
            segments[b, offset:end] = seg_id
            positions[b, offset:end] = np.arange(len(seq))
            offset = end
    return {'tokens': tokens, 'segments': segments, 'positions': positions}


def make_packing_transform(field, seq_len, dtype=np.int32):
    """``TransformSpec`` packing a ragged ``field`` inside ``make_batch_reader``
    workers: each rowgroup batch of variable-length rows becomes ``[n_bins,
    seq_len]`` columns ``field``, ``<field>_segments`` and
    ``<field>_positions`` (``dtype``, int32, int32). Bins never mix rowgroups."""
    from petastorm_tpu_torch.transform import TransformSpec

    seg_field = field + '_segments'
    pos_field = field + '_positions'

    def func(columns):
        values = list(columns[field])
        if values and isinstance(values[0], bytes):
            raise ValueError(
                'field {!r} arrived as raw bytes: make_batch_reader on a Unischema '
                'store emits codec-encoded values. Pack from a native Parquet list '
                'column, or decode with make_reader upstream.'.format(field))
        packed = pack_sequences(values, seq_len, dtype=dtype)
        return {field: packed['tokens'], seg_field: packed['segments'],
                pos_field: packed['positions']}

    return TransformSpec(
        func,
        edit_fields=[(field, dtype, (seq_len,), False),
                     (seg_field, np.int32, (seq_len,), False),
                     (pos_field, np.int32, (seq_len,), False)],
        selected_fields=[field, seg_field, pos_field],
        batched=True)


def segment_mask(q_segments, k_segments, causal=True):
    """Boolean attention mask ``[B, 1, Tq, Tk]`` (broadcasts over heads): same
    segment AND both positions non-padding AND (optionally) causal."""
    same = q_segments[:, None, :, None] == k_segments[:, None, None, :]
    valid = (q_segments > 0)[:, None, :, None] & (k_segments > 0)[:, None, None, :]
    mask = same & valid
    if causal:
        t_q, t_k = q_segments.shape[1], k_segments.shape[1]
        tri = (torch.arange(t_q, device=q_segments.device)[:, None]
               >= torch.arange(t_k, device=q_segments.device)[None, :])
        mask = mask & tri[None, None]
    return mask


def masked_dense_attention(q, k, v, mask):
    """``[B, T, H, D]`` attention with an explicit ``[B, 1, Tq, Tk]`` mask (fp32
    scores). Query positions with no valid key (padding) return zeros."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    any_valid = mask.any(dim=-1, keepdim=True)
    p = torch.where(any_valid, p, torch.zeros_like(p))
    return torch.einsum('bhqk,bkhd->bqhd', p, v.float()).to(q.dtype)


def segment_causal_attention(segments, use_flash=False, block_q='auto', block_k='auto'):
    """Attention backend for packed batches, to pass as ``TransformerLM``'s
    ``attention_fn``::

        logits = model(tokens, positions=positions,
                       attention_fn=segment_causal_attention(segments, use_flash=True))

    Tokens attend causally within their segment only; padding attends nowhere.
    ``use_flash`` routes through the segmented flash kernels
    (:func:`petastorm_tpu_torch.ops.flash_attention.flash_attention_segmented`);
    shapes the kernels do not take run the dense path with a warning."""
    if use_flash:
        from petastorm_tpu_torch.ops.flash_attention import (_use_kernels,
                                                             flash_attention_segmented)

        def attention_fn(q, k, v):
            if not _use_kernels(q, k, v):
                # the flag promises the flash memory bound; a silent dense
                # fallback would materialize [B, H, T, T] with no signal
                warnings.warn(
                    'segment_causal_attention(use_flash=True): shapes {}x{} head_dim {} '
                    'dtype {} are not taken by the flash kernels (need equal q/k/v '
                    'shapes, head_dim 64 or 128, float32 or bfloat16); running the '
                    'O(T^2) masked dense path instead.'.format(
                        q.shape[1], k.shape[1], q.shape[-1], q.dtype), stacklevel=2)
            return flash_attention_segmented(q, k, v, segments, True, block_q, block_k)
        return attention_fn

    def attention_fn(q, k, v):
        return masked_dense_attention(q, k, v, segment_mask(segments, segments))
    return attention_fn


def packed_next_token_loss(logits, tokens, segments):
    """Causal LM loss over a packed batch: position ``t`` predicts ``t+1`` only
    when both lie in the same non-padding segment; the mean runs over valid
    predictions only."""
    if tokens.shape[1] < 2:
        raise ValueError('packed_next_token_loss needs seq_len >= 2 (got {})'
                         .format(tokens.shape[1]))
    valid = ((segments[:, 1:] == segments[:, :-1]) & (segments[:, :-1] > 0)).float()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)
