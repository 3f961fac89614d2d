"""Model-FLOPs utilization (MFU) for the port's training paths on an NVIDIA
H100: the model FLOPs a step needs (what the math requires, not what the
kernels happen to execute) over the step time, against the card's dense bf16
peak. The FLOP count is a copy of ``petastorm_tpu.benchmark.mfu``'s."""

#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W), FLOP/s
H100_PEAK_BF16_FLOPS = 989e12


def transformer_train_flops_per_step(batch, seq_len, vocab, embed, layers,
                                     mlp_mult=4, causal=True):
    """Analytic model FLOPs for one TransformerLM train step (forward and
    backward, backward = 2x forward).

    Per token per layer (forward, 2 FLOPs per multiply-add): qkv projection
    ``6E^2``, attention output ``2E^2``, MLP ``2*2*mlp_mult*E^2``; attention
    scores and values ``4*T*E`` full / ``2*T*E`` causal; the unembedding
    ``2*E*vocab`` per token once. Heads do not change the count (H * d = E)."""
    dense_per_token = (8 + 4 * mlp_mult) * embed * embed * layers
    attn_factor = 2 if causal else 4
    attn_per_token = attn_factor * seq_len * embed * layers
    unembed_per_token = 2 * embed * vocab
    fwd = batch * seq_len * (dense_per_token + attn_per_token + unembed_per_token)
    return 3 * fwd


def mfu(flops_per_step, step_seconds, peak=H100_PEAK_BF16_FLOPS):
    """``(model TFLOP/s, MFU)`` of a step of ``flops_per_step`` taking
    ``step_seconds`` on a card of ``peak`` FLOP/s."""
    achieved = flops_per_step / step_seconds
    return achieved / 1e12, achieved / peak


def moe_transformer_train_flops_per_step(batch, seq_len, vocab, embed, layers,
                                         num_experts, num_selected=1, moe_every=1,
                                         hidden_mult=4, causal=True):
    """Analytic model FLOPs for one MoETransformerLM train step (forward and
    backward).

    MoE layers swap the dense MLP for a router (``2*E*num_experts`` per token)
    plus ``num_selected`` expert MLPs (``4*hidden_mult*E^2`` per routed token).
    Assumes no token drops, a slight overcount when the router drops, which
    only lowers the reported MFU. The one-hot dispatch and combine einsums
    are not model FLOPs and are not counted. Dense layers (where ``(i+1) %
    moe_every != 0``) match the TransformerLM formula."""
    n_moe = sum(1 for i in range(layers) if (i + 1) % moe_every == 0)
    n_dense = layers - n_moe
    attn_per_layer_token = 8 * embed * embed + (2 if causal else 4) * seq_len * embed
    dense_mlp = 4 * hidden_mult * embed * embed
    moe_mlp = 2 * embed * num_experts + num_selected * 4 * hidden_mult * embed * embed
    per_token = (layers * attn_per_layer_token + n_dense * dense_mlp
                 + n_moe * moe_mlp + 2 * embed * vocab)
    return 3 * batch * seq_len * per_token
