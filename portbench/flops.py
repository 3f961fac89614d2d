"""Model FLOPs of a training step, counted from shapes (2 FLOPs a multiply-add;
the backward is twice the forward). Only what the model's mathematics needs
is counted: no padding, no masked attention, no recomputation."""


def resnet_forward_flops(stage_sizes, num_filters, classes, image):
    """Forward FLOPs of one ``image`` x ``image`` picture through the
    bottleneck ResNet of ``stage_sizes``: every convolution and the head
    (batch norm, ReLU, pooling and the residual adds are not counted)."""

    def conv(size, in_ch, out_ch, kernel, stride):
        out = -(-size // stride)
        return out, 2 * kernel * kernel * in_ch * out_ch * out * out

    size, total = conv(image, 3, num_filters, 7, 2)
    size = -(-size // 2)                                   # the 3x3 stride-2 max pool
    in_ch = num_filters
    for stage, count in enumerate(stage_sizes):
        filters = num_filters * 2 ** stage
        for index in range(count):
            stride = 2 if stage > 0 and index == 0 else 1
            _, a = conv(size, in_ch, filters, 1, 1)
            out, b = conv(size, filters, filters, 3, stride)
            _, c = conv(out, filters, filters * 4, 1, 1)
            total += a + b + c
            if in_ch != filters * 4 or stride != 1:
                total += conv(size, in_ch, filters * 4, 1, stride)[1]
            size, in_ch = out, filters * 4
    return total + 2 * in_ch * classes


def lm_train_flops(real_tokens, attending_pairs, embed, layers, vocab, mlp_mult=4):
    """Training FLOPs of a decoder LM step.

    :param real_tokens: tokens that are not padding.
    :param attending_pairs: (query, key) pairs that attend, summed over the
        batch, for one head (within each document, causal).
    Per real token and layer: the q, k, v and output projections ``8 E^2``
    and the MLP ``4 * mlp_mult * E^2``; per attending pair and layer ``4 E``
    (scores and values over all heads); per real token the head ``2 E V``."""
    dense = (8 + 4 * mlp_mult) * embed * embed * layers + 2 * embed * vocab
    forward = real_tokens * dense + 4 * embed * layers * attending_pairs
    return 3 * forward
