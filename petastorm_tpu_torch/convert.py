"""Weight conversion from the JAX package's models to the port's modules."""

import numpy as np
import torch

#: flax submodule name -> port submodule name inside one bottleneck block
_BLOCK_LAYERS = (('Conv_0', 'conv1'), ('BatchNorm_0', 'bn1'), ('Conv_1', 'conv2'),
                 ('BatchNorm_1', 'bn2'), ('Conv_2', 'conv3'), ('BatchNorm_2', 'bn3'),
                 ('conv_proj', 'conv_proj'), ('norm_proj', 'norm_proj'))


def _conv(params):
    # flax HWIO -> torch OIHW
    return {'weight': np.transpose(np.asarray(params['kernel']), (3, 2, 0, 1))}


def _norm(params, stats):
    return {'weight': np.asarray(params['scale']), 'bias': np.asarray(params['bias']),
            'running_mean': np.asarray(stats['mean']),
            'running_var': np.asarray(stats['var'])}


def resnet_state_dict_from_flax(variables):
    """``petastorm_tpu.models.resnet.ResNet`` variables (``{'params': ...,
    'batch_stats': ...}`` with numpy leaves) -> a ``state_dict`` for
    :class:`petastorm_tpu_torch.models.resnet.ResNet` of the same
    configuration: conv kernels HWIO -> OIHW, the dense kernel ``(in, out)`` ->
    ``(out, in)``, batch-norm scale/bias/mean/var as they are."""
    params = variables['params']
    stats = variables['batch_stats']
    out = {}

    def put(prefix, tensors):
        for name, value in tensors.items():
            out['{}.{}'.format(prefix, name)] = torch.from_numpy(
                np.array(value, dtype=np.float32))

    put('conv_init', _conv(params['conv_init']))
    put('bn_init', _norm(params['bn_init'], stats['bn_init']))
    index = 0
    while 'BottleneckBlock_{}'.format(index) in params:
        key = 'BottleneckBlock_{}'.format(index)
        for flax_name, port_name in _BLOCK_LAYERS:
            if flax_name not in params[key]:
                continue
            prefix = 'blocks.{}.{}'.format(index, port_name)
            if flax_name.startswith(('Conv', 'conv')):
                put(prefix, _conv(params[key][flax_name]))
            else:
                put(prefix, _norm(params[key][flax_name], stats[key][flax_name]))
        index += 1
    dense = params['Dense_0']
    put('head', {'weight': np.asarray(dense['kernel']).T, 'bias': np.asarray(dense['bias'])})
    return out


#: flax submodule name -> port submodule name inside one transformer block
_TRANSFORMER_BLOCK_LAYERS = (('LayerNorm_0', 'norm_attn'), ('Dense_0', 'qkv'),
                             ('Dense_1', 'proj'), ('LayerNorm_1', 'norm_mlp'),
                             ('Dense_2', 'mlp_up'), ('Dense_3', 'mlp_down'))


def _dense(params):
    out = {'weight': np.asarray(params['kernel']).T}
    if 'bias' in params:
        out['bias'] = np.asarray(params['bias'])
    return out


def _layer_norm(params):
    return {'weight': np.asarray(params['scale']), 'bias': np.asarray(params['bias'])}


def transformer_state_dict_from_flax(variables):
    """``petastorm_tpu.models.transformer.TransformerLM`` variables
    (``{'params': ...}`` with numpy leaves) -> a ``state_dict`` for
    :class:`petastorm_tpu_torch.models.transformer.TransformerLM` of the same
    configuration: token and position tables as they are, dense kernels
    ``(in, out)`` -> ``(out, in)``, layer-norm scale/bias as weight/bias."""
    params = variables['params']
    out = {}

    def put(prefix, tensors):
        for name, value in tensors.items():
            out['{}.{}'.format(prefix, name)] = torch.from_numpy(
                np.array(value, dtype=np.float32))

    put('tok_embed', {'weight': params['Embed_0']['embedding']})
    put('pos_embed', {'weight': params['Embed_1']['embedding']})
    index = 0
    while 'Block_{}'.format(index) in params:
        block = params['Block_{}'.format(index)]
        for flax_name, port_name in _TRANSFORMER_BLOCK_LAYERS:
            convert = _layer_norm if flax_name.startswith('LayerNorm') else _dense
            put('blocks.{}.{}'.format(index, port_name), convert(block[flax_name]))
        index += 1
    put('norm', _layer_norm(params['LayerNorm_0']))
    put('head', _dense(params['Dense_0']))
    return out


def block_state_dicts_from_flax(stacked):
    """The JAX package's stacked pipeline stages (``stack_stage_params`` of
    ``petastorm_tpu.models.transformer.Block`` params, numpy leaves with a
    leading stages axis) -> one ``state_dict`` per stage for
    :class:`petastorm_tpu_torch.models.transformer.Block`, converted as
    :func:`transformer_state_dict_from_flax` converts a block."""
    stages = len(np.asarray(stacked['Dense_0']['kernel']))
    out = []
    for stage in range(stages):
        state = {}
        for flax_name, port_name in _TRANSFORMER_BLOCK_LAYERS:
            layer = {name: np.asarray(value)[stage]
                     for name, value in stacked[flax_name].items()}
            convert = _layer_norm if flax_name.startswith('LayerNorm') else _dense
            for name, value in convert(layer).items():
                state['{}.{}'.format(port_name, name)] = torch.from_numpy(
                    np.array(value, dtype=np.float32))
        out.append(state)
    return out


#: flax submodule name -> port submodule name of MnistCNN
_MNIST_LAYERS = (('Conv_0', 'conv1'), ('Conv_1', 'conv2'), ('Dense_0', 'fc1'),
                 ('Dense_1', 'fc2'))


def mnist_state_dict_from_flax(variables):
    """``petastorm_tpu.models.mnist.MnistCNN`` variables (``{'params': ...}``
    with numpy leaves) -> a ``state_dict`` for
    :class:`petastorm_tpu_torch.models.mnist.MnistCNN`: conv kernels HWIO ->
    OIHW, dense kernels ``(in, out)`` -> ``(out, in)``, biases as they are.
    ``Dense_0``'s rows stay in flax's ``(h, w, c)`` order: the port's model
    flattens its activations in that order."""
    params = variables['params']
    out = {}
    for flax_name, port_name in _MNIST_LAYERS:
        layer = params[flax_name]
        weight = _conv(layer) if flax_name.startswith('Conv') else _dense(layer)
        weight['bias'] = np.asarray(layer['bias'])
        for name, value in weight.items():
            out['{}.{}'.format(port_name, name)] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    return out


#: flax submodule name -> port submodule name inside one MoE block (its MoEMlp
#: is converted apart)
_MOE_BLOCK_LAYERS = (('LayerNorm_0', 'norm_attn'), ('Dense_0', 'qkv'), ('Dense_1', 'proj'),
                     ('LayerNorm_1', 'norm_mlp'))


def _moe_mlp(params):
    # w1/w2 are einsum operands [experts, in, out], not Dense kernels: as they are
    return {'router.weight': np.asarray(params['router']['kernel']).T,
            'w1': np.asarray(params['w1']), 'w2': np.asarray(params['w2'])}


def moe_state_dict_from_flax(variables, moe_every=1):
    """``petastorm_tpu.models.moe`` variables (``{'params': ...}`` with numpy
    leaves) of a ``MoETransformerLM`` built with ``moe_every``, or of a root
    ``MoEMlp``, -> a ``state_dict`` for the port's module of the same
    configuration. Layer ``i`` is flax's ``MoEBlock_j`` when ``(i + 1) %
    moe_every == 0`` (the j-th such layer), else ``Block_j``; dense kernels
    ``(in, out)`` -> ``(out, in)``, the router's too."""
    params = variables['params']
    out = {}

    def put(prefix, tensors):
        for name, value in tensors.items():
            key = '{}.{}'.format(prefix, name) if prefix else name
            out[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    if 'router' in params:
        put('', _moe_mlp(params))
        return out
    put('tok_embed', {'weight': params['Embed_0']['embedding']})
    put('pos_embed', {'weight': params['Embed_1']['embedding']})
    n_moe = n_dense = 0
    for index in range(sum(1 for key in params if key.startswith(('Block_', 'MoEBlock_')))):
        prefix = 'blocks.{}'.format(index)
        if (index + 1) % moe_every == 0:
            block = params['MoEBlock_{}'.format(n_moe)]
            layers = _MOE_BLOCK_LAYERS
            put(prefix + '.moe', _moe_mlp(block['MoEMlp_0']))
            n_moe += 1
        else:
            block = params['Block_{}'.format(n_dense)]
            layers = _TRANSFORMER_BLOCK_LAYERS
            n_dense += 1
        for flax_name, port_name in layers:
            convert = _layer_norm if flax_name.startswith('LayerNorm') else _dense
            put('{}.{}'.format(prefix, port_name), convert(block[flax_name]))
    put('norm', _layer_norm(params['LayerNorm_0']))
    put('head', _dense(params['Dense_0']))
    return out
