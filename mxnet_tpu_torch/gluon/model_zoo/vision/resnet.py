"""ResNet V1/V2 of the port's model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``; He et al. 1512.03385 for
V1, 1603.05027 for pre-activation V2).

The same blocks, layer lists and parameter names as the JAX package, on the
port's Gluon layers. Shapes are not deferred, so every block is built with
its ``in_channels`` and the stem takes 3-channel images. The convolutions
are cuDNN's (``ops.nn.convolution``); the kernel the JAX package wrote for
ResNet, the fused 1x1 pair, runs in the inference rewrite
``contrib.pallas_fuse.fuse_resnet_v1``.
"""
from __future__ import annotations

import math

import numpy as _onp
import torch
from torch import nn as _tnn

from .... import device as _device
from .... import random as _rng
from ....base import MXNetError
from ... import nn


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


class BasicBlockV1(_tnn.Module):
    """ResNet V1 basic block: conv-bn-relu x2 + identity shortcut."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm(in_channels=channels))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm(in_channels=channels))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm(in_channels=channels))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(x + residual)


class BottleneckV1(_tnn.Module):
    """ResNet V1 bottleneck: 1x1 -> 3x3 -> 1x1 with 4x expansion; the
    stride is on the first 1x1."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        mid = channels // 4
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                use_bias=False, in_channels=in_channels))
        self.body.add(nn.BatchNorm(in_channels=mid))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid))
        self.body.add(nn.BatchNorm(in_channels=mid))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                use_bias=False, in_channels=mid))
        self.body.add(nn.BatchNorm(in_channels=channels))
        if downsample:
            self.downsample = nn.HybridSequential()
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels))
            self.downsample.add(nn.BatchNorm(in_channels=channels))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return torch.relu(x + residual)


class BasicBlockV2(_tnn.Module):
    """Pre-activation basic block (bn-relu-conv x2)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.bn1 = nn.BatchNorm(in_channels=in_channels)
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm(in_channels=channels)
        self.conv2 = _conv3x3(channels, 1, channels)
        self.downsample = (nn.Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels)
                           if downsample else None)

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        x = self.conv2(x)
        return x + residual


class BottleneckV2(_tnn.Module):
    """Pre-activation bottleneck block."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        mid = channels // 4
        self.bn1 = nn.BatchNorm(in_channels=in_channels)
        self.conv1 = nn.Conv2D(mid, 1, 1, use_bias=False,
                               in_channels=in_channels)
        self.bn2 = nn.BatchNorm(in_channels=mid)
        self.conv2 = _conv3x3(mid, stride, mid)
        self.bn3 = nn.BatchNorm(in_channels=mid)
        self.conv3 = nn.Conv2D(channels, 1, 1, use_bias=False,
                               in_channels=mid)
        self.downsample = (nn.Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels)
                           if downsample else None)

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        x = self.conv2(x)
        x = torch.relu(self.bn3(x))
        x = self.conv3(x)
        return x + residual


class ResNetV1(_tnn.Module):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False):
        super().__init__()
        assert len(layers) == len(channels) - 1
        self.features = nn.HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 3))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                        in_channels=3))
            self.features.add(nn.BatchNorm(in_channels=channels[0]))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=channels[i]))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1])

    @staticmethod
    def _make_layer(block, layers, channels, stride, in_channels=0):
        layer = nn.HybridSequential()
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels))
        return layer

    def forward(self, x):
        x = self.features(x)
        x = x.reshape(x.shape[0], -1)
        return self.output(x)


class ResNetV2(_tnn.Module):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False):
        super().__init__()
        assert len(layers) == len(channels) - 1
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(scale=False, center=False,
                                       in_channels=3))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 3))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                        in_channels=3))
            self.features.add(nn.BatchNorm(in_channels=channels[0]))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(ResNetV1._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=in_channels))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm(in_channels=in_channels))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=in_channels)

    def forward(self, x):
        x = self.features(x)
        x = x.reshape(x.shape[0], -1)
        return self.output(x)


# block type / layer counts / stage channels per depth, as in the JAX package
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}

resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def _init_weights(model, dev):
    """Gluon's ``initialize(init="xavier")`` in distribution: every conv and
    dense weight uniform in +-sqrt(3 / ((fan_in + fan_out) / 2)), from the
    device's ``mxnet_tpu_torch.random`` stream; dense biases 0; BatchNorm
    gamma 1, beta 0, running mean 0, running variance 1."""
    gen = _rng.generator(dev)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2D, nn.Dense)):
                w = m.weight
                rf = math.prod(w.shape[2:])
                scale = math.sqrt(3.0 / ((w.shape[0] + w.shape[1]) * rf / 2))
                w.uniform_(-scale, scale, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm):
                m.reset_parameters()


def get_resnet(version, num_layers, pretrained=False, device=None,
               trainable=False, **kwargs):
    """ResNet ``version`` (1 or 2) of depth ``num_layers`` on ``device``
    (the GPU unless ``"cpu"`` is asked for; raises without CUDA), with
    seeded random weights (:func:`_init_weights`). The model is in eval
    mode with gradients off, for serving; ``trainable=True`` gives it in
    train mode with gradients on, for ``gluon.Trainer`` and
    ``parallel.ShardedTrainer`` (whose step runs it in train mode
    whatever its mode). ``kwargs``: ``classes``, ``thumbnail``."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"invalid resnet depth {num_layers}; options "
                         f"{sorted(resnet_spec)}")
    if version not in (1, 2):
        raise MXNetError(f"invalid resnet version {version}; options [1, 2]")
    if pretrained:
        raise MXNetError("pretrained weights are not bundled (no model store "
                         "download in this build); use load_reference_params")
    dev = _device.resolve(device)
    block_type, layers, channels = resnet_spec[num_layers]
    resnet_class = resnet_net_versions[version - 1]
    block_class = resnet_block_versions[version - 1][block_type]
    with torch.device("meta"):
        model = resnet_class(block_class, layers, channels, **kwargs)
    model.to_empty(device=dev)
    _init_weights(model, dev)
    model.requires_grad_(trainable)
    return model.train(trainable)


def _reference_names(model):
    """{port state name: JAX ``collect_params()`` name}, and the JAX names
    the port does not read (the gamma of a ``scale=False`` BatchNorm)."""
    names, ignored = {}, set()
    for prefix, m in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(m, nn.BatchNorm):
            if m.weight is not None:
                names[pre + "weight"] = pre + "gamma"
            else:
                ignored.add(pre + "gamma")
            names[pre + "bias"] = pre + "beta"
            names[pre + "running_mean"] = pre + "running_mean"
            names[pre + "running_var"] = pre + "running_var"
        elif isinstance(m, (nn.Conv2D, nn.Dense)):
            names[pre + "weight"] = pre + "weight"
            if m.bias is not None:
                names[pre + "bias"] = pre + "bias"
    return names, ignored


def load_reference_params(model, params):
    """Copy the JAX model's ``collect_params()`` arrays (``{name: numpy
    array}``) into ``model``: BatchNorm ``gamma``/``beta`` become
    ``weight``/``bias``, every other name is kept. Raises
    :class:`MXNetError` on a missing, unused or wrongly shaped entry.
    Returns ``model``."""
    names, ignored = _reference_names(model)
    state = model.state_dict(keep_vars=True)
    missing = sorted(j for j in names.values() if j not in params)
    unused = sorted(set(params) - set(names.values()) - ignored)
    if missing or unused or set(names) != set(state):
        raise MXNetError(f"load_reference_params: missing {missing}, unused "
                         f"{unused}")
    with torch.no_grad():
        for port_name, jax_name in names.items():
            t = state[port_name]
            arr = _onp.asarray(params[jax_name])
            if tuple(arr.shape) != tuple(t.shape):
                raise MXNetError(
                    f"load_reference_params: {jax_name} has shape "
                    f"{tuple(arr.shape)}, the model wants {tuple(t.shape)}")
            t.copy_(torch.tensor(arr))
    return model


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
